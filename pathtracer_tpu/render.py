"""Render drivers (L4), the analog of render.h:62-152.

The reference has three drivers — a single-threaded recursive CPU loop, a
chunked OpenGL dispatch, and an SFML realtime loop.  Here there are two:

  * the fused megakernel ('pallas', ops/pallas/trace_kernel.py): one GPU
    launch traces every pixel of the film for a window of samples, the
    analog of the reference's fragment-shader dispatch;
  * a jit-compiled XLA tile pass ('brute', 'bvh', 'bvh-gather'): all pixels
    of a row tile x a sample block, traced as one fused XLA program and
    dispatched in a host loop over row tiles and sample blocks (the analog
    of the reference's chunked dispatch, render.h:128-139).  The host loop
    bounds device memory (the dense rays x triangles intermediates of the
    brute-force intersector) and gives progress reporting; each pass is a
    ``lax.scan`` over sample blocks so dispatch overhead amortizes away.

``backend="auto"`` is resolved by policy.py from the device platform and
the scene size.

RNG discipline: one independent hash stream per (pixel, sample) pair
(rng.sample_seed), consumed jitter-first-then-bounces exactly like the GPU
megakernel (shader.h:273-294).  This makes the sample axis order-independent
and therefore shardable across devices.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import policy
from . import rng as prng
from .bvh import FlatBVH, build_bvh
from .camera import Camera, get_rays
from .image import Film
from .ops import intersect as isect
from .ops import trace as trace_ops
from .scene import Scene
from .utils.timer import Timer

TARGET_RAYS_PER_PASS = 1 << 21   # rays traced per jitted tile pass
TARGET_RAYS_PER_CALL = 1 << 24   # rays per host dispatch (scan of passes)

_STEP_CACHE = {}


def _tile_step(backend: str, tile_h: int, width: int, res_y: int, spp_b: int,
               n_blocks: int, depth: int, base_seed: int,
               max_leaf: int, stack_size: int, park=None):
    """Build (and cache) the jitted pass: trace ``n_blocks`` sample blocks of
    ``spp_b`` samples for a ``tile_h x width`` pixel tile, returning the tile's
    radiance SUM over those samples."""
    key = (backend, tile_h, width, res_y, spp_b, n_blocks, depth, base_seed,
           max_leaf, stack_size, park)
    if key in _STEP_CACHE:
        return _STEP_CACHE[key]

    def step(scene: Scene, table, cam: Camera, accel, h0, sidx0):
        w = jax.lax.broadcasted_iota(jnp.int32, (tile_h, width), 1)
        h = jax.lax.broadcasted_iota(jnp.int32, (tile_h, width), 0) + h0

        if backend in ("bvh", "bvh-gather"):
            # Packet traversal (one stack shared by a ray packet) or one
            # stack per ray (see the intersect.py docstrings).
            _bvh_fn = (isect.intersect_bvh if backend == "bvh-gather"
                       else isect.intersect_bvh_packet)

            def intersect(o, d):
                flat_o = o.reshape(-1, 3)
                flat_d = d.reshape(-1, 3)
                t, tid = _bvh_fn(
                    flat_o, flat_d, accel, scene.v1, scene.v2, scene.v3,
                    max_leaf=max_leaf, stack_size=stack_size)
                return t.reshape(o.shape[:-1]), tid.reshape(o.shape[:-1])
        else:
            def intersect(o, d):
                return isect.intersect_brute(
                    o, d, scene.v1, scene.v2, scene.v3)

        def one_block(acc, k):
            # Global sample indices for this block: (spp_b, 1, 1).
            sidx = (sidx0 + k * spp_b
                    + jax.lax.broadcasted_iota(jnp.int32, (spp_b, 1, 1), 0))
            state = prng.sample_seed(w[None], h[None], res_y, sidx, base_seed)
            state, u1 = prng.rand01(state)
            state, u2 = prng.rand01(state)
            ray_o, ray_d = get_rays(cam, w[None], h[None], u1, u2)
            rad = trace_ops.trace_rays(table, intersect, ray_o, ray_d,
                                       depth, state,
                                       has_specular=scene.has_specular,
                                       park_pose=park)
            return acc + jnp.sum(rad, axis=0), None

        acc0 = jnp.zeros((tile_h, width, 3), jnp.float32)
        acc, _ = jax.lax.scan(one_block, acc0,
                              jnp.arange(n_blocks, dtype=jnp.int32))
        return acc

    fn = jax.jit(step, static_argnames=())
    _STEP_CACHE[key] = fn
    return fn


def _plan(width: int, height: int, samples: int, n_tris: int):
    """Choose (tile_h, spp_b, blocks_per_call) to hit the ray-count targets.

    The dense intersector materializes O(rays * n_tris) floats transiently;
    scale the per-pass ray budget down for bigger scenes."""
    per_pass = max(1 << 16, TARGET_RAYS_PER_PASS // max(1, n_tris // 32))
    # No divisibility requirement: the driver handles a ragged last tile
    # (a divisor search could degrade to 1-row tiles for prime heights,
    # making the tile driver dispatch-bound).
    tile_h = max(1, min(height, per_pass // max(1, width)))
    spp_b = max(1, min(samples, per_pass // (tile_h * width)))
    blocks = max(1, min(samples // spp_b,
                        TARGET_RAYS_PER_CALL // (tile_h * width * spp_b)))
    return tile_h, spp_b, blocks


def _sample_schedule(samples: int, spp_b: int, blocks: int):
    """Deterministic sample-block schedule: [(sidx0, spp, n_blocks), ...]
    covering [0, samples).  Derived from the TOTAL sample count only, so a
    resumed render blocks (and therefore float-accumulates) identically to
    an uninterrupted one."""
    sched = []
    s = 0
    while s < samples:
        nb = min(blocks, (samples - s) // spp_b)
        if nb == 0:
            nb, this_spp = 1, samples - s
        else:
            this_spp = spp_b
        sched.append((s, this_spp, nb))
        s += this_spp * nb
    return sched


def render_film(camera: Camera, scene: Scene, samples: int, depth: int = 5,
                *, bvh: Optional[FlatBVH] = None, seed: int = prng.SEED,
                backend: str = "auto", interpret: bool = False,
                verbose: bool = False,
                checkpoint: Optional[str] = None,
                checkpoint_every: int = 1,
                _abort_after: Optional[int] = None) -> Film:
    """Render the sample-averaged LINEAR film (no gamma).

    The driver equivalent of the loop cores of render_cpu/render_gpu
    (render.h:80-88, 128-139), minus color correction and file output —
    see :func:`render` for the full pipeline.

    backend: "auto" (policy.py), "pallas" (the GPU megakernel), "brute",
    "bvh", "bvh-gather" or "wavefront".  ``interpret=True`` runs the
    megakernel in the Pallas interpreter (tests); without it, "pallas"
    needs a GPU.

    checkpoint: path to a .npz resume file.  If it exists, the render
    resumes at the recorded sample index and produces a film BIT-IDENTICAL
    to an uninterrupted run (the per-(pixel,sample) RNG streams and the
    deterministic sample schedule make partial sums exact prefixes); if it
    does not exist it is created and updated every ``checkpoint_every``
    completed sample blocks.  The reference loses everything on
    interruption (SURVEY.md section 5).
    ``_abort_after``: testing hook — abort (saving the checkpoint) after
    this many schedule entries.
    """
    if scene.num_tris == 0:
        raise ValueError("No triangles in scene.")
    if backend != "wavefront":
        backend = policy.resolve(backend, scene)
    if backend == "pallas" and checkpoint is None:
        from .ops.pallas import trace_kernel
        return trace_kernel.render_film_pallas(
            camera, scene, samples, depth, seed=seed, interpret=interpret,
            verbose=verbose)
    if backend == "pallas":
        # Block-boundary checkpointing: the megakernel renders sample
        # windows whose SUMS compose exactly (independent per-(pixel,
        # sample) RNG streams), so saving (film_sum, samples_done) between
        # windows gives bit-identical resume.
        return _render_pallas_checkpointed(
            camera, scene, samples, depth, seed=seed, checkpoint=checkpoint,
            checkpoint_every=checkpoint_every, interpret=interpret,
            verbose=verbose, _abort_after=_abort_after)
    if backend == "wavefront":
        if checkpoint is not None:
            raise ValueError(
                "backend='wavefront' does not support checkpointing (the "
                "whole render is one device dispatch with no host-visible "
                "sample boundary to save at); use backend='pallas' or the "
                "XLA tile backends for resumable renders")
        from .ops import wavefront
        film = wavefront.render_wavefront(
            camera, scene, samples, depth, bvh=bvh, seed=seed)
        return Film(camera.res, data=film)
    accel = bvh
    max_leaf = stack_size = 0
    park = None
    if backend in ("bvh", "bvh-gather"):
        if accel is None:
            accel = build_bvh(scene)
        max_leaf = accel.max_leaf
        stack_size = accel.stack_size()
        # Park dead rays at a guaranteed-miss pose (see trace_rays): their
        # traversal then ends at the root box.
        park = trace_ops.park_pose(scene)

    width, height = camera.res
    tile_h, spp_b, blocks = _plan(width, height, samples, scene.padded_size)
    table = trace_ops.shade_table(scene)
    sched = _sample_schedule(samples, spp_b, blocks)

    meta = {"width": width, "height": height, "samples": samples,
            "depth": depth, "seed": seed, "backend": backend,
            "tile_h": tile_h, "spp_b": spp_b,
            "scene_sum": float(scene.host_verts()[0].sum()
                               + scene.host_materials()[1].sum())}
    samples_done = 0
    film = jnp.zeros((height, width, 3), jnp.float32)
    if checkpoint is not None:
        from .utils import checkpoint as ckpt
        import os
        cpath = checkpoint if checkpoint.endswith(".npz") \
            else checkpoint + ".npz"
        if os.path.exists(cpath):
            film_sum, samples_done, saved = ckpt.load_render_checkpoint(
                cpath)
            if saved != meta:
                raise ValueError(
                    f"checkpoint {cpath} was written by a different render "
                    f"config:\n  saved: {saved}\n  this:  {meta}")
            film = jnp.asarray(film_sum)
            if verbose:
                print(f"Resuming at sample {samples_done}/{samples}.")

    done = 0
    tiles_per_pass = -(-height // tile_h)
    total = len(sched) * tiles_per_pass
    for ei, (s0, this_spp, nb) in enumerate(sched):
        if s0 < samples_done:
            done += tiles_per_pass
            continue
        for h0 in range(0, height, tile_h):
            th = min(tile_h, height - h0)  # ragged last tile
            step = _tile_step(backend, th, width, height, this_spp, nb,
                              depth, seed, max_leaf, stack_size, park)
            acc = step(scene, table, camera, accel,
                       jnp.int32(h0), jnp.int32(s0))
            film = film.at[h0 : h0 + th].add(acc)
            done += 1
            if verbose:
                print(f"\rRendered: {done}/{total} passes.",
                      end="", flush=True)
        samples_done = s0 + this_spp * nb
        if checkpoint is not None and (
                ei % checkpoint_every == checkpoint_every - 1
                or samples_done >= samples):
            from .utils import checkpoint as ckpt
            ckpt.save_render_checkpoint(
                checkpoint, np.asarray(film), samples_done, meta)
        if _abort_after is not None and ei + 1 >= _abort_after:
            if checkpoint is not None:
                from .utils import checkpoint as ckpt
                ckpt.save_render_checkpoint(
                    checkpoint, np.asarray(film), samples_done, meta)
            raise KeyboardInterrupt(
                f"aborted after {ei + 1} schedule entries (test hook)")
    film = film / np.float32(samples)
    if verbose:
        print()
    return Film((width, height), data=film.block_until_ready())


def _render_pallas_checkpointed(camera: Camera, scene: Scene, samples: int,
                                depth: int, *, seed: int, checkpoint: str,
                                checkpoint_every: int = 1,
                                interpret: bool = False,
                                verbose: bool = False,
                                _abort_after: Optional[int] = None,
                                block_spp: Optional[int] = None) -> Film:
    """Resumable megakernel render: sample windows of ``block_spp``,
    film-sum checkpoint between windows (see render_film's checkpoint
    contract)."""
    import os

    from .ops.pallas import trace_kernel
    from .utils import checkpoint as ckpt

    width, height = camera.res
    if block_spp is None:
        block_spp = max(1, min(samples, trace_kernel.RAYS_PER_CALL
                               // (width * height)))
    meta = {"width": width, "height": height, "samples": samples,
            "depth": depth, "seed": seed, "backend": "pallas",
            "block_spp": block_spp,
            "scene_sum": float(scene.host_verts()[0].sum()
                               + scene.host_materials()[1].sum())}

    samples_done = 0
    film = jnp.zeros((height, width, 3), jnp.float32)
    cpath = checkpoint if checkpoint.endswith(".npz") else checkpoint + ".npz"
    if os.path.exists(cpath):
        film_sum, samples_done, saved = ckpt.load_render_checkpoint(cpath)
        if saved != meta:
            raise ValueError(
                f"checkpoint {cpath} was written by a different render "
                f"config:\n  saved: {saved}\n  this:  {meta}")
        film = jnp.asarray(film_sum)
        if verbose:
            print(f"Resuming at sample {samples_done}/{samples}.")

    blocks_done = 0
    while samples_done < samples:
        spp = min(block_spp, samples - samples_done)
        film = film + trace_kernel.render_sum_pallas(
            camera, scene, samples_done, spp, depth, seed=seed,
            spp_per_call=spp, interpret=interpret)
        samples_done += spp
        blocks_done += 1
        if (blocks_done % checkpoint_every == 0
                or samples_done >= samples):
            ckpt.save_render_checkpoint(
                checkpoint, np.asarray(film), samples_done, meta)
        if verbose:
            print(f"\rRendered: {samples_done}/{samples} spp.",
                  end="", flush=True)
        if _abort_after is not None and blocks_done >= _abort_after:
            ckpt.save_render_checkpoint(
                checkpoint, np.asarray(film), samples_done, meta)
            raise KeyboardInterrupt(
                f"aborted after {blocks_done} blocks (test hook)")
    if verbose:
        print()
    return Film((width, height), data=(film / np.float32(samples)))


def render_normals(camera: Camera, scene: Scene, *, seed: int = prng.SEED) -> Film:
    """Debug view: first-hit double-sided normals (the ``normal_shade``
    debug shader, shader.h:261-271).  One sample per pixel, center rays."""
    width, height = camera.res
    table = trace_ops.shade_table(scene)

    @jax.jit
    def run(scene, table, cam):
        w = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
        h = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
        half = jnp.full((height, width), 0.5, jnp.float32)
        ray_o, ray_d = get_rays(cam, w, h, half, half)
        t, tid = isect.intersect_brute(ray_o, ray_d, scene.v1, scene.v2,
                                       scene.v3)
        feat = trace_ops.gather_features(table, tid)
        n = feat[..., 7:10]
        flip = jnp.where(
            jnp.sum(n * ray_d, axis=-1, keepdims=True) < 0.0, 1.0, -1.0)
        return jnp.where((tid >= 0)[..., None], n * flip, 0.0)

    return Film((width, height), data=np.asarray(run(scene, table, camera)))


def render_debug_uv(res) -> Film:
    """The ``#define DEBUG`` UV-gradient test shader (shader.h:311-320):
    color = |uv| over [-1, 1]^2 — a pure pipeline smoke image."""
    width, height = int(res[0]), int(res[1])
    x = np.abs(np.linspace(-1, 1, width, dtype=np.float32))
    y = np.abs(np.linspace(-1, 1, height, dtype=np.float32))
    img = np.zeros((height, width, 3), np.float32)
    img[..., 0] = x[None, :]
    img[..., 1] = y[:, None]
    return Film((width, height), data=img)


def render(camera: Camera, scene: Scene, samples: int, depth: int = 5,
           filename: Optional[str] = None, *, bvh: Optional[FlatBVH] = None,
           seed: int = prng.SEED, backend: str = "auto", gamma: float = 2.2,
           checkpoint: Optional[str] = None, interpret: bool = False,
           verbose: bool = True) -> Film:
    """Full render pipeline (render_cpu/render_gpu analog, render.h:62-152):
    trace, average, gamma-correct at 2.2, optionally save a PNG.  Returns the
    gamma-corrected Film and prints wall-clock + throughput like the
    reference's Timer/progress output."""
    timer = Timer()
    film = render_film(camera, scene, samples, depth, bvh=bvh, seed=seed,
                       backend=backend, checkpoint=checkpoint,
                       interpret=interpret, verbose=verbose)
    seconds = timer.seconds()
    if verbose:
        w, h = camera.res
        rays = w * h * samples * depth
        print(f"Done in {seconds:.2f} seconds "
              f"({rays / max(seconds, 1e-9):.3e} rays/s).")
    film.gamma_correct(gamma)
    if filename:
        film.save_png(filename)
        if verbose:
            print(f"Saved to {filename}")
    return film
