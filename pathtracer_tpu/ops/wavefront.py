"""Wavefront path tracing: staged bounce pipeline over SoA ray queues.

The reference megakernel gives every pixel a private thread for its whole
path (shader.h:219-259); lanes idle once paths die.  The classic CUDA
wavefront answer is stream compaction between bounces.  This module maps
each wavefront stage onto XLA:

  stage                 CUDA wavefront              this module
  -------------------   -------------------------   -------------------------
  ray-gen               kernel over pixel queue     ``raygen`` (fused XLA)
  traverse/intersect    persistent-threads kernel   backend intersect
                                                    (dense or BVH)
  shade/scatter         kernel + film atomics       ``bounce_stage`` +
                                                    ``segment_sum`` by pixel
                                                    (race-free, SURVEY §5)
  compact               global stream compaction    PARKING: dead rays move
                                                    to a guaranteed-miss
                                                    pose, so their BVH
                                                    traversal ends at the
                                                    root box

Control flow is fully jit-resident: ONE ``lax.scan`` over sample blocks
wraps a ``lax.scan`` over bounces, and each bounce body sits behind a
``lax.cond`` on "any ray alive" — once a block's queue is empty the
remaining bounces cost one predicate each instead of an intersect pass.
An explicit argsort-partition ``compact`` is kept for the tests and as
the reference point the parking design replaced.

The whole render is a single device dispatch: the host loop of
render.py's tile driver disappears.  The module is capability parity with
the reference's chunked-dispatch mode and the race-free scatter pattern
(SURVEY §5); the ``auto`` policy never selects it.  Its speed on the GPU
is not measured.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .. import materials as mat
from .. import policy
from ..linalg import SHIFT_BIAS, dot
from ..scene import Scene
from . import intersect as isect
from .trace import (_ALBEDO, _EMIT, _IS_EMIT, _IS_SPEC, _NORMAL, _ROUGH,
                    gather_features, park_pose, shade_table)


def raygen(camera, w, h, state):
    """Stage 1: camera rays for pixel coords (R,) with jitter from the
    per-ray streams. Returns (ray_o, ray_d, state)."""
    from .. import rng as prng
    from ..camera import get_rays

    state, u1 = prng.rand01(state)
    state, u2 = prng.rand01(state)
    ray_o, ray_d = get_rays(camera, w, h, u1, u2)
    return ray_o, ray_d, state


def bounce_stage(table, intersect_fn, queue, has_specular: bool,
                 park=None):
    """One wavefront bounce: intersect + shade/scatter + continuation.

    queue: dict with ray_o, ray_d (R,3); thr (R,3); pix (R,) int32;
    state (R,) uint32; alive (R,) bool.
    Returns (radiance_contrib (R,3), new_queue).  The contribution is the
    per-ray ``throughput * emit`` of this bounce (zero for dead/missed).
    ``park``: optional ((3,), (3,)) miss pose for dead rays (see module
    docstring).
    """
    ray_o, ray_d = queue["ray_o"], queue["ray_d"]
    t, tid = intersect_fn(ray_o, ray_d)
    hit = (tid >= 0) & queue["alive"]

    feat = gather_features(table, jnp.where(hit, tid, -1))
    albedo = feat[..., _ALBEDO]
    emit = feat[..., _EMIT]
    rough = feat[..., _ROUGH]
    n_geo = feat[..., _NORMAL]
    is_emit = feat[..., _IS_EMIT] > 0.5
    is_spec = feat[..., _IS_SPEC] > 0.5

    contrib = jnp.where(hit[..., None], queue["thr"] * emit, 0.0)
    cont = hit & ~is_emit

    n = jnp.where(dot(n_geo, ray_d)[..., None] < 0.0, n_geo, -n_geo)
    state, (u, v, cube) = mat.draw_bounce_uniforms(queue["state"],
                                                   has_specular)
    diff_d = mat.hemisphere_sample(u, v, n)
    if has_specular:
        spec_d = mat.specular_sample(ray_d, n, rough, cube)
        new_d = jnp.where(is_spec[..., None], spec_d, diff_d)
    else:
        new_d = diff_d

    cos = dot(n, new_d)
    contm = cont[..., None]
    thr = queue["thr"] * jnp.where(contm, 2.0 * albedo * cos[..., None], 1.0)
    hit_p = ray_o + ray_d * t[..., None]

    if park is not None:
        dead_o = jnp.broadcast_to(jnp.asarray(park[0], jnp.float32),
                                  ray_o.shape)
        dead_d = jnp.broadcast_to(jnp.asarray(park[1], jnp.float32),
                                  ray_o.shape)
    else:
        dead_o, dead_d = ray_o, ray_d

    new_queue = {
        "ray_o": jnp.where(contm, hit_p + n * SHIFT_BIAS, dead_o),
        "ray_d": jnp.where(contm, new_d, dead_d),
        "thr": thr,
        "pix": queue["pix"],
        "state": state,
        "alive": cont,
    }
    return contrib, new_queue


def compact(queue):
    """Stable-partition live rays to the front (prefix-sum scatter, no
    atomics).  Kept as the explicit-compaction reference point; the
    production pipeline uses parking instead (module docstring)."""
    order = jnp.argsort(~queue["alive"], stable=True)
    return {k: v[order] for k, v in queue.items()}


def _make_intersect(scene: Scene, backend: str, accel):
    if backend in ("bvh", "bvh-gather"):
        fn = (isect.intersect_bvh if backend == "bvh-gather"
              else isect.intersect_bvh_packet)
        max_leaf, stack_size = accel.max_leaf, accel.stack_size()

        def intersect_fn(o, d):
            return fn(o, d, accel, scene.v1, scene.v2, scene.v3,
                      max_leaf=max_leaf, stack_size=stack_size)
    else:
        def intersect_fn(o, d):
            return isect.intersect_brute(o, d, scene.v1, scene.v2,
                                         scene.v3)
    return intersect_fn


def render_wavefront(
    camera,
    scene: Scene,
    samples: int,
    depth: int = 5,
    *,
    bvh=None,
    seed: int = 1,
    backend: str = "auto",
    spp_per_block: Optional[int] = None,
    compact_every: int = 0,
):
    """Full wavefront render to a linear film (H, W, 3).

    One queue entry per (pixel, sample-in-block); ``lax.scan`` over sample
    blocks, ``lax.scan`` over bounces, ``lax.cond`` early-exit per bounce.
    RNG streams are the standard per-(pixel, sample) ones, so the result
    numerically matches ``render.render_film`` at equal seed/spp up to
    float32 reassociation (film accumulation order differs: per-bounce
    ``segment_sum`` over a block scan here vs per-tile sample sums there).

    backend: 'auto' (policy.py, with the XLA dense path standing in for
    the megakernel on small scenes), or explicit 'brute' | 'bvh' |
    'bvh-gather'.
    compact_every: if > 0, run the explicit argsort ``compact`` every k
    bounces INSTEAD of parking (measurement/reference mode).
    """
    from .. import rng as prng
    from ..bvh import build_bvh

    width, height = camera.res
    npix = width * height

    # the stages are XLA, so resolve as the differentiable callers do (no
    # megakernel)
    backend = policy.resolve(backend, scene, differentiable=True)
    accel = bvh
    park = None
    if backend in ("bvh", "bvh-gather"):
        if accel is None:
            accel = build_bvh(scene)
        if not compact_every:
            park = park_pose(scene)

    intersect_fn = _make_intersect(scene, backend, accel)
    table = shade_table(scene)

    if spp_per_block is None:
        # ~2M rays per block, floor 1 spp.
        spp_per_block = max(1, min(samples, (1 << 21) // npix))
    while samples % spp_per_block:
        spp_per_block -= 1
    n_blocks = samples // spp_per_block
    R = npix * spp_per_block

    pix = jnp.tile(jnp.arange(npix, dtype=jnp.int32), spp_per_block)
    w = pix % width
    h = pix // width
    s_in_block = jnp.repeat(jnp.arange(spp_per_block, dtype=jnp.int32),
                            npix)

    def one_block(film, b):
        sidx = b * spp_per_block + s_in_block
        state = prng.sample_seed(w, h, height, sidx, seed)
        ray_o, ray_d, state = raygen(camera, w, h, state)
        queue = {
            "ray_o": ray_o, "ray_d": ray_d,
            "thr": jnp.ones((R, 3), jnp.float32),
            "pix": pix, "state": state,
            "alive": jnp.ones((R,), bool),
        }

        def one_bounce(carry, k):
            film, queue = carry

            def live(args):
                film, queue = args
                contrib, queue = bounce_stage(
                    table, intersect_fn, queue, scene.has_specular,
                    park=park)
                film = film + jax.ops.segment_sum(
                    contrib, queue["pix"], num_segments=npix)
                if compact_every:
                    queue = jax.lax.cond(
                        (k + 1) % compact_every == 0, compact,
                        lambda q: q, queue)
                return film, queue

            film, queue = jax.lax.cond(
                jnp.any(queue["alive"]), live, lambda a: a, (film, queue))
            return (film, queue), None

        (film, _), _ = jax.lax.scan(
            one_bounce, (film, queue),
            jnp.arange(depth, dtype=jnp.int32))
        return film, None

    @jax.jit
    def run():
        film0 = jnp.zeros((npix, 3), jnp.float32)
        film, _ = jax.lax.scan(one_block, film0,
                               jnp.arange(n_blocks, dtype=jnp.int32))
        return film / jnp.float32(samples)

    return run().reshape(height, width, 3)
