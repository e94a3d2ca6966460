"""Sharded rendering and training over the (tile, sample) mesh.

Sharding layout (the multi-device answer to the reference's chunked GPU
dispatch, render.h:128-139, and the new distributed-training capability):

  * Scene arrays, shade table, camera — REPLICATED on every device (the
    analog of GLSL uniform state, shader.h:76-79).
  * Film rows — sharded over the ``tile`` axis: each device traces its own
    horizontal band of the image.
  * Samples — sharded over the ``sample`` axis: each device traces a
    disjoint set of global sample indices (the per-(pixel,sample) RNG
    streams of rng.sample_seed make these independent by construction),
    and the band's partial film is ``psum``-reduced.
  * Material gradients — computed per shard and ``psum``-reduced over BOTH
    axes inside the sharded region, so the optimizer update is replicated.

Everything is expressed with ``shard_map`` over a ``Mesh``; XLA inserts the
collectives and overlaps them with compute where possible.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
try:
    from jax import shard_map  # jax >= 0.7
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import policy
from .. import rng as prng
from ..camera import Camera, get_rays
from ..image import Film
from ..ops import intersect as isect
from ..ops import trace as trace_ops
from ..scene import Scene
from .mesh import SAMPLE_AXIS, TILE_AXIS

def _trace_band(camera: Camera, scene: Scene, table, h0, width, band_h,
                spp, sample0, depth, seed):
    """Trace a (band_h x width) pixel band for ``spp`` samples starting at
    global sample index ``sample0``; returns the radiance SUM."""
    w = jax.lax.broadcasted_iota(jnp.int32, (band_h, width), 1)
    h = jax.lax.broadcasted_iota(jnp.int32, (band_h, width), 0) + h0

    def intersect(o, d):
        return isect.intersect_brute(o, d, scene.v1, scene.v2, scene.v3)

    def one_sample(acc, k):
        sidx = sample0 + k
        state = prng.sample_seed(w, h, camera.res[1], sidx, seed)
        state, u1 = prng.rand01(state)
        state, u2 = prng.rand01(state)
        ray_o, ray_d = get_rays(camera, w, h, u1, u2)
        rad = trace_ops.trace_rays(table, intersect, ray_o, ray_d, depth,
                                   state, has_specular=scene.has_specular)
        return acc + rad, None

    acc0 = jnp.zeros((band_h, width, 3), jnp.float32)
    acc, _ = jax.lax.scan(one_sample, acc0,
                          jnp.arange(spp, dtype=jnp.int32))
    return acc


def render_film_sharded(
    mesh: Mesh,
    camera: Camera,
    scene: Scene,
    samples: int,
    depth: int = 5,
    *,
    seed: int = prng.SEED,
) -> Film:
    """Distributed render: rows over ``tile``, samples over ``sample``.

    Requires height % n_tile == 0 and samples % n_sample == 0."""
    width, height = camera.res
    n_tile = mesh.shape[TILE_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    if height % n_tile or samples % n_sample:
        raise ValueError(
            f"height {height} % tile {n_tile} or samples {samples} % "
            f"sample {n_sample} != 0")
    band_h = height // n_tile
    spp_local = samples // n_sample

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P()),            # camera, scene replicated
        out_specs=P(TILE_AXIS, None, None),
        check_vma=False,
    )
    def run(camera, scene):
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SAMPLE_AXIS)
        table = trace_ops.shade_table(scene)
        acc = _trace_band(camera, scene, table, ti * band_h, width, band_h,
                          spp_local, si * spp_local, depth, seed)
        acc = jax.lax.psum(acc, SAMPLE_AXIS)
        return acc

    film = run(camera, scene) / jnp.float32(samples)
    return Film((width, height), data=jax.device_get(film))


def render_film_sharded_pallas(
    mesh: Mesh,
    camera: Camera,
    scene: Scene,
    samples: int,
    depth: int = 5,
    *,
    seed: int = prng.SEED,
    interpret: bool,
) -> Film:
    """Distributed render through the megakernel with pixel-band sharding:
    each device of the ``tile`` axis launches the kernel on its own
    horizontal film BAND (the kernel's h0 row offset makes band rows
    bit-identical to the same rows of a full-film launch — the analog of
    the reference's fragment-grid pixel partition, render.h:128-139), and
    each device of the ``sample`` axis traces a disjoint global-sample
    window of that band.  The psum runs over the ``sample`` axis ONLY and
    the film stays sharded over ``tile``, so per-device film memory and
    psum payload scale with the BAND, not the full film.

    Falls back to pure sample-parallelism (all devices flatten into
    sample windows, full-film psum) when the film height does not divide
    over the tile axis.  ``interpret=True`` runs the kernel in the Pallas
    interpreter (CPU meshes); otherwise the mesh must hold GPUs."""
    from ..ops.pallas import trace_kernel as tk

    policy.check_kernel_platform(interpret, list(mesh.devices.flat))
    width, height = camera.res
    n_dev = mesh.devices.size
    n_tile = mesh.shape[TILE_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    banded = height % n_tile == 0 and samples % n_sample == 0
    if banded:
        band_h = height // n_tile
        spp_local = samples // n_sample
    else:
        if samples % n_dev:
            raise ValueError(
                f"samples {samples} % devices {n_dev} != 0")
        band_h = height
        spp_local = samples // n_dev

    # Host-side packing happens ONCE here; only the per-device band and
    # sample-window offsets are traced.
    packed = tk.PackedScene(camera, scene)
    mix = tk._seed_mix(seed)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P()),       # packed scene replicated
        out_specs=(P(TILE_AXIS, None, None) if banded else P()),
        check_vma=False,
    )
    def run(cam_params, tri_params, table):
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SAMPLE_AXIS)
        if banded:
            sample0 = si * spp_local
            h0 = ti * band_h
        else:
            sample0 = (ti * n_sample + si) * spp_local
            h0 = 0
        iparams = jnp.stack([
            jnp.asarray(sample0, jnp.int32), jnp.int32(mix),
            jnp.int32(height), jnp.asarray(h0, jnp.int32),
            jnp.int32(spp_local)])
        film_sum = tk._launch(
            iparams, cam_params, tri_params, table, width=width,
            band_h=band_h, n_tris=packed.n_tris, depth=depth,
            has_specular=packed.has_specular,
            block=tk.DEFAULT_BLOCK, num_warps=tk.DEFAULT_NUM_WARPS,
            interpret=interpret)
        return jax.lax.psum(
            film_sum,
            SAMPLE_AXIS if banded else (TILE_AXIS, SAMPLE_AXIS))

    film = run(packed.cam, packed.tri, packed.table) / jnp.float32(samples)
    return Film((width, height), data=jax.device_get(film))


def make_sharded_train_step(
    mesh: Mesh,
    camera: Camera,
    scene: Scene,
    target: jnp.ndarray,
    samples: int,
    depth: int = 5,
    *,
    seed: int = prng.SEED,
    optimizer=None,
    param_transform=None,
):
    """Build a jitted sharded inverse-rendering train step.

    The loss is MSE between the distributed linear film and ``target``.
    Returns ``step(params, opt_state, step_idx) -> (params, opt_state,
    loss)`` where params/opt_state are replicated pytrees of the
    *unconstrained* parameters (see inverse.py transforms); gradients are
    psum-reduced over the whole mesh inside the sharded region.
    """
    import optax

    if optimizer is None:
        optimizer = optax.adam(2e-2)
    if param_transform is None:
        param_transform = lambda p: p  # noqa: E731

    width, height = camera.res
    n_tile = mesh.shape[TILE_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    band_h = height // n_tile
    spp_local = samples // n_sample
    n_dev = n_tile * n_sample

    def local_loss(params, target_band, ti, si, step_idx):
        mats = param_transform(params)
        sc = scene.replace_materials(**mats)
        table = trace_ops.shade_table(sc)
        # rotate sample indices per optimizer step for fresh noise
        sample0 = si * spp_local + step_idx * samples
        acc = _trace_band(camera, sc, table, ti * band_h, width, band_h,
                          spp_local, sample0, depth, seed)
        film_band = acc / jnp.float32(spp_local)
        # Per-band MSE; averaged over the mesh below.
        return jnp.mean((film_band - target_band) ** 2)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(TILE_AXIS, None, None), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def loss_and_grad(params, target_shard, step_idx):
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SAMPLE_AXIS)
        loss, g = jax.value_and_grad(local_loss)(
            params, target_shard, ti, si, step_idx)
        # Average over every shard: bands partition pixels; sample shards
        # are independent estimates of the same band loss/grad.
        loss = jax.lax.pmean(loss, (TILE_AXIS, SAMPLE_AXIS))
        g = jax.lax.pmean(g, (TILE_AXIS, SAMPLE_AXIS))
        return loss, g

    target_sharded = jax.device_put(
        target, NamedSharding(mesh, P(TILE_AXIS, None, None)))

    @jax.jit
    def step(params, opt_state, step_idx):
        loss, g = loss_and_grad(params, target_sharded, step_idx)
        updates, opt_state = optimizer.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init(params):
        return optimizer.init(params)

    return step, init
