"""Differentiable rendering: pixel gradients w.r.t. material parameters.

The reference has no differentiable path at all; this is the subsystem this
build adds (BASELINE.json north star: d pixel / d (albedo, emission,
roughness) verified against finite differences).

Estimator design — *detached sampling with reparameterized speculars*:

* The per-(pixel,sample) RNG streams are pure functions of integer state, so
  for a fixed seed the whole render is a deterministic, piecewise-smooth
  function of the material arrays.  Plain ``jax.grad`` through the forward
  accumulation (ops/trace.py) then yields exactly the standard estimator:

  - **albedo / emission**: the radiance is a polynomial in these via the
    throughput product chain — gradients are exact per-path.
  - **roughness**: enters through the specular jitter
    ``normalize(mirror + (u - 0.5) * roughness)`` (material.h:15-25), which
    is smooth in roughness for fixed uniforms — the reparameterization
    trick.  CAVEAT (measured, round 4): this pathwise derivative captures
    only the within-surface radiance variation; in Cornell-class scenes
    the roughness dependence is BOUNDARY-DOMINATED (which wall does the
    blurred reflection hit), so the pathwise gradient is ~200x smaller
    than the expected-loss slope and wrong-signed, and the naive score
    -function fix is invalid too (the cube support moves with roughness).
    The inverse optimizer therefore uses common-random-number SPSA for
    the roughness coordinates (inverse.py) — this estimator is kept for
    gradcheck parity of the smooth piece, not for roughness recovery.
  - geometry terms (hit ids, normals) are discrete/constant; visibility
    -boundary terms are ignored (standard for interior-lit scenes).

* Because finite differences of the *same* fixed-seed function see the same
  discontinuity structure, gradcheck holds without smoothing.

The sample mean is unbiased in the value and (away from boundaries) in the
gradient, so material gradients can be averaged over sample shards and
``psum``-reduced across devices (see ``parallel/``).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from . import policy
from . import rng as prng
from .camera import Camera, get_rays
from .ops import intersect as isect
from .ops import trace as trace_ops
from .scene import Scene

MaterialParams = Dict[str, jnp.ndarray]  # albedo (T,3), emit (T,3), roughness (T,)


def material_params(scene: Scene) -> MaterialParams:
    """Extract the differentiable material arrays from a scene."""
    return {
        "albedo": scene.albedo,
        "emit": scene.emit,
        "roughness": scene.roughness,
    }


def _make_intersect(scene: Scene, backend: str, accel):
    """Build an intersect closure for the differentiable path.

    Geometry is fixed in this subsystem, and radiance never uses ``t``
    continuously (it enters only through hit positions, which affect
    radiance via *discrete* hit ids and normals — visibility-boundary
    terms the estimator ignores by design, module docstring).  The BVH
    traversals are therefore wrapped with ``stop_gradient`` on the ray
    inputs: no tangents enter their ``while_loop`` internals, and they
    yield the same material-gradient estimator as the brute path.
    """
    if backend == "brute":
        def intersect(o, d):
            return isect.intersect_brute(o, d, scene.v1, scene.v2,
                                         scene.v3)
    elif backend in ("bvh", "bvh-gather"):
        fn = (isect.intersect_bvh if backend == "bvh-gather"
              else isect.intersect_bvh_packet)
        max_leaf, stack_size = accel.max_leaf, accel.stack_size()

        def intersect(o, d):
            o = jax.lax.stop_gradient(o)
            d = jax.lax.stop_gradient(d)
            flat_o = o.reshape(-1, 3)
            flat_d = d.reshape(-1, 3)
            t, tid = fn(flat_o, flat_d, accel, scene.v1, scene.v2,
                        scene.v3, max_leaf=max_leaf,
                        stack_size=stack_size)
            return (t.reshape(o.shape[:-1]), tid.reshape(o.shape[:-1]))
    else:
        raise ValueError(f"unknown diff backend {backend!r}")
    return intersect


def make_accel(scene: Scene, backend: str):
    """Host-side acceleration-structure build for ``render_film_diff``.

    Returns None for 'brute' and a FlatBVH for 'bvh'/'bvh-gather'.
    Geometry never carries gradients, so the structure is built once from
    the base scene and reused across optimizer steps."""
    if backend == "brute":
        return None
    if backend in ("bvh", "bvh-gather"):
        from .bvh import build_bvh
        return build_bvh(scene)
    raise ValueError(f"unknown diff backend {backend!r}")


def render_film_diff(
    camera: Camera,
    scene: Scene,
    params: MaterialParams,
    samples: int,
    depth: int = 5,
    *,
    seed: int = prng.SEED,
    sample_offset: int = 0,
    backend: str = "brute",
    accel=None,
) -> jnp.ndarray:
    """Differentiable linear film (H, W, 3) as a pure jittable function of
    ``params``.  Single fused pass (no host tiling) — use modest resolutions
    / spp, or shard with parallel.render_sharded_diff.

    ``sample_offset`` selects which global sample indices this pass traces,
    so several calls with disjoint offsets average to the full-spp film —
    the hook for sample-axis data parallelism.

    ``backend``: 'brute' (dense, small scenes), 'bvh'/'bvh-gather' (flat
    -BVH traversal) for OBJ-scale scenes, or 'auto' (policy.py); pass
    ``accel`` (from :func:`make_accel`) to amortize the host build across
    optimizer steps.
    """
    backend = policy.resolve(backend, scene, differentiable=True)
    if backend != "brute" and accel is None:
        accel = make_accel(scene, backend)
    intersect = _make_intersect(scene, backend, accel)
    scene = scene.replace_materials(**params)
    table = trace_ops.shade_table(scene)
    width, height = camera.res

    w = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
    h = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
    sidx = (sample_offset
            + jax.lax.broadcasted_iota(jnp.int32, (samples, 1, 1), 0))
    state = prng.sample_seed(w[None], h[None], height, sidx, seed)
    state, u1 = prng.rand01(state)
    state, u2 = prng.rand01(state)
    ray_o, ray_d = get_rays(camera, w[None], h[None], u1, u2)
    rad = trace_ops.trace_rays(table, intersect, ray_o, ray_d, depth, state,
                               has_specular=scene.has_specular)
    return jnp.mean(rad, axis=0)


def make_loss(
    camera: Camera,
    scene: Scene,
    target: jnp.ndarray,
    samples: int,
    depth: int = 5,
    *,
    seed: int = prng.SEED,
    backend: str = "brute",
):
    """MSE-vs-target loss over the linear film, as a function of params.

    ``sample_offset`` is exposed as an argument so the optimizer can rotate
    sample indices per step (fresh noise each step, SPSA-free)."""
    backend = policy.resolve(backend, scene, differentiable=True)
    accel = make_accel(scene, backend)

    def loss(params: MaterialParams, sample_offset=0):
        film = render_film_diff(camera, scene, params, samples, depth,
                                seed=seed, sample_offset=sample_offset,
                                backend=backend, accel=accel)
        return jnp.mean((film - target) ** 2)

    return loss


def gradcheck(
    f,
    params: MaterialParams,
    *,
    eps: float = 1e-3,
    indices: Optional[list] = None,
    mode: str = "central",
):
    """Compare jax.grad(f) against finite differences.

    Returns (max_abs_err, max_rel_err) over the probed coordinates.
    ``indices``: list of (key, flat_index) pairs; default probes every
    coordinate of every parameter array.

    ``mode``:
      * ``"central"`` — standard central differences.  Correct when the loss
        is smooth in a ±eps neighborhood of the base point.
      * ``"one_sided"`` — forward AND backward differences, score each
        coordinate by whichever side matches better.  The fixed-seed render
        is only *piecewise* smooth in roughness (the specular rejection
        loop's accept/reject decisions flip at isolated parameter values,
        material.h:19-24 semantics); when the base point sits next to such a
        flip, one side of the FD stencil crosses the jump while the other
        measures the true local slope.  The detached/reparameterized
        estimator is exact for the smooth piece the base point lies on, so
        matching the clean side is the correct acceptance test.
    """
    import numpy as np

    g = jax.grad(f)(params)
    if indices is None:
        indices = [(k, i) for k in params for i in range(params[k].size)]

    def eval_at(key, i, delta):
        flat = np.asarray(params[key], np.float64).ravel().copy()
        flat[i] += delta
        p = {**params, key: jnp.asarray(
            flat.reshape(params[key].shape), jnp.float32)}
        return float(f(p))

    max_abs = 0.0
    max_rel = 0.0
    for key, i in indices:
        up = eval_at(key, i, eps)
        dn = eval_at(key, i, -eps)
        an = float(np.asarray(g[key]).ravel()[i])
        if mode == "central":
            fds = [(up - dn) / (2 * eps)]
        else:
            mid = eval_at(key, i, 0.0)
            fds = [(up - mid) / eps, (mid - dn) / eps]
        err = min(abs(fd - an) for fd in fds)
        fd_best = min(fds, key=lambda fd: abs(fd - an))
        max_abs = max(max_abs, err)
        denom = max(abs(fd_best), abs(an), 1e-6)
        max_rel = max(max_rel, err / denom)
    return max_abs, max_rel
