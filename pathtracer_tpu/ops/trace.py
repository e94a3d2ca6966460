"""The bounce loop: rendering-equation core (render.h:36-61 / shader.h:219-259).

The reference CPU tracer is recursive and the GLSL tracer is a forward loop
plus a backward fold over a per-bounce stack.  Both compute, per path,

    L = emit_0 + 2*c0*cos0 * (emit_1 + 2*c1*cos1 * (...))

The form used here is the algebraically-identical *forward
accumulation*: carry a throughput multiplier and add ``throughput * emit`` at
every hit, multiplying ``throughput *= 2 * albedo * cos`` on every continuing
bounce.  This needs no stack, is a fixed-length ``lax.scan`` over the depth,
and is exactly what autodiff wants for the differentiable path (the product
chain is linear in each material parameter).

Termination semantics match the reference exactly:
  * miss           -> contribute 0, path dies          (render.h:41)
  * hit EMIT       -> contribute throughput*emit, dies (render.h:44-46)
  * hit otherwise  -> add throughput*emit (normally 0), bounce with the
                      2*albedo*cos weight (render.h:54-60); the same weight
                      is applied to SPECULAR bounces, inherited behaviour.
  * next origin    -> hit_p + normal * SHIFT_BIAS      (render.h:16,52)

Dead rays are masked, not compacted (the GPU reference wastes the same
work in its in-shader loop).  Wavefront compaction for deep paths lives in
``ops/wavefront.py``.

Per-triangle shading constants (albedo, emission, roughness, geometric
normal, type flags) are folded into ONE (T, 12) table, gathered per ray by
hit triangle id.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax.numpy as jnp
from jax import lax

from .. import materials as mat
from ..linalg import FLOAT_INF, SHIFT_BIAS, cross, dot, normalize
from ..scene import Scene

# Shade-table column layout.
_ALBEDO = slice(0, 3)
_EMIT = slice(3, 6)
_ROUGH = 6
_NORMAL = slice(7, 10)
_IS_EMIT = 10
_IS_SPEC = 11
TABLE_COLS = 12


def shade_table(scene: Scene) -> jnp.ndarray:
    """Build the (T, 12) per-triangle shading-constant table.

    Geometric normals are precomputed per triangle (triangle.h:45-49 computes
    them per hit; they are ray-independent up to the double-sided flip, which
    stays per-ray in the loop)."""
    e1 = scene.v2 - scene.v1
    e2 = scene.v3 - scene.v1
    n = cross(e1, e2)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.where(norm > 0, norm, 1.0)  # padding tris have zero normals
    return jnp.concatenate(
        [
            scene.albedo,
            scene.emit,
            scene.roughness[:, None],
            n,
            (scene.mat_type == mat.EMIT)[:, None].astype(jnp.float32),
            (scene.mat_type == mat.SPECULAR)[:, None].astype(jnp.float32),
        ],
        axis=-1,
    )


def gather_features(table: jnp.ndarray, tid: jnp.ndarray) -> jnp.ndarray:
    """Gather of shade-table rows: (...,) ids -> (..., 12).

    tid may be -1 (miss); those rows come back all-zero, which downstream
    masking ignores anyway.  A plain gather in float32 for every table
    size (a one-hot matmul could run in reduced precision on a GPU's tensor
    cores).  Its gradient is a scatter-add into the table, whose summation
    order on a GPU may change from run to run.
    """
    feat = jnp.take(table, jnp.maximum(tid, 0), axis=0)
    return jnp.where((tid >= 0)[..., None], feat, 0.0)


IntersectFn = Callable[[jnp.ndarray, jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]]


def park_pose(scene: Scene):
    """Guaranteed-miss pose for dead rays: beyond the scene AABB's +corner,
    pointing +x away from it.  The offset is extent-relative (not a fixed
    +1.0) so it survives float32 rounding for scenes with large
    coordinates (a +1.0 at coordinates ~2^24 rounds away and the parked
    origin would land ON the AABB face)."""
    import numpy as np

    v1h, v2h, v3h = scene.host_verts()
    hi = np.maximum(np.maximum(v1h, v2h), v3h).max(0)
    lo = np.minimum(np.minimum(v1h, v2h), v3h).min(0)
    off = max(1.0, 1e-3 * float((hi - lo).max()))
    return (tuple(float(x) + off for x in hi), (1.0, 0.0, 0.0))


def trace_rays(
    table: jnp.ndarray,
    intersect: IntersectFn,
    ray_o: jnp.ndarray,
    ray_d: jnp.ndarray,
    depth: int,
    rng_state: jnp.ndarray,
    has_specular: bool = True,
    park_pose=None,
):
    """Trace a ray batch to radiance.

    table: (T, 12) from :func:`shade_table` (differentiable w.r.t. materials).
    intersect: (ray_o, ray_d) -> (t, tid).
    ray_o, ray_d: (..., 3); rng_state: (...,) uint32 per-ray hash streams.
    depth: static bounce budget.
    park_pose: optional ((3,), (3,)) guaranteed-miss (origin, direction).
      When given, DEAD rays are moved there instead of keeping their last
      pose, so a BVH traversal ends for them at the root box instead of
      re-walking the tree.  Radiance is identical either way (dead rays
      are masked); pass a pose outside the scene's AABB pointing away
      from it.
    Returns radiance (..., 3).
    """
    zeros3 = jnp.zeros_like(ray_o)
    if park_pose is not None:
        park_o = jnp.broadcast_to(jnp.asarray(park_pose[0], jnp.float32),
                                  ray_o.shape)
        park_d = jnp.broadcast_to(jnp.asarray(park_pose[1], jnp.float32),
                                  ray_o.shape)

    def body(carry, _):
        ray_o, ray_d, thr, rad, alive, rng = carry
        t, tid = intersect(ray_o, ray_d)
        hit = (tid >= 0) & alive
        hitm = hit[..., None]

        feat = gather_features(table, jnp.where(hit, tid, -1))
        albedo = feat[..., _ALBEDO]
        emit = feat[..., _EMIT]
        rough = feat[..., _ROUGH]
        n_geo = feat[..., _NORMAL]
        is_emit = feat[..., _IS_EMIT] > 0.5
        is_spec = feat[..., _IS_SPEC] > 0.5

        rad = rad + jnp.where(hitm, thr * emit, 0.0)

        cont = hit & ~is_emit
        contm = cont[..., None]

        # Double-sided normal flip toward the incoming ray (triangle.h:48).
        n = jnp.where(dot(n_geo, ray_d)[..., None] < 0.0, n_geo, -n_geo)

        rng, (u, v, cube) = mat.draw_bounce_uniforms(rng, has_specular)
        diff_d = mat.hemisphere_sample(u, v, n)
        if has_specular:
            spec_d = mat.specular_sample(ray_d, n, rough, cube)
            new_d = jnp.where(is_spec[..., None], spec_d, diff_d)
        else:
            new_d = diff_d

        cos = dot(n, new_d)
        thr = thr * jnp.where(contm, 2.0 * albedo * cos[..., None], 1.0)

        hit_p = ray_o + ray_d * t[..., None]
        if park_pose is not None:
            ray_o = jnp.where(contm, hit_p + n * SHIFT_BIAS, park_o)
            ray_d = jnp.where(contm, new_d, park_d)
        else:
            ray_o = jnp.where(contm, hit_p + n * SHIFT_BIAS, ray_o)
            ray_d = jnp.where(contm, new_d, ray_d)
        return (ray_o, ray_d, thr, rad, cont, rng), None

    init = (
        ray_o,
        ray_d,
        jnp.ones_like(ray_o),
        zeros3,
        jnp.ones(ray_o.shape[:-1], bool),
        rng_state,
    )
    (_, _, _, rad, _, _), _ = lax.scan(body, init, None, length=depth)
    return rad
