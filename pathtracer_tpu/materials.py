"""Materials and BRDF sampling (L2), port of ``/root/reference/pathtracer/material.h``.

Material model (material.h:27-39): ``type`` in {EMIT=1, DIFFUSE=2, SPECULAR=3},
an albedo ``color``, an ``emit_color`` and a ``roughness``.  Here
materials live in per-triangle SoA arrays (see ``scene.Scene``) and the
samplers below are batched over rays.

Sampler math (must match the reference for statistical parity):

* ``hemisphere_sample`` (material.h:6-14): uniform hemisphere via
  theta = acos(2u-1) - pi/2, phi = 2*pi*v, flipped to the normal side.
* ``specular_sample`` (material.h:15-25): mirror reflection plus a uniform
  cube jitter ``(u-0.5)*roughness`` rejection-sampled until above the
  surface.  The reference uses an unbounded do/while; data-dependent loops
  don't vectorize, so we draw a *fixed* number of candidates per ray and
  take the first acceptable one (falling back to the pure mirror direction
  in the astronomically-rare case where all candidates fail).  The rejection
  probability per try is < 0.5 even at grazing incidence, so K=8 tries make
  the fallback probability < 0.4%, and the estimator stays unbiased in the
  accepted region.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import rng as prng
from .linalg import dot, dot_keepdims, normalize

EMIT = 1
DIFFUSE = 2
SPECULAR = 3

SPECULAR_TRIES = 8  # fixed-iteration replacement for the rejection loop


def hemisphere_sample(u, v, normal):
    """Uniform hemisphere sample about ``normal`` (material.h:6-14).

    u, v: uniforms shaped (...,); normal: (..., 3). Returns (..., 3).

    The reference computes theta = acos(2u-1) - pi/2 and then
    (cos(theta)cos(phi), cos(theta)sin(phi), sin(theta)).  Using
    cos(acos(x) - pi/2) = sqrt(1-x^2) and sin(acos(x) - pi/2) = -x this
    reduces to (sqrt(1-x^2)cos(phi), sqrt(1-x^2)sin(phi), 1-2u) with
    x = 2u-1 — the same distribution without the acos/cos(theta)
    transcendentals (they matter: this runs per bounce per ray).
    """
    x = 2.0 * u - 1.0
    ct = jnp.sqrt(jnp.maximum(1.0 - x * x, 0.0))
    phi = jnp.float32(2.0 * jnp.pi) * v
    sample = jnp.stack(
        [ct * jnp.cos(phi), ct * jnp.sin(phi), -x], axis=-1
    )
    flip = jnp.where(dot_keepdims(sample, normal) < 0.0, -1.0, 1.0)
    return sample * flip


def specular_sample(ray_d, normal, roughness, cube_u):
    """Jittered mirror reflection (material.h:15-25), vectorized.

    ray_d, normal: (..., 3);  roughness: (...,) or (..., 1);
    cube_u: (K, ..., 3) uniforms for K fixed rejection tries.
    Returns a unit direction (..., 3).
    """
    roughness = jnp.asarray(roughness)
    if roughness.ndim == ray_d.ndim - 1:
        roughness = roughness[..., None]
    reflected = ray_d - normal * (2.0 * dot_keepdims(ray_d, normal))

    K = cube_u.shape[0]
    # Walk candidates from last to first so the FIRST acceptable candidate
    # wins, mirroring the do/while order of the reference.
    chosen = reflected  # fallback: pure mirror direction
    for k in range(K - 1, -1, -1):
        cand = reflected + (cube_u[k] - 0.5) * roughness
        ok = dot_keepdims(cand, normal) >= 0.0
        chosen = jnp.where(ok, cand, chosen)
    return normalize(chosen)


def draw_bounce_uniforms(state, has_specular: bool = True):
    """Advance the per-ray hash RNG by one bounce's worth of uniforms.

    Every bounce consumes a FIXED number of draws so the stream layout is
    static (XLA-friendly) and sample batches are reproducible: 2 for the
    diffuse (u, v) + 3*SPECULAR_TRIES for the specular cube jitters.  When
    the scene statically contains no SPECULAR materials the jitter draws are
    skipped entirely (a real win: that's 24 hash evaluations per bounce per
    ray).  Returns (state, (u, v, cube)); cube is None without speculars.
    """
    state, u = prng.rand01(state)
    state, v = prng.rand01(state)
    if not has_specular:
        return state, (u, v, None)
    state, flat = prng.randn01(state, 3 * SPECULAR_TRIES)
    cube = jnp.moveaxis(
        flat.reshape((SPECULAR_TRIES, 3) + flat.shape[1:]), 1, -1
    )
    return state, (u, v, cube)


def sample_direction(mat_type, roughness, ray_d, normal, u, v, cube_u):
    """Material-dispatched bounce direction (material.h:40-51).

    DIFFUSE (and unknown types) -> hemisphere sample; SPECULAR -> jittered
    mirror; EMIT rays terminate before sampling so their value is unused.
    """
    diff = hemisphere_sample(u, v, normal)
    spec = specular_sample(ray_d, normal, roughness, cube_u)
    is_spec = (mat_type == SPECULAR)[..., None]
    return jnp.where(is_spec, spec, diff)
