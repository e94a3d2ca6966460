"""Vector math primitives on batched arrays (L1 of the layer map).

Batched replacement for the reference's scalar ``vec2``/``vec3``/``mat4``
structs (``/root/reference/pathtracer/linalg.h:14-235``).  Instead of a
struct-of-scalars vector class, everything here operates on arrays whose
*trailing* dimension is the vector dimension (``(..., 3)``), so all ops are
elementwise/broadcast ops that XLA fuses into device kernels.

Constants mirror ``linalg.h:10-12``.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

# Reference constants (linalg.h:10-12) and render.h:16.
DEG2RAD = math.pi / 180.0
EPS = 1e-6
FLOAT_INF = 1e30
SHIFT_BIAS = 1e-4  # render.h:16 — hit-point offset along the normal.


def dot(a, b):
    """Batched vec3 dot product (linalg.h:140-142)."""
    return jnp.sum(a * b, axis=-1)


def dot_keepdims(a, b):
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    """Batched vec3 cross product (linalg.h:143-145).

    Written out component-wise (rather than jnp.cross) so the expression
    stays a flat fused elementwise graph for XLA.
    """
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length(a):
    return jnp.sqrt(dot(a, a))


def normalize(a):
    """Batched normalize (linalg.h:149-151). No epsilon guard, as reference."""
    return a / length(a)[..., None]


def reflect(v, n):
    """Mirror reflection about normal n (linalg.h:158-160)."""
    return v - n * (2.0 * dot_keepdims(v, n))


def component_min(a, b):
    return jnp.minimum(a, b)


def component_max(a, b):
    return jnp.maximum(a, b)


def vmax3(v):
    """max over the trailing vec3 dim (linalg.h:161-163)."""
    return jnp.max(v, axis=-1)


def vmin3(v):
    return jnp.min(v, axis=-1)


def clamp(x, lo, hi):
    """Scalar/array clamp (linalg.h:233-235)."""
    return jnp.clip(x, lo, hi)


def mix(a, b, t=0.5):
    """Linear blend, a*(1-t) + b*t (linalg.h:197-199)."""
    return a * (1.0 - t) + b * t


# Color constants (linalg.h:185-200).
class color:
    white = (1.0, 1.0, 1.0)
    black = (0.0, 0.0, 0.0)
    red = (1.0, 0.0, 0.0)
    orange = (1.0, 0.5, 0.0)
    yellow = (1.0, 1.0, 0.0)
    green = (0.0, 1.0, 0.0)
    blue = (0.0, 0.0, 1.0)
    purple = (0.5, 0.0, 0.5)
