"""Pinhole camera (L2), batched port of ``/root/reference/pathtracer/camera.h``.

The reference stores the camera basis in a flat row-major 4x4 transform
(rows = right, up, -forward, pos; camera.h:27-58) and generates one ray per
(pixel, sample) with sub-pixel jitter from a global RNG (camera.h:63-73).

Here the camera is an immutable pytree; ``get_rays`` is fully batched: it
takes arrays of pixel coordinates and jitter uniforms and returns ray origin
/ direction arrays, so ray generation is one fused elementwise XLA program.
FPS-style ``rotate``/``move`` (camera.h:77-141) are pure functions returning
a new camera, used by the realtime progressive viewer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .linalg import DEG2RAD

FORWARD, BACKWARD, LEFT, RIGHT, UP, DOWN = range(6)  # camera.h:10-17


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Camera:
    pos: jnp.ndarray       # (3,)
    forward: jnp.ndarray   # (3,) unit
    up: jnp.ndarray        # (3,) unit
    right: jnp.ndarray     # (3,) unit
    world_up: jnp.ndarray  # (3,) unit — fixed rotation axis (camera.h:24)
    v_res: jnp.ndarray     # (2,) virtual image-plane size (camera.h:50-51)
    cell_size: jnp.ndarray  # scalar, v_res.x / res.x (camera.h:60)
    distance: jnp.ndarray  # scalar image-plane distance
    res: Tuple[int, int]   # (width, height) — static
    # Static sub-pixel convention: the reference GPU megakernel samples at
    # (w + 0.5 + u)*cell (gl_FragCoord's half-pixel offset PLUS the jitter,
    # shader.h:274-277), while the CPU path samples at (w + u)*cell
    # (camera.h:64).  The golden images are GPU renders, so 0.5 is the
    # default; pass pixel_offset=0.0 for CPU-convention parity.
    pixel_offset: float = 0.5

    def tree_flatten(self):
        children = (self.pos, self.forward, self.up, self.right,
                    self.world_up, self.v_res, self.cell_size, self.distance)
        return children, (self.res, self.pixel_offset)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, res=aux[0], pixel_offset=aux[1])

    @property
    def width(self) -> int:
        return self.res[0]

    @property
    def height(self) -> int:
        return self.res[1]


def make_camera(pos, forward, up, res, fov, distance=1.0,
                pixel_offset=0.5) -> Camera:
    """Construct a camera exactly as camera.h:33-61.

    ``fov`` is the horizontal field of view in radians (callers typically pass
    ``60 * DEG2RAD``); ``res`` is (width, height).
    """
    pos = np.asarray(pos, np.float32)
    forward = np.asarray(forward, np.float32)
    up = np.asarray(up, np.float32)

    fwd = forward / np.linalg.norm(forward)
    upn = up / np.linalg.norm(up)
    if abs(float(np.dot(fwd, upn))) > 0.999:  # camera.h:41-45
        raise ValueError("Up vector is too close to forward vector")
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)

    w, h = int(res[0]), int(res[1])
    vx = 2.0 * distance * math.tan(fov / 2.0)
    vy = vx * h / w
    v_res = np.array([vx, vy], np.float32)
    cell = np.float32(vx / w)

    return Camera(
        pos=jnp.asarray(pos),
        forward=jnp.asarray(fwd),
        up=jnp.asarray(upn),
        right=jnp.asarray(right),
        world_up=jnp.asarray(upn),
        v_res=jnp.asarray(v_res),
        cell_size=jnp.asarray(cell),
        distance=jnp.asarray(np.float32(distance)),
        res=(w, h),
        pixel_offset=float(pixel_offset),
    )


def get_rays(cam: Camera, w, h, u1, u2):
    """Batched version of Camera::get_ray (camera.h:63-73).

    w, h: integer pixel-coordinate arrays (any broadcastable shape).
    u1, u2: sub-pixel jitter uniforms in [0, 1), same shape.
    Returns (ray_o, ray_d) with shape (..., 3); ray_d normalized.

    The reference builds the camera-space direction
        ((w + u)*cell - v_res.x/2, (h + v)*cell - v_res.y/2, -distance)
    and rotates it by the basis rows; written out, the world direction is
        x*right + y*up + distance*forward.
    """
    off = jnp.float32(cam.pixel_offset)
    x = (w.astype(jnp.float32) + off + u1) * cam.cell_size - cam.v_res[0] * 0.5
    y = (h.astype(jnp.float32) + off + u2) * cam.cell_size - cam.v_res[1] * 0.5
    d = (x[..., None] * cam.right + y[..., None] * cam.up
         + cam.distance * cam.forward)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(cam.pos, d.shape)
    return o, d


def _renorm(v):
    return v / jnp.linalg.norm(v)


def rotate(cam: Camera, direction: int, angle: float) -> Camera:
    """FPS-style rotation (camera.h:77-107): yaw about world_up, pitch about
    right; basis re-orthogonalized exactly as the reference does."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    fwd, up, right = cam.forward, cam.up, cam.right
    if direction == LEFT:
        fwd = _renorm(fwd * c - right * s)
        right = _renorm(jnp.cross(fwd, cam.world_up))
        up = _renorm(jnp.cross(right, fwd))
    elif direction == RIGHT:
        fwd = _renorm(fwd * c + right * s)
        right = _renorm(jnp.cross(fwd, cam.world_up))
        up = _renorm(jnp.cross(right, fwd))
    elif direction == UP:
        fwd = _renorm(fwd * c + up * s)
        up = _renorm(jnp.cross(right, fwd))
    elif direction == DOWN:
        fwd = _renorm(fwd * c - up * s)
        up = _renorm(jnp.cross(right, fwd))
    return dataclasses.replace(cam, forward=fwd, up=up, right=right)


def move(cam: Camera, direction: int, amount: float) -> Camera:
    """Translation relative to world_up / right (camera.h:108-141)."""
    pos = cam.pos
    if direction == UP:
        pos = pos + cam.world_up * amount
    elif direction == DOWN:
        pos = pos - cam.world_up * amount
    elif direction == FORWARD:
        const_fwd = _renorm(jnp.cross(cam.world_up, cam.right))
        pos = pos + const_fwd * amount
    elif direction == BACKWARD:
        const_fwd = _renorm(jnp.cross(cam.world_up, cam.right))
        pos = pos - const_fwd * amount
    elif direction == LEFT:
        pos = pos - cam.right * amount
    elif direction == RIGHT:
        pos = pos + cam.right * amount
    return dataclasses.replace(cam, pos=pos)
