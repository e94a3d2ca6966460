"""Scene representation (L2): SoA triangle + material arrays.

The reference stores an array-of-structs ``std::vector<Triangle>`` with an
embedded ``Material`` per triangle (``triangle.h:7-23``).  The device
layout is structure-of-arrays: vertex arrays ``(T, 3)`` and per-triangle
material columns, which load as contiguous device arrays and broadcast cleanly
against ray batches.  Triangle counts are padded to a lane-friendly multiple;
padding triangles are degenerate (all-zero vertices) so Möller–Trumbore
rejects them via the |det| < EPS test — no masks needed in the hot loop.

Scene builders reproduce the reference example scenes' geometry *data*
verbatim: ``cornell_box`` (examples/cornell_box.cc:16-95), ``modified_cornell``
(examples/modified_cornell.cc:21-106) and the 3-triangle ``corner_scene``
fixture (tests/test_render.cc:13-19).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import materials as mat
from .camera import Camera, make_camera
from .linalg import DEG2RAD


@dataclasses.dataclass
class HostMaterial:
    """Host-side material description (mirrors material.h:27-39)."""
    type: int
    color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emit: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    roughness: float = 0.0


def Diffuse(r, g=None, b=None):
    if g is None:
        g = b = r
    return HostMaterial(mat.DIFFUSE, color=(r, g, b))


def Emit(r, g=None, b=None):
    if g is None:
        g = b = r
    return HostMaterial(mat.EMIT, emit=(r, g, b))


def Specular(roughness, r=1.0, g=None, b=None):
    if g is None:
        g = b = r
    return HostMaterial(mat.SPECULAR, color=(r, g, b), roughness=roughness)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Scene:
    """Device-ready SoA scene. All arrays padded to ``padded_size`` rows."""
    v1: jnp.ndarray         # (T, 3) float32
    v2: jnp.ndarray         # (T, 3)
    v3: jnp.ndarray         # (T, 3)
    mat_type: jnp.ndarray   # (T,) int32 (EMIT/DIFFUSE/SPECULAR; 0 = padding)
    albedo: jnp.ndarray     # (T, 3)
    emit: jnp.ndarray       # (T, 3)
    roughness: jnp.ndarray  # (T,)
    num_tris: int           # static: real (unpadded) triangle count
    has_specular: bool = True  # static: any SPECULAR material present

    def tree_flatten(self):
        return (
            (self.v1, self.v2, self.v3, self.mat_type,
             self.albedo, self.emit, self.roughness),
            (self.num_tris, self.has_specular),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, num_tris=aux[0], has_specular=aux[1])

    @property
    def padded_size(self) -> int:
        return int(self.v1.shape[0])

    def host_verts(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """UNPADDED (n, 3) vertex arrays as host numpy.

        Acceleration-structure builders (bvh.py, clusters.py) run on the
        host; pulling device arrays back through the accelerator transport
        costs far more than the build itself, so ``SceneBuilder.build``
        attaches the original numpy buffers and this returns them without
        touching the device.  Scenes reconstructed through pytree
        transforms lose the cache and fall back to a device fetch.
        """
        n = self.num_tris
        cached = getattr(self, "_host_v", None)
        if cached is not None:
            return cached[0][:n], cached[1][:n], cached[2][:n]
        return (np.asarray(self.v1)[:n], np.asarray(self.v2)[:n],
                np.asarray(self.v3)[:n])

    def host_materials(self):
        """UNPADDED host (mat_type, albedo, emit, roughness) arrays, from
        the builder's cache when available (see :meth:`host_verts`)."""
        n = self.num_tris
        cached = getattr(self, "_host_m", None)
        if cached is not None:
            return tuple(a[:n] for a in cached)
        return (np.asarray(self.mat_type)[:n], np.asarray(self.albedo)[:n],
                np.asarray(self.emit)[:n], np.asarray(self.roughness)[:n])

    def centroids(self) -> np.ndarray:
        """Host-side triangle centroids (triangle.h:17)."""
        v1, v2, v3 = self.host_verts()
        return (v1 + v2 + v3) / 3.0

    def aabbs(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side per-triangle AABBs (triangle.h:19-22): (lb, rt)."""
        v1, v2, v3 = self.host_verts()
        lb = np.minimum(np.minimum(v1, v2), v3)
        rt = np.maximum(np.maximum(v1, v2), v3)
        return lb, rt

    def replace_materials(self, albedo=None, emit=None, roughness=None):
        """Return a scene with swapped material arrays (differentiable path)."""
        new = dataclasses.replace(
            self,
            albedo=self.albedo if albedo is None else albedo,
            emit=self.emit if emit is None else emit,
            roughness=self.roughness if roughness is None else roughness,
        )
        cached = getattr(self, "_host_v", None)
        if cached is not None:  # geometry is unchanged; keep the host cache
            object.__setattr__(new, "_host_v", cached)
        return new


class SceneBuilder:
    """Host-side accumulation of triangles (analog of BVH::add_triangle,
    bvh.h:38-41, minus the acceleration structure, which is built separately
    by :mod:`pathtracer_tpu.bvh`)."""

    def __init__(self):
        self._v = []
        self._m = []

    def add_triangle(self, v1, v2, v3, material: HostMaterial) -> "SceneBuilder":
        self._v.append((v1, v2, v3))
        self._m.append(material)
        return self

    def add_quad(self, q, material: HostMaterial, fan: bool = False) -> "SceneBuilder":
        """Two triangles for quad corners q = (a, b, c, d).

        ``fan=False`` uses the (a,b,c),(d,c,a) split the reference uses for
        most quads; ``fan=True`` uses (a,b,c),(a,c,d) as used for the tall
        box (examples/cornell_box.cc:76-95).
        """
        a, b, c, d = q
        self.add_triangle(a, b, c, material)
        if fan:
            self.add_triangle(a, c, d, material)
        else:
            self.add_triangle(d, c, a, material)
        return self

    def __len__(self):
        return len(self._v)

    def build(self, pad_to_multiple: int = 8) -> Scene:
        n = len(self._v)
        if n == 0:
            raise ValueError("No triangles in scene.")
        p = max(pad_to_multiple, 1)
        padded = ((n + p - 1) // p) * p

        verts = np.zeros((3, padded, 3), np.float32)
        for i, (a, b, c) in enumerate(self._v):
            verts[0, i] = a
            verts[1, i] = b
            verts[2, i] = c

        mtype = np.zeros((padded,), np.int32)
        albedo = np.zeros((padded, 3), np.float32)
        emit = np.zeros((padded, 3), np.float32)
        rough = np.zeros((padded,), np.float32)
        for i, m in enumerate(self._m):
            mtype[i] = m.type
            albedo[i] = m.color
            emit[i] = m.emit
            rough[i] = m.roughness

        scene = Scene(
            v1=jnp.asarray(verts[0]), v2=jnp.asarray(verts[1]),
            v3=jnp.asarray(verts[2]), mat_type=jnp.asarray(mtype),
            albedo=jnp.asarray(albedo), emit=jnp.asarray(emit),
            roughness=jnp.asarray(rough), num_tris=n,
            has_specular=bool(np.any(mtype == mat.SPECULAR)),
        )
        # Host geometry/material caches for acceleration-structure builders
        # and kernel scene packers (see Scene.host_verts / host_materials);
        # not dataclass fields / pytree children.
        object.__setattr__(scene, "_host_v",
                           (verts[0], verts[1], verts[2]))
        object.__setattr__(scene, "_host_m", (mtype, albedo, emit, rough))
        return scene


# ---------------------------------------------------------------------------
# Canonical scene fixtures (geometry data reproduced from the reference
# examples; see module docstring for provenance).
# ---------------------------------------------------------------------------

# Cornell-box quad corner coordinates shared by both example scenes.
_FLOOR = ((552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2))
_LIGHT = ((343, 548.7, 227), (343, 548.7, 332), (213, 548.7, 332), (213, 548.7, 227))
_CEILING = ((556, 548.8, 0), (0, 548.8, 0), (0, 548.8, 559.2), (556.0, 548.8, 559.2))
_BACK = ((549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2))
_FRONT = ((556, 0, 0), (0, 0, 0), (0, 548.8, 0), (556, 548.8, 0))
_RIGHT = ((0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2))
_LEFT = ((552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0))

_SHORT_BOX = (
    ((130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)),
    ((290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)),
    ((130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)),
    ((82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)),
    ((240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)),
)
_TALL_BOX = (
    ((423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)),
    ((423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)),
    ((472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)),
    ((314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)),
    ((265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)),
)


def cornell_box(res=(1024, 1024)) -> Tuple[Camera, Scene]:
    """The standard 30-triangle Cornell box (examples/cornell_box.cc:16-98)."""
    white, light = Diffuse(1), Emit(1)
    green, red = Diffuse(0, 1, 0), Diffuse(1, 0, 0)

    sb = SceneBuilder()
    sb.add_quad(_FLOOR, white)
    sb.add_quad(_LIGHT, light)
    sb.add_quad(_CEILING, white)
    sb.add_quad(_BACK, white)
    sb.add_quad(_RIGHT, green)
    sb.add_quad(_LEFT, red)
    for q in _SHORT_BOX:
        sb.add_quad(q, white)
    for q in _TALL_BOX:
        sb.add_quad(q, white, fan=True)

    cam = make_camera((278, 278, -500), (0, 0, 1), (0, 1, 0), res,
                      60 * DEG2RAD, 1.0)
    return cam, sb.build()


def modified_cornell(roughness: float, res=(1024, 1024)) -> Tuple[Camera, Scene]:
    """Specular-walled Cornell variant (examples/modified_cornell.cc:12-106):
    all six walls SPECULAR white at the given roughness, short box red
    diffuse, tall box green diffuse, camera looking in diagonally."""
    walls = Specular(roughness)
    light = Emit(1)
    red, green = Diffuse(1, 0, 0), Diffuse(0, 1, 0)

    sb = SceneBuilder()
    sb.add_quad(_FLOOR, walls)
    sb.add_quad(_LIGHT, light)
    sb.add_quad(_CEILING, walls)
    sb.add_quad(_BACK, walls)
    sb.add_quad(_FRONT, walls)
    sb.add_quad(_RIGHT, walls)
    sb.add_quad(_LEFT, walls)
    for q in _SHORT_BOX:
        sb.add_quad(q, red)
    for q in _TALL_BOX:
        sb.add_quad(q, green, fan=True)

    cam = make_camera((100, 400, 0), (0.5, -0.5, 1), (0, 1, 0), res,
                      80 * DEG2RAD, 1.0)
    return cam, sb.build()


def corner_scene(res=(512, 512)) -> Tuple[Camera, Scene]:
    """3-triangle corner fixture (tests/test_render.cc:11-19): two diffuse
    triangles and one emissive, viewed from (1.8, 1.8, 1.8)."""
    sb = SceneBuilder()
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), Diffuse(1))
    sb.add_triangle((0, 0, 0), (0, 0, 1), (0, 1, 0), Diffuse(0, 1, 0))
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 0, 1),
                    HostMaterial(mat.EMIT, color=(0, 0, 1), emit=(1, 1, 1)))
    cam = make_camera((1.8, 1.8, 1.8), (-1, -1, -1), (0, 1, 0), res,
                      60 * DEG2RAD, 1.0)
    return cam, sb.build()
