"""pathtracer_tpu — a differentiable Monte-Carlo path tracer in JAX.

Umbrella API (the analog of ``/root/reference/pathtracer/pathtracer.h``,
which re-exports bvh/camera/linalg/material/render/triangle).  Typical use:

    import pathtracer_tpu as pt
    cam, scene = pt.cornell_box(res=(512, 512))
    film = pt.render(cam, scene, samples=256, depth=5, filename="out.png")

Subsystem map (SURVEY.md section 2 inventory -> modules):
    linalg, rng                 L1 math/RNG primitives
    scene, camera, materials    L2 scene (SoA triangles, pinhole camera, BRDFs)
    bvh                         L2 acceleration (host SAH build, flat arrays)
    ops.intersect, ops.trace    device intersection + bounce loop
    ops.wavefront, ops.pallas   wavefront pipeline and the GPU megakernel
    policy                      which backend runs a scene on which platform
    image                       L3b film + PNG/PPM I/O
    render                      L4 drivers
    realtime                    progressive-accumulation viewer state machine
    diff, inverse               differentiable rendering + inverse rendering
    parallel                    multi-device sharding (mesh, shard_map, psum)
    obj_loader                  OBJ/MTL scene import
    utils                       timer, profiling, checkpointing, native libs,
                                compile cache
"""

from .utils import compile_cache as _compile_cache

_compile_cache.configure()

from .linalg import DEG2RAD, EPS, FLOAT_INF, SHIFT_BIAS, color  # noqa: E402,F401
from .camera import (  # noqa: E402,F401
    Camera, make_camera, get_rays, rotate, move,
    FORWARD, BACKWARD, LEFT, RIGHT, UP, DOWN,
)
from .materials import EMIT, DIFFUSE, SPECULAR  # noqa: E402,F401
from .scene import (  # noqa: E402,F401
    Scene, SceneBuilder, HostMaterial, Diffuse, Emit, Specular,
    cornell_box, modified_cornell, corner_scene,
)
from .bvh import FlatBVH, build_bvh, print_tree  # noqa: E402,F401
from .image import Film, psnr, read_png, write_png  # noqa: E402,F401
from .render import render, render_film  # noqa: E402,F401
from .obj_loader import load_obj, load_obj_scene  # noqa: E402,F401
from .realtime import RealtimeSession, render_realtime  # noqa: E402,F401
from .utils.timer import Timer  # noqa: E402,F401

__version__ = "0.1.0"
