"""Backend policy: which intersection path runs a scene on which platform.

Every driver (render, realtime, wavefront, diff, inverse, parallel, cli)
resolves ``backend="auto"`` here, from the platform of the first JAX device
and the scene size:

  platform  scene <= BRUTE_MAX triangles     larger scenes
  --------  -------------------------------  ----------------------------
  gpu       "pallas" (fused megakernel)      GPU_LARGE_SCENE (XLA BVH)
  cpu       "brute" (dense XLA)              "bvh" (XLA BVH)

Differentiable callers ask for ``differentiable=True``: the megakernel has
no gradient, so small scenes take "brute" there on every platform.  Any
other platform is an error, never a silent fallback.

The Pallas megakernel runs in interpret mode only when the caller passes
``interpret=True`` (the CPU tests do); asking for it without a GPU and
without ``interpret=True`` is an error (:func:`check_kernel_platform`).
"""

from __future__ import annotations

from typing import Optional

import jax

BRUTE_MAX = 512  # max padded triangle count for the dense paths
# Large-scene traversal on the GPU: one stack per ray ("bvh-gather"), not
# packets of rays sharing one stack ("bvh"), whose every while-loop step
# costs a host round trip on a GPU; measured ~800x faster on an H100
# (PERF.md, Findings).
GPU_LARGE_SCENE = "bvh-gather"

RENDER_BACKENDS = ("auto", "brute", "bvh", "bvh-gather", "pallas")
DIFF_BACKENDS = ("auto", "brute", "bvh", "bvh-gather")


def platform() -> str:
    """Platform of the first JAX device ("gpu", "cpu", ...)."""
    return jax.devices()[0].platform


def choose_backend(scene, *, differentiable: bool = False,
                   platform_name: Optional[str] = None) -> str:
    """Resolve ``backend="auto"`` for ``scene`` on ``platform_name``
    (default: the platform of the first JAX device)."""
    plat = platform_name or platform()
    small = scene.padded_size <= BRUTE_MAX
    if plat == "gpu":
        if small:
            return "brute" if differentiable else "pallas"
        return GPU_LARGE_SCENE
    if plat == "cpu":
        return "brute" if small else "bvh"
    raise ValueError(
        f"no backend policy for platform {plat!r}: this program runs on an "
        f"NVIDIA GPU, or on the CPU for tests")


def resolve(backend: str, scene, *, differentiable: bool = False) -> str:
    """``choose_backend`` for "auto"; any other name is checked and
    returned as given."""
    names = DIFF_BACKENDS if differentiable else RENDER_BACKENDS
    if backend not in names:
        raise ValueError(f"unknown backend {backend!r} (use one of {names})")
    if backend == "auto":
        return choose_backend(scene, differentiable=differentiable)
    return backend


def check_kernel_platform(interpret: bool, devices=None) -> None:
    """The megakernel compiles for a GPU; anywhere else it needs an
    explicit ``interpret=True``.  ``devices`` defaults to the default
    JAX devices (a sharded caller passes its mesh's devices)."""
    if interpret:
        return
    plat = (devices[0] if devices is not None else jax.devices()[0]).platform
    if plat != "gpu":
        raise ValueError(
            f"backend 'pallas' compiles for a GPU, and the device platform "
            f"is {plat!r}; pass interpret=True to run it in the Pallas "
            f"interpreter, or use backend 'brute'/'bvh'")
