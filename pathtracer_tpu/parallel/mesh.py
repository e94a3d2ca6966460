"""Device-mesh construction.

Axes:
  * ``tile``   — pixel-row tiles (the spatial axis of the film). The film
                 output stays sharded along this axis.
  * ``sample`` — Monte-Carlo sample batches. Film contributions along this
                 axis are partial sums, reduced with ``psum`` — the
                 radiance estimate is a mean, so the reduction is exactly
                 reassociable (SURVEY.md section 5).

Multi-host: under ``jax.distributed`` the same mesh spans all processes;
``make_mesh`` uses ``jax.devices()`` which is global across hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
from jax.sharding import Mesh

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


def mesh_axes() -> Tuple[str, str]:
    return (TILE_AXIS, SAMPLE_AXIS)


def _factor(n: int) -> Tuple[int, int]:
    """Split n into (tile, sample) as square as possible, tile <= sample
    (sample parallelism has no spatial divisibility constraints)."""
    best = (1, n)
    f = 1
    while f * f <= n:
        if n % f == 0:
            best = (f, n // f)
        f += 1
    return best


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    tile: Optional[int] = None,
    sample: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 2D (tile, sample) mesh over the available devices.

    With no arguments, uses every device and a near-square factorization.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if tile is None and sample is None:
        tile, sample = _factor(n)
    elif tile is None:
        tile = n // sample
    elif sample is None:
        sample = n // tile
    if tile * sample != n:
        raise ValueError(f"mesh {tile}x{sample} != {n} devices")
    import numpy as np

    arr = np.asarray(devices).reshape(tile, sample)
    return Mesh(arr, (TILE_AXIS, SAMPLE_AXIS))
