"""Multi-device distribution: device mesh, sharded rendering, sharded training.

The reference is strictly single-process (SURVEY.md section 2, parallelism
inventory); its only parallelism is the OpenGL fragment grid.  This package
promotes that to data parallelism across devices: pixel-row tiles x sample
batches sharded over a ``jax.sharding.Mesh`` via ``shard_map``, scene/BVH
replicated per device (the analog of GLSL uniforms), film partial sums and
material gradients reduced with ``psum``.
"""

from .mesh import make_mesh, mesh_axes  # noqa: F401
from .shard import (  # noqa: F401
    render_film_sharded, render_film_sharded_pallas,
    make_sharded_train_step,
)
