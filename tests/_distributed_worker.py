"""Worker process for tests/test_distributed.py.

Run as: python _distributed_worker.py <process_id> <num_processes> <port>

Exercises the real multi-process path of parallel/distributed.py — the
jax.distributed control plane, a cross-process mesh collective, and the
host-0 film gather — on CPU devices (2 per process), so the test runs on
the CI mesh with no accelerator.
"""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# Pin the CPU before any backend initialization.
jax.config.update("jax_platforms", "cpu")

from pathtracer_tpu.parallel import distributed  # noqa: E402

distributed.initialize(
    coordinator=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from pathtracer_tpu.parallel import make_mesh  # noqa: E402
from pathtracer_tpu.parallel.mesh import SAMPLE_AXIS, TILE_AXIS  # noqa: E402

assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == 2 * nproc, jax.device_count()
assert distributed.is_primary() == (pid == 0)

# ---- cross-process collective over the global (tile, sample) mesh --------
mesh = make_mesh(tile=2, sample=nproc)
try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
import functools  # noqa: E402


@functools.partial(shard_map, mesh=mesh, in_specs=(), out_specs=P())
def axis_sum():
    ti = jax.lax.axis_index(TILE_AXIS)
    si = jax.lax.axis_index(SAMPLE_AXIS)
    return jax.lax.psum(
        jnp.ones((1,)) * (ti * 10 + si), (TILE_AXIS, SAMPLE_AXIS)
    )


total = axis_sum()
# sum over ti in {0,1}, si in {0..nproc-1} of (10*ti + si)
expect = sum(10 * t + s for t in range(2) for s in range(nproc))
np.testing.assert_allclose(np.asarray(total), [expect])

# ---- host-0 gather of a host-sharded film --------------------------------
H, W = 4 * nproc, 8
sharding = NamedSharding(mesh, P(TILE_AXIS, None, None))


def fill(index):
    rows = np.arange(H)[index[0]]
    return (
        rows[:, None, None] * 100.0
        + np.arange(W)[None, :, None]
        + np.arange(3)[None, None, :] * 0.1
    ).astype(np.float32)


film = jax.make_array_from_callback((H, W, 3), sharding, fill)
full = distributed.gather_film(film)
if pid == 0:
    assert full is not None and full.shape == (H, W, 3)
    np.testing.assert_allclose(full, fill((slice(None),)), rtol=0, atol=0)
else:
    assert full is None

print(f"WORKER_{pid}_OK", flush=True)
