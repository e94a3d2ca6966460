"""Multi-host initialization and host-level orchestration.

The reference has no distributed story at all (single process, SURVEY.md
section 5).  For multi-host clusters:

  * every host runs the same program; ``initialize()`` wires up
    ``jax.distributed`` (coordinator discovery via env or args), after which
    ``jax.devices()`` is global and the (tile, sample) mesh spans the hosts —
    nothing else in the framework changes, because all cross-device
    communication is expressed as mesh collectives (psum over the device
    interconnect; the host network carries the jax.distributed control
    plane).
  * film assembly: each host materializes only its addressable shards;
    ``gather_film`` brings the full film to host 0 for I/O at epoch end.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed (no-op for single-process runs).

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID), so
    launchers can configure purely through the environment.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return  # single process
    kw = {}
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(coordinator_address=coordinator, **kw)


def is_primary() -> bool:
    return jax.process_index() == 0


def gather_film(film_array) -> Optional[np.ndarray]:
    """Assemble a (possibly host-sharded) film on process 0.

    Returns the full numpy array on the primary host, None elsewhere."""
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return np.asarray(film_array)
    full = multihost_utils.process_allgather(film_array, tiled=True)
    return np.asarray(full) if is_primary() else None
