"""Multi-process distributed backend test (SURVEY.md section 5).

Launches two real OS processes, each with 2 virtual CPU devices, wired
together with ``jax.distributed`` through parallel/distributed.initialize —
the actual multi-host code path (the reference has no distributed story at
all; this is a new capability of this framework).  Verifies:

  * process discovery (process_count / device_count / is_primary);
  * a psum over a mesh that SPANS both processes;
  * ``gather_film`` delivering the full film on host 0 and None elsewhere.
"""

import os
import socket
import subprocess
import sys

import pytest

NPROC = 2


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "_distributed_worker.py")
    port = _free_port()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device counts
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), str(NPROC), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=root,
        )
        for pid in range(NPROC)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER_{pid}_OK" in out, f"worker {pid} output:\n{out}"
