"""Start and reap the gloo process groups of tests/test_torch_parallel.py
and tests/test_torch_parallel_adaptive.py: each rank is a
tests/_torch_parallel_worker.py process with torchrun's environment,
its output going to ``rank<r>.log`` in the group's directory (a file, so
no rank can block on a full pipe while another waits in a collective)."""

import os
import socket
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
TIME_LIMIT = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_group(world, out_dir, cases):
    """Start ``world`` worker processes of one gloo group."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
               "RANK": str(rank), "LOCAL_RANK": str(rank),
               "CUDA_VISIBLE_DEVICES": ""}
        log_path = os.path.join(out_dir, f"rank{rank}.log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, WORKER, str(out_dir), *cases], env=env,
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        proc.log_path = log_path
        procs.append(proc)
    return procs


def finish(procs, timeout=TIME_LIMIT):
    """Wait for every worker within ``timeout`` seconds in all (one
    deadline for the whole group); kill them all and fail on a hang or a
    failure."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"a worker hung past {timeout} s (collective mismatch?)")
    for p in procs:
        with open(p.log_path) as f:
            out = f.read()
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        assert "WORKER_OK" in out
