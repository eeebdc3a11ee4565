"""Ranks of a gloo group, spawned as tests/test_multiprocess.py spawns its
workers: a free port, fresh interpreters, a timeout of their own."""
import os
import pathlib
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(n: int, worker: str, out: pathlib.Path, timeout: float = 240.0):
    """Run tests/<worker> as ranks 0 .. n-1 of a gloo group on a free port;
    each writes its results under `out`. A rank that fails or outlives
    `timeout` fails the test, and every rank is stopped. Returns the ranks'
    logs."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    logs = [open(out / f"rank{rank}.log", "w") for rank in range(n)]
    try:
        procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / worker), str(rank), str(n),
                                   str(port), str(out)], env=env, stdout=log,
                                  stderr=subprocess.STDOUT) for rank, log in enumerate(logs)]
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        for log in logs:
            log.close()
    texts = [(out / f"rank{rank}.log").read_text() for rank in range(n)]
    for rank, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"rank {rank} failed:\n{text}"
    return texts


def spawn_pair(worker: str, out: pathlib.Path, timeout: float = 240.0):
    """Ranks 0 and 1 (spawn_ranks(2, ...))."""
    return spawn_ranks(2, worker, out, timeout)
