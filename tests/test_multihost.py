"""Simulated multi-host test: 2 processes x 4 virtual CPU devices form one
8-device global mesh via jax.distributed; the batched EP solve shards
instances across processes (the DCN data axis of SURVEY §2.10) and each
process validates its addressable shards against a local solve.

The workers run in subprocesses because jax.distributed needs one process
per 'host' (the reference has no distributed analog at all)."""
import os
import socket
import subprocess
import sys

import pytest

_DIR = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_mesh_ep():
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_DIR, "multihost_worker.py"),
             str(i), "2", port],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert "OK" in out, f"proc {i} no OK:\n{out}"
