"""Multi-process (2 localhost CPU processes) sharded-scan parity.

The CI-runnable stand-in for a multi-host scan: two real OS
processes join one jax.distributed runtime, build a global
('seqs' x 'profiles') mesh over 2x2 virtual CPU devices, shard one
profile DB across it with make_global_block, run one sharded scan step,
and each process asserts its addressable score shards match the
unsharded single-process engine (parallel/distributed.py).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from deciphon_tpu.parallel import distributed as dist
dist.initialize()
dt, cells = dist.worker_parity_check()
print("PARITY_OK", jax.process_index(), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_scan_parity():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["DCP_COORDINATOR"] = f"127.0.0.1:{port}"
        env["DCP_NUM_PROCS"] = "2"
        env["DCP_PROC_ID"] = str(pid)
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", WORKER.format(repo=REPO)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=REPO,
            )
        )
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
        assert "PARITY_OK" in out, f"no parity marker\n{out}\n{err}"
