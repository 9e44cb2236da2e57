"""Scan scaling harness: throughput vs mesh size.

Runs the sharded SPMD scan step (parallel/sharded_scan.py) over meshes of
1..N devices in two regimes:

  weak   — DB grows with the mesh (fixed profiles per device): the
           production regime (shard a Pfam-scale DB over the cards);
  strong — fixed total DB, more devices.

On the CPU (the default) the harness runs on
XLA_FLAGS=--xla_force_host_platform_device_count=8 virtual devices that
share the same cores, so efficiency numbers indicate sharding overhead
only, not hardware scaling.  ``--gpu`` runs on the host's GPUs instead
(the SURVEY.md §6 north star is >= 0.8 scaling efficiency).

Usage:
  python benchmarks/scaling.py [--gpu] [--profiles-per-device 16] [--nseqs 16]
  python benchmarks/scaling.py --multiprocess N [--gpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CPU mode (no --gpu): eight virtual devices, set before JAX starts.
if "--gpu" not in sys.argv:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"


def build(nprofiles: int, nseqs: int, core: int, seq_len: int):
    import jax

    from deciphon_tpu.models.alphabet import DNA
    from deciphon_tpu.models.h3reader import build_profile
    from deciphon_tpu.models.h3writer import random_h3
    from deciphon_tpu.ops import viterbi_jax as vj
    from deciphon_tpu.ops.emissions import fragment_indices

    rng = np.random.default_rng(0)
    profiles = [
        build_profile(random_h3(s + 1, core, peak=0.8))
        for s in range(nprofiles)
    ]
    block = vj.build_profile_block(profiles)
    seqs = ["".join(rng.choice(list("ACGT"), seq_len)) for _ in range(nseqs)]
    eidx = np.stack(
        [
            vj.end_fragment_indices(
                fragment_indices(DNA.encode(s), pad_to=seq_len)
            )
            for s in seqs
        ]
    )
    slen = np.array([len(s) for s in seqs], np.int32)
    return block, jax.numpy.asarray(eidx), jax.numpy.asarray(slen)


def time_mesh(ndev: int, block, eidx, slen, repeats: int = 3) -> float:
    import jax

    from deciphon_tpu.parallel.mesh import make_scan_mesh
    from deciphon_tpu.parallel.sharded_scan import (
        shard_block,
        shard_seqs,
        sharded_scan_step,
    )

    mesh = make_scan_mesh(
        profile_axis=ndev, seq_axis=1, devices=jax.devices()[:ndev]
    )
    with mesh:
        b = shard_block(mesh, block)
        e, s = shard_seqs(mesh, eidx, slen)
        out = sharded_scan_step(mesh, b, e, s)
        out[3].block_until_ready()
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = sharded_scan_step(mesh, b, e, s)
            out[3].block_until_ready()
            times.append(time.perf_counter() - t0)
    return min(times)


def run_multiprocess(nprocs: int, args) -> int:
    """--multiprocess N: N real OS processes join one jax.distributed
    runtime (localhost coordinator), build a global mesh over all their
    devices, and run the globally-sharded scan step with per-shard
    parity asserted (parallel/distributed.worker_parity_check).  On the
    CPU each process gets two virtual devices; with --gpu process i
    drives card i alone, so no two processes share a card."""
    import socket
    import subprocess

    if os.environ.get("DCP_PROC_ID") is None:
        # parent: spawn the workers
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = []
        for pid in range(nprocs):
            env = dict(os.environ)
            if not args.gpu:
                env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
            env["DCP_COORDINATOR"] = f"127.0.0.1:{port}"
            env["DCP_NUM_PROCS"] = str(nprocs)
            env["DCP_PROC_ID"] = str(pid)
            procs.append(
                subprocess.Popen(
                    [sys.executable] + sys.argv, env=env,
                )
            )
        rc = 0
        for p in procs:
            rc |= p.wait()
        return rc
    # worker
    from deciphon_tpu.parallel import distributed as dist

    pid = int(os.environ["DCP_PROC_ID"])
    dist.initialize(local_device_ids=[pid] if args.gpu else None)
    import jax

    dt, cells = dist.worker_parity_check(
        nprofiles=args.profiles_per_device * len(jax.devices()),
        nseqs=args.nseqs, core=args.core, seq_len=args.seq_len,
    )
    if jax.process_index() == 0:
        print(
            json.dumps(
                dict(
                    processes=jax.process_count(),
                    devices=len(jax.devices()),
                    seconds=dt,
                    cups=cells / dt,
                    parity="ok",
                )
            )
        )
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profiles-per-device", type=int, default=16)
    ap.add_argument("--nseqs", type=int, default=16)
    ap.add_argument("--core", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--gpu", action="store_true",
                    help="run on the host's GPUs instead of a virtual CPU mesh")
    ap.add_argument("--strong", action="store_true",
                    help="fixed total DB instead of per-device")
    ap.add_argument(
        "--multiprocess", type=int, default=0, metavar="N",
        help="run the sharded step across N real processes over a "
             "localhost jax.distributed runtime (the multi-host path)",
    )
    args = ap.parse_args()

    if args.multiprocess:
        return run_multiprocess(args.multiprocess, args)

    import jax

    if args.gpu:
        from deciphon_tpu.utils import gpu

        print(gpu.require_gpu(), gpu.card_info())
    ndevs = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= ndevs]
    results = []
    base_rate = None
    for n in sizes:
        nprof = (
            args.profiles_per_device * (1 if args.strong else n)
        ) or args.profiles_per_device
        block, eidx, slen = build(nprof, args.nseqs, args.core, args.seq_len)
        dt = time_mesh(n, block, eidx, slen)
        cells = args.nseqs * nprof * args.seq_len * args.core * 3
        rate = cells / dt
        if base_rate is None:
            base_rate = rate
        # perfect scaling is n x the single-device rate in BOTH regimes
        # (strong mode's fixed DB still ideally finishes n x faster)
        ideal = base_rate * n
        eff = rate / ideal if ideal else float("nan")
        results.append(
            dict(devices=n, nprofiles=nprof, seconds=dt,
                 cups=rate, efficiency=round(eff, 3))
        )
        print(json.dumps(results[-1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
