"""Scan-throughput measurement on one NVIDIA GPU.

Builds a Pfam-shaped profile database (core sizes from
models/h3writer.pfam_like_core_sizes) and a batch of short random reads,
scans them through the full ScanEngine on the GPU kernel, and prints the
card (JAX's device kind and count, nvidia-smi's name and power limit)
and ONE JSON line:

  {"metric": "pfam_scan_gcups", "value": N, "unit": "GCUPS",
   "device": {...}, "detail": {...}}

Cell updates are counted HMMER-GCUPS-style on unpadded sizes: reads x
profiles x positions x core nodes x 3 (M/I/D); padding efficiency is
those over the cells the backend dispatched.  Without a GPU it exits
non-zero.  This is a measurement script, not yet the benchmark
definition: it has one cell and no trace reduction.

  python bench.py            # BENCH_NPROF / BENCH_NSEQS / BENCH_REPEATS
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

NPROF = int(os.environ.get("BENCH_NPROF", 384))
NSEQS = int(os.environ.get("BENCH_NSEQS", 1024))
REPEATS = int(os.environ.get("BENCH_REPEATS", 5))


def main() -> None:
    from deciphon_tpu.db.format import TensorDB, write_db
    from deciphon_tpu.models.h3reader import build_profile
    from deciphon_tpu.models.h3writer import pfam_like_core_sizes, random_h3
    from deciphon_tpu.ops.scan_engine import ScanEngine, ScanParams, SeqRecord
    from deciphon_tpu.utils import gpu, jaxcache

    device = gpu.require_gpu()
    card = gpu.card_info()
    print(f"device: {device['kind']} x{device['count']}; card: {card}",
          flush=True)
    jaxcache.enable()

    rng = np.random.default_rng(42)
    sizes = pfam_like_core_sizes(rng, NPROF)
    t0 = time.perf_counter()
    profiles = (
        build_profile(random_h3(int(s) + 1, int(k), peak=0.8))
        for s, k in enumerate(sizes)
    )
    with tempfile.TemporaryDirectory() as tmp:
        write_db(os.path.join(tmp, "bench.dtp"), profiles)
        db = TensorDB.load(os.path.join(tmp, "bench.dtp"))
    press_s = time.perf_counter() - t0
    lens = rng.integers(150, 500, NSEQS)
    seqs = [
        SeqRecord(i, f"r{i}", "".join(rng.choice(list("ACGT"), int(L))))
        for i, L in enumerate(lens)
    ]
    engine = ScanEngine(db, ScanParams(lrt_threshold=10.0))
    t0 = time.perf_counter()
    compile_s = engine.warmup(NSEQS, int(lens.max()))
    engine.scan(seqs)
    cold_s = time.perf_counter() - t0
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        engine.scan(seqs)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    counters = engine._counters
    print(json.dumps({
        "metric": "pfam_scan_gcups",
        "value": counters.cells / dt / 1e9,
        "unit": "GCUPS",
        "device": device,
        "detail": {
            "card": card,
            "backend": engine.backend.name,
            "reads_per_sec": NSEQS / dt,
            "padding_efficiency": counters.padding_efficiency,
            "nprofiles": len(sizes),
            "core_median": int(np.median(sizes)),
            "nseqs": NSEQS,
            "nblocks": len(engine._blocks),
            "scan_seconds": times,
            "press_seconds": press_s,
            "compile_seconds": compile_s,
            "cold_seconds": cold_s,
        },
    }))


if __name__ == "__main__":
    main()
