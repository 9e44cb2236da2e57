"""Phase-attribution profile of one Pfam-shaped scan.

Builds bench.py's problem and attributes a warm scan's wall time to three
phases on the host clock:

  encode+queue    host fragment-index encoding + read upload
                  + dispatching every block's kernel (async)
  sync            device completion + result pulls (np.asarray per block)
  gate+traceback  LRT filter + traceback of survivors

Run on a GPU:  python benchmarks/scan_profile.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import tempfile

    import bench
    from deciphon_tpu.db.format import TensorDB, write_db
    from deciphon_tpu.models.h3reader import build_profile
    from deciphon_tpu.models.h3writer import pfam_like_core_sizes, random_h3
    from deciphon_tpu.ops.scan_engine import (
        ScanEngine, ScanParams, SeqRecord,
    )
    from deciphon_tpu.utils import gpu, jaxcache

    print(gpu.require_gpu(), gpu.card_info())
    jaxcache.enable()
    rng = np.random.default_rng(42)
    sizes = pfam_like_core_sizes(rng, bench.NPROF)
    profiles = (
        build_profile(random_h3(int(s) + 1, int(k), peak=0.8))
        for s, k in enumerate(sizes)
    )
    t0 = time.perf_counter()
    with tempfile.NamedTemporaryFile(suffix=".dtp") as fp:
        write_db(fp.name, profiles)
        db = TensorDB.load(fp.name)
    print(f"press            {time.perf_counter() - t0:8.3f}s")
    lens = rng.integers(150, 500, bench.NSEQS)
    seqs = [
        SeqRecord(i, f"r{i}", "".join(rng.choice(list("ACGT"), int(L))))
        for i, L in enumerate(lens)
    ]
    engine = ScanEngine(db, ScanParams(lrt_threshold=10.0))
    t0 = time.perf_counter()
    engine.warmup(bench.NSEQS, int(lens.max()))
    print(f"warmup           {time.perf_counter() - t0:8.3f}s")
    t0 = time.perf_counter()
    engine.scan(seqs)
    print(f"first scan       {time.perf_counter() - t0:8.3f}s")

    # ---- instrumented warm scan --------------------------------------
    for _ in range(2):
        phases: dict[str, float] = {}

        def mark(name: str, t0: float) -> float:
            t1 = time.perf_counter()
            phases[name] = phases.get(name, 0.0) + (t1 - t0)
            return t1

        t0 = time.perf_counter()
        encoded, pending = engine._queue_dispatches(seqs)
        t0 = mark("encode+queue", t0)
        per_block = []
        for seq_ids, blk, codes, alt, null in pending:
            tb = time.perf_counter()
            a = np.asarray(alt)
            n = np.asarray(null)
            per_block.append(
                (blk.kpad, len(blk.chunk), time.perf_counter() - tb)
            )
            del a, n
        t0 = mark("sync", t0)
        hits = engine._gate_and_traceback(seqs, encoded, pending)
        mark("gate+traceback", t0)

        total = sum(phases.values())
        print(f"\nwarm scan total  {total:8.3f}s   hits={len(hits)}")
        for k, v in phases.items():
            print(f"  {k:<15} {v:8.3f}s  {100 * v / total:5.1f}%")
        print("  per-block sync (kpad, nprof, s):")
        for kpad, nprof, dt in per_block:
            print(f"    kpad={kpad:<5} n={nprof:<4} {dt:8.3f}s")


if __name__ == "__main__":
    main()
