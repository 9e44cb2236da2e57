"""dcp-tpu command line.

``serve`` is the reference's dcp-server daemon (src/cli/cli_server.c:133-183:
.env config, scheduler poll loop).  ``press``/``scan``/``info`` are local
conveniences the reference routes through the scheduler instead.
"""

from __future__ import annotations

import argparse
import sys

from deciphon_tpu.utils import logging as log
from deciphon_tpu.utils.rc import RC, DcpError


def cmd_serve(args) -> int:
    from deciphon_tpu.server.daemon import Server
    from deciphon_tpu.utils.config import ServerConfig

    cfg = ServerConfig.from_env(args.env)
    cfg.single_run = args.single_run
    if args.cache_dir:
        cfg.cache_dir = args.cache_dir
    server = Server(cfg)
    server.install_signal_handler()
    server.run()
    return 0


def cmd_press(args) -> int:
    from deciphon_tpu.db.format import write_db
    from deciphon_tpu.models.h3reader import press_file
    from deciphon_tpu.models.profile import (
        ENTRY_DIST_OCCUPANCY,
        ENTRY_DIST_UNIFORM,
        ProteinCfg,
    )

    out = args.output or args.hmm.rsplit(".", 1)[0] + ".dtp"
    cfg = ProteinCfg(
        entry_dist=(
            ENTRY_DIST_UNIFORM if args.uniform_entry else ENTRY_DIST_OCCUPANCY
        ),
        epsilon=args.epsilon,
    )
    n = 0
    from deciphon_tpu.db.format import write_db as _write

    def gen():
        nonlocal n
        for p in press_file(args.hmm, cfg):
            n += 1
            if n % 100 == 0:
                log.info("pressed %d profiles", n)
            yield p

    _write(out, gen())
    print(f"pressed {n} profiles -> {out}")
    return 0


def cmd_scan(args) -> int:
    from deciphon_tpu.db.dispatch import STANDARD, db_typeid
    from deciphon_tpu.db.format import TensorDB
    from deciphon_tpu.ops.scan_engine import ScanEngine, ScanParams, SeqRecord
    from deciphon_tpu.server.prod import ProdWriter
    from deciphon_tpu.utils.fasta import read_fasta

    # typeid dispatch (the reference's profile vtable at db-open time,
    # src/db/profile_reader.c:95-98 / src/model/profile.h:11-18)
    if db_typeid(args.db) == STANDARD:
        return _scan_standard(args)
    db = TensorDB.load(args.db)
    subset = None
    nprofiles = db.nprofiles
    if args.shard:
        # share-nothing scale-out: worker i of N scans one contiguous
        # size-balanced DB partition (the reference's model — N daemons
        # against one scheduler — with the reference's byte-balanced
        # prefix-sum split, src/db/profile_reader.c:44-72)
        from deciphon_tpu.db.partition import balanced_partitions

        i, n = (int(x) for x in args.shard.split("/", 1))
        if not 1 <= i <= n:
            raise ValueError(f"--shard {args.shard}: need 1 <= i <= N")
        part = balanced_partitions(db.profile_weights(), n)[i - 1]
        subset = list(part)
        nprofiles = len(subset)
    engine = ScanEngine(
        db,
        ScanParams(
            multi_hits=not args.no_multi_hits,
            hmmer3_compat=args.hmmer3_compat,
            lrt_threshold=args.lrt_threshold,
            algo="forward" if getattr(args, "forward", False) else "viterbi",
        ),
        subset=subset,
    )
    # stream the FASTA in bounded batches (same memory envelope as the
    # daemon's DCP_SCAN_BATCH streaming) so a multi-GB read set never
    # lives in host memory at once
    writer = ProdWriter(scan_id=0)
    nhits = 0
    nseqs = 0
    warmed = False
    batch: list[SeqRecord] = []

    def flush(batch):
        nonlocal nhits, warmed
        if not warmed:
            # build the device tables and compile every block's variant
            # before the first scan
            engine.warmup(len(batch), max(len(r.data) for r in batch))
            warmed = True
        if args.best_hit:
            # one row per read: device-side argmax reduction (on a mesh
            # the reduction crosses profile shards as an XLA collective,
            # ScanEngine.best_hits); no traceback/match column —
            # BASELINE.json's "best-hit per read" config
            for b in engine.best_hits(batch):
                if b.lrt >= args.lrt_threshold:
                    writer.add(
                        b.seq_id, b.accession, b.alt_loglik,
                        b.null_loglik, "",
                    )
                    nhits += 1
            return
        for h in engine.scan(batch):
            writer.add(
                h.seq_id, h.accession, h.alt_loglik, h.null_loglik, h.match
            )
            nhits += 1

    for name, data in read_fasta(args.fasta):
        nseqs += 1
        batch.append(SeqRecord(nseqs, name, data))
        if len(batch) >= args.batch_size:
            flush(batch)
            batch = []
    if batch:
        flush(batch)
    out = args.output or "prods.tsv"
    writer.write(out)
    shard = f" (shard {args.shard})" if args.shard else ""
    print(f"{nhits} hits from {nseqs} seqs x "
          f"{nprofiles} profiles{shard} -> {out}")
    return 0


def _scan_standard(args) -> int:
    """Scan against a standard (typeid-1, generic dense HMM) database.

    Vestigial in the reference (its reader only instantiates PROTEIN)
    but the kind exists in the enum and scan vtable; here it scans for
    real via the batched XLA Viterbi (ops/viterbi_standard.py).  Rows
    carry typeid 'standard' and an empty match column (generic profiles
    have no codon decode; the reference defines none either)."""
    from deciphon_tpu.db.standard_db import load_standard_db
    from deciphon_tpu.ops.viterbi_standard import scan_standard
    from deciphon_tpu.server.prod import ProdWriter
    from deciphon_tpu.utils.fasta import read_fasta

    profiles = load_standard_db(args.db)
    writer = ProdWriter(
        scan_id=0,
        abc_name=profiles[0].abc.name if profiles else "dna",
        profile_typeid="standard",
    )
    nhits = 0
    nseqs = 0
    batch: list[tuple[int, str]] = []

    def flush(batch):
        nonlocal nhits
        hits = scan_standard(
            profiles, [d for _, d in batch],
            lrt_threshold=args.lrt_threshold,
        )
        for q, b, alt, null, _lrt in hits:
            writer.add(batch[q][0], profiles[b].accession, alt, null, "")
            nhits += 1

    for name, data in read_fasta(args.fasta):
        nseqs += 1
        batch.append((nseqs, data))
        if len(batch) >= args.batch_size:
            flush(batch)
            batch = []
    if batch:
        flush(batch)
    out = args.output or "prods.tsv"
    writer.write(out)
    print(f"{nhits} hits from {nseqs} seqs x "
          f"{len(profiles)} profiles -> {out}")
    return 0


# Reference anchors for the PF02545 parity run (BASELINE.md):
#   alt Viterbi loglik of the 1023-nt consensus read, profile 1
#   (/root/reference/test/protein_h3reader.c:57) and the .hmm asset's
#   XXH3-64 content hash (/root/reference/test/sched.c:92).
PF02545_GOLDEN_ALT = -1430.9281381240353
PF02545_HMM_XXH3 = -7843725841264658444


def cmd_parity(args) -> int:
    """One-command reference parity runner.

    Verifies this rebuild against the reference's own test anchors:
    hash-checks the .hmm asset, presses it, rebuilds the consensus
    read, asserts the golden alt log-likelihood, optionally diffs
    structural press metadata against a reference-pressed .dcp, and
    emits the product TSV row for byte-diffing.  The .dcp's imm DP bins
    themselves stay opaque (undocumented imm packing — see README);
    every surrounding byte is checked.
    """
    import numpy as np

    from deciphon_tpu.models.alphabet import DNA, STANDARD_CODE
    from deciphon_tpu.models.h3reader import press_file
    from deciphon_tpu.ops import viterbi_ref as vr
    from deciphon_tpu.server.prod import ProdWriter
    from deciphon_tpu.utils import xfile

    failures = 0

    def check(name: str, ok: bool, detail: str = "") -> None:
        nonlocal failures
        print(f"[{'ok' if ok else 'FAIL'}] {name}" + (f": {detail}" if detail else ""))
        if not ok:
            failures += 1

    h = xfile.xxh3_64(args.hmm)
    known_asset = h == PF02545_HMM_XXH3
    check(
        "hmm xxh3",
        known_asset or not args.strict,
        f"{h}" + ("" if known_asset else " (not the PF02545 test asset; golden checks skipped)"),
    )
    profs = list(press_file(args.hmm))
    check("press", len(profs) >= 1, f"{len(profs)} profiles")
    prof = profs[0]
    read = "".join(
        STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
        for b in np.argmax(prof.match_codonp, axis=1)
    )
    if known_asset:
        check("core_size", prof.core_size == 341, str(prof.core_size))
        check("consensus read length", len(read) == 1023, str(len(read)))
    res = vr.viterbi_alt(prof, DNA.encode(read))
    nul = vr.viterbi_null(prof, DNA.encode(read))
    print(f"     alt loglik {res.loglik:.13f}  null {nul.loglik:.13f}")
    if known_asset:
        check(
            "golden alt loglik (protein_h3reader.c:57)",
            abs(res.loglik - PF02545_GOLDEN_ALT) <= args.tolerance,
            f"got {res.loglik:.13f}, want {PF02545_GOLDEN_ALT} "
            f"(|diff| {abs(res.loglik - PF02545_GOLDEN_ALT):.2e} <= {args.tolerance})",
        )
    if args.dcp:
        from deciphon_tpu.db.dcp import read_dcp

        info = read_dcp(args.dcp)
        check("dcp profile count", info.nprofiles == len(profs),
              f"{info.nprofiles} vs {len(profs)}")
        for meta, p in zip(info.profiles, profs):
            if meta.accession != p.accession or meta.core_size != p.core_size:
                check(
                    "dcp profile metadata",
                    False,
                    f"{meta.accession}/{meta.core_size} vs "
                    f"{p.accession}/{p.core_size}",
                )
                break
        else:
            check("dcp profile metadata", True,
                  "accessions + core sizes match")
    # emit the product TSV row (prod.c:13-53 format) for byte-diffing
    from deciphon_tpu.models import codec

    w = ProdWriter(scan_id=0)
    match = codec.render_match(codec.match_steps(prof, read, res.path))
    w.add(1, prof.accession, res.loglik, nul.loglik, match)
    out = args.output or "parity_prods.tsv"
    w.write(out)
    print(f"     product row -> {out}")
    print("PARITY " + ("OK" if failures == 0 else f"FAILED ({failures})"))
    return 0 if failures == 0 else 1


def cmd_info(args) -> int:
    from deciphon_tpu.db.format import TensorDB

    if args.db.endswith(".dcp"):
        from deciphon_tpu.db.dcp import read_dcp

        info = read_dcp(args.db)
        print(f"format:     reference .dcp (magic 0x{info.magic:X})")
        print(f"profiles:   {info.nprofiles}")
        print(f"type:       {info.typeid_name}")
        print(f"float_size: {info.float_size}")
        print(f"entry_dist: {info.entry_dist_name}")
        print(f"epsilon:    {info.epsilon}")
        if info.profiles:
            ks = [p.core_size for p in info.profiles]
            print(f"nodes:      {sum(ks)} (min {min(ks)}, max {max(ks)})")
        if info.profile_sizes:
            print(f"bytes/prof: min {min(info.profile_sizes)}, "
                  f"max {max(info.profile_sizes)}")
        if info.profiles:
            # invariant-driven imm_dp tensor extraction attempt
            # (db/dcp_dp.py); on failure the error IS the analysis of
            # which bytes block a scan of this file
            from deciphon_tpu.db.dcp_dp import DcpDpError

            try:
                null, alt = info.profiles[0].decode_dp()
                print(f"dp decode:  ok ({alt.report})")
            except DcpDpError as e:
                print(f"dp decode:  FAILED — {e}")
        return 0

    from deciphon_tpu.db.dispatch import STANDARD, db_typeid

    if db_typeid(args.db) == STANDARD:
        from deciphon_tpu.db.standard_db import load_standard_db

        profs = load_standard_db(args.db)
        print(f"profiles:   {len(profs)}")
        print("type:       standard")
        if profs:
            print(f"abc:        {profs[0].abc.name}")
            ns = [p.nstates for p in profs]
            print(f"states:     {sum(ns)} (min {min(ns)}, max {max(ns)})")
        return 0

    db = TensorDB.load(args.db)
    h = db.header
    print(f"profiles:   {db.nprofiles}")
    print(f"type:       {h['profile_typeid']}")
    print(f"entry_dist: {h['entry_dist']}")
    print(f"epsilon:    {h['epsilon']}")
    print(f"nodes:      {int(db.core_sizes.sum())} "
          f"(min {int(db.core_sizes.min())}, "
          f"max {int(db.core_sizes.max())})")
    return 0


def main(argv=None) -> int:
    from deciphon_tpu.utils import jaxcache

    jaxcache.enable()
    log.setup()
    ap = argparse.ArgumentParser(prog="dcp-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve", help="run the scheduler-polling worker")
    p.add_argument("--env", default=".env")
    p.add_argument("--cache-dir", default="")
    p.add_argument("--single-run", action="store_true")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("press", help="compile a HMMER3 .hmm into a .dtp db")
    p.add_argument("hmm")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--epsilon", type=float, default=0.01)
    p.add_argument("--uniform-entry", action="store_true")
    p.set_defaults(fn=cmd_press)

    p = sub.add_parser("scan", help="scan FASTA reads against a .dtp db")
    p.add_argument("db")
    p.add_argument("fasta")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--lrt-threshold", type=float, default=10.0)
    p.add_argument("--no-multi-hits", action="store_true")
    p.add_argument("--hmmer3-compat", action="store_true")
    p.add_argument(
        "--batch-size", type=int, default=1024,
        help="reads scanned per device batch (memory bound)",
    )
    p.add_argument(
        "--shard", default="",
        help="i/N: scan only the i-th of N size-balanced DB partitions "
             "(share-nothing scale-out; run N workers, merge TSVs)",
    )
    p.add_argument(
        "--best-hit", action="store_true",
        help="emit one row per read (its best LRT-passing profile) via "
             "the device-side argmax reduction; no match column",
    )
    p.add_argument(
        "--forward", action="store_true",
        help="score with the forward algorithm (logsumexp over all "
             "paths) instead of Viterbi: logliks/LRT measure total path "
             "mass; match strings still decode the Viterbi path",
    )
    p.set_defaults(fn=cmd_scan)

    p = sub.add_parser("info", help="describe a .dtp database")
    p.add_argument("db")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "parity",
        help="run the reference parity suite on a .hmm asset "
             "(golden loglik, press metadata vs .dcp, TSV emit)",
    )
    p.add_argument("hmm", help="e.g. PF02545.hmm (the reference test asset)")
    p.add_argument("dcp", nargs="?", default="",
                   help="optional reference-pressed .dcp to diff against")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--tolerance", type=float, default=1e-3,
                   help="|diff| bound on the golden loglik (f64 oracle "
                        "vs imm accumulation order)")
    p.add_argument("--strict", action="store_true",
                   help="fail if the .hmm hash is not the known asset")
    p.set_defaults(fn=cmd_parity)

    args = ap.parse_args(argv)
    # error boundary: user-level failures become one log line + exit code,
    # not a traceback (reference couples every error path to a logged rc,
    # include/deciphon/core/logging.h:116-156)
    try:
        return args.fn(args)
    except DcpError as e:
        log.error(str(e))
        return int(e.rc) or 1
    except (FileNotFoundError, IsADirectoryError, PermissionError) as e:
        log.error(f"{RC.EIO}: {e}")
        return int(RC.EIO)
    except ValueError as e:
        log.error(f"{RC.EINVAL}: {e}")
        return int(RC.EINVAL)
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
