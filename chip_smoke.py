"""Run the scan system's main path once on one NVIDIA GPU, and check it.

A Pfam-A one-tenth-scale deployment is made from ``--seed``: a .hmm of
2,000 profiles with Pfam-shaped core sizes (16..4096 nodes, the forced
1024/2048/4096 tail included) and 1,024 reads of 150-500 nt, of which 5%
are planted from a profile's consensus codons with a frameshift, 1% carry
an N and the rest are random ACGT.  The phases, each of which must pass:

  press    the CLI ``press`` of the .hmm into a .dtp
  timing   a warm ScanEngine.scan of all reads, kernel against XLA
           engine, warm-up (compile) seconds apart
  parity   the GPU kernel against the XLA engine on the card, every
           (read, profile) pair of all reads
  scan     the CLI ``scan`` into a products TSV; every planted read hits
           its source profile
  oracle   8 reads x 16 profiles (the 4096-node one included) against the
           f64 numpy oracle
  forward  the CLI ``scan --forward`` of 256 reads, and the same parity
  daemon   the worker against the in-process fake scheduler: a press job
           and a scan job, whose products equal the CLI scan's
  tests    the tests marked ``gpu``

It prints the card (JAX's device kind and count, nvidia-smi's name and
power limit) and, last, one JSON line {"ok": true, "device": {...}}.
Without a GPU, without the repository beside it, or when a phase fails,
it exits non-zero and prints no result.

  python chip_smoke.py [--seed N]
  python chip_smoke.py --four    # only the 4-GPU mesh path, vs card 0
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
NPROF = 2000
NREADS = 1024
NSUB = 256  # reads of the parity and forward phases
PLANTED, WITH_N = 0.05, 0.01
VITERBI_TOL = (1e-3, 1e-5)  # |d| <= atol + rtol * |score|: f32 add order
FORWARD_TOL = (1e-2, 0.0)  # logsumexp rounds on another path
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def check_close(name, got, want, tol) -> None:
    """Every pair within atol + rtol*|want|, or AssertionError."""
    atol, rtol = tol
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all(), name
    err = np.abs(got - want)
    bad = int((err > atol + rtol * np.abs(want)).sum())
    log(f"{name}: {got.size} pairs, max |d| {err.max():.3g} "
        f"(limit {atol:g} + {rtol:g}|s|), {bad} outside")
    assert bad == 0, f"{name}: {bad} pairs outside tolerance"


# -- the deployment ---------------------------------------------------------


def deployment(seed: int):
    """(core sizes, generator of the H3 profiles) of the database."""
    from deciphon_tpu.models.h3writer import pfam_like_core_sizes, random_h3

    sizes = pfam_like_core_sizes(np.random.default_rng(seed), NPROF)
    return sizes, (random_h3(seed * NPROF + i + 1, int(k), peak=0.9)
                   for i, k in enumerate(sizes))


def write_hmm(path: str, seed: int) -> np.ndarray:
    from deciphon_tpu.models.h3writer import write_h3

    sizes, profiles = deployment(seed)
    with open(path, "w") as fp:
        for h3 in profiles:
            write_h3(fp, h3)
    return sizes


def consensus_dna(prof) -> str:
    from deciphon_tpu.models.alphabet import STANDARD_CODE

    return "".join(
        STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
        for b in map(int, np.argmax(prof.match_codonp, axis=1))
    )


def make_reads(db, seed: int):
    """(reads, {read index: source profile}) — see the module docstring."""
    rng = np.random.default_rng(seed + 1)
    acgt = np.array(list("ACGT"))
    n_planted, n_n = int(PLANTED * NREADS), int(WITH_N * NREADS)
    sources = rng.choice(
        np.flatnonzero(db.core_sizes >= 50), n_planted, replace=False
    )
    reads = []
    for src in sources:
        cons = consensus_dna(db.profile(int(src)))
        L = min(int(rng.integers(150, 501)), len(cons))
        start = 3 * int(rng.integers(0, (len(cons) - L) // 3 + 1))
        read = cons[start : start + L]
        cut = int(rng.integers(L // 3, 2 * L // 3))  # one-nt deletion
        reads.append(read[:cut] + read[cut + 1 :])
    for _ in range(NREADS - n_planted):
        reads.append("".join(rng.choice(acgt, int(rng.integers(150, 501)))))
    for i in range(n_planted, n_planted + n_n):  # N into random reads
        r = list(reads[i])
        for j in rng.choice(len(r), int(rng.integers(1, 4)), replace=False):
            r[j] = "N"
        reads[i] = "".join(r)
    order = rng.permutation(NREADS)
    reads = [reads[i] for i in order]
    where = {int(o): i for i, o in enumerate(order)}
    planted = {where[i]: int(s) for i, s in enumerate(sources)}
    return reads, planted


def write_fasta(path: str, reads) -> None:
    with open(path, "w") as fp:
        for i, r in enumerate(reads):
            fp.write(f">r{i}\n{r}\n")


def read_prods(path_or_text: str, is_text: bool = False):
    """Product rows without the scan id column, in file order."""
    text = path_or_text if is_text else open(path_or_text).read()
    return [tuple(line.split("\t")[1:]) for line in text.splitlines()[1:]
            if line]


def records(reads):
    from deciphon_tpu.ops.scan_engine import SeqRecord

    return [SeqRecord(i + 1, f"r{i}", r) for i, r in enumerate(reads)]


def cli(*argv) -> None:
    from deciphon_tpu.cli.main import main as cli_main

    rc = cli_main(list(argv))
    assert rc == 0, f"dcp {' '.join(argv)} exited {rc}"


def check_planted(rows, planted, db, nreads=NREADS) -> None:
    hits = {(int(r[0]), r[1]) for r in rows}
    want = [(i + 1, db.profile(s).accession)
            for i, s in planted.items() if i < nreads]
    missing = [w for w in want if w not in hits]
    log(f"planted reads hitting their source: {len(want) - len(missing)}"
        f"/{len(want)}; {len(rows)} product rows")
    assert not missing, f"planted reads without their hit: {missing[:5]}"


# -- phases -------------------------------------------------------------------


def single_card(args, work: str, device: dict) -> None:
    from deciphon_tpu.db.format import TensorDB
    from deciphon_tpu.ops import viterbi_ref as vr
    from deciphon_tpu.models.alphabet import encode_extended
    from deciphon_tpu.ops.scan_engine import ScanEngine, ScanParams

    hmm, dtp = os.path.join(work, "chip.hmm"), os.path.join(work, "chip.dtp")
    sizes = write_hmm(hmm, args.seed)
    log(f"wrote {NPROF} profiles, {int(sizes.sum())} core nodes "
        f"(median {int(np.median(sizes))}, max {int(sizes.max())})")
    cli("press", hmm, "-o", dtp)
    db = TensorDB.load(dtp)
    log("press: done")
    reads, planted = make_reads(db, args.seed)

    # The kernel engine: warm-up (compile, tables, one dispatch of every
    # block at slen 1), every pair's scores (the parity data; compiles
    # the N class), one scan that compiles the traceback, then the timed
    # warm scans.  The XLA engine runs every read to the length tier even
    # in its warm-up, so its first pass (compile + one pass, scores()) is
    # its warm-up, then one timed scan.
    recs = records(reads)
    maxlen = max(len(r) for r in reads)
    timing, scores = {}, {}
    for name, reps in (("kernel", 3), ("xla", 1)):
        eng = ScanEngine(db, ScanParams(), backend=name)
        t = time.perf_counter()
        if name == "kernel":
            eng.warmup(NREADS, maxlen)
            compile_s = time.perf_counter() - t
            scores[name] = eng.scores(recs)
            eng.scan(recs)
        else:
            scores[name] = eng.scores(recs)
            compile_s = time.perf_counter() - t
        warm = []
        for _ in range(reps):
            t = time.perf_counter()
            hits = eng.scan(recs)
            warm.append(time.perf_counter() - t)
        timing[name] = (compile_s, min(warm), len(hits))
        log(f"timing {name}: warm-up {compile_s:.2f}s, warm scan "
            f"{min(warm):.3f}s (runs {[round(w, 3) for w in warm]}), "
            f"{len(hits)} hits, padding efficiency "
            f"{eng._counters.padding_efficiency:.3f}")
        del eng
        gc.collect()
    assert timing["kernel"][2] == timing["xla"][2]
    log(f"timing: warm scan of {NREADS} reads x {NPROF} profiles, kernel "
        f"{timing['kernel'][1]:.3f}s vs XLA engine {timing['xla'][1]:.3f}s "
        f"= {timing['xla'][1] / timing['kernel'][1]:.1f}x on {device['kind']}")
    (ka, kn), (xa, xn) = scores["kernel"], scores["xla"]
    check_close("parity viterbi alt", ka, xa, VITERBI_TOL)
    check_close("parity viterbi null", kn, xn, VITERBI_TOL)

    fasta, prods = os.path.join(work, "reads.fa"), os.path.join(work, "p.tsv")
    write_fasta(fasta, reads)
    cli("scan", dtp, fasta, "-o", prods)
    cli_rows = read_prods(prods)
    check_planted(cli_rows, planted, db)

    # 8 reads: two planted ones and an N read among them; 16 profiles:
    # the widest, the two planted reads' sources, 13 drawn at random
    rng = np.random.default_rng(args.seed + 2)
    sub_planted = [i for i in sorted(planted) if i < NSUB][:2]
    with_n = [i for i in range(NSUB) if "N" in reads[i]][:1]
    rest = [i for i in range(NSUB) if i not in sub_planted + with_n]
    pick = sub_planted + with_n + [
        int(i) for i in rng.choice(rest, 8 - len(sub_planted) - len(with_n),
                                   replace=False)]
    profs = [int(np.argmax(db.core_sizes))]
    profs += [planted[i] for i in sub_planted if planted[i] not in profs]
    others = np.setdiff1d(np.arange(NPROF), profs)
    profs += [int(p) for p in rng.choice(others, 16 - len(profs),
                                         replace=False)]
    oa, on = np.zeros((8, 16)), np.zeros((8, 16))
    for a, i in enumerate(pick):
        enc, codes = encode_extended(reads[i])
        for b, p in enumerate(profs):
            prof = db.profile(p)
            oa[a, b] = vr.viterbi_alt(prof, enc, codes=codes).loglik
            on[a, b] = vr.viterbi_null(prof, enc, codes=codes).loglik
    check_close("oracle alt", ka[np.ix_(pick, profs)], oa, VITERBI_TOL)
    check_close("oracle null", kn[np.ix_(pick, profs)], on, VITERBI_TOL)

    sub_fa, sub_prods = os.path.join(work, "sub.fa"), os.path.join(work, "f.tsv")
    write_fasta(sub_fa, reads[:NSUB])
    cli("scan", dtp, sub_fa, "-o", sub_prods, "--forward")
    check_planted(read_prods(sub_prods), planted, db, NSUB)
    fwd = ScanParams(algo="forward")
    fa, fn = ScanEngine(db, fwd, backend="kernel").scores(recs[:NSUB])
    ga, gn = ScanEngine(db, fwd, backend="xla").scores(recs[:NSUB])
    check_close("forward alt", fa, ga, FORWARD_TOL)
    check_close("forward null", fn, gn, FORWARD_TOL)
    gc.collect()

    daemon_rows = run_daemon(work, hmm, reads, press=True)
    assert daemon_rows == cli_rows, "daemon products differ from the CLI's"
    log(f"daemon: press + scan jobs done, {len(daemon_rows)} rows equal "
        "the CLI scan's")
    run_gpu_tests()


def run_daemon(work: str, hmm: str | None, reads, press: bool,
               dtp: str | None = None):
    """Products of one scan job run by the worker against the in-process
    fake scheduler (after a press job of ``hmm`` when ``press``)."""
    from deciphon_tpu.server.api import SchedAPI
    from deciphon_tpu.server.daemon import Server
    from deciphon_tpu.server.fake_sched import FakeScheduler
    from deciphon_tpu.utils.config import ServerConfig

    fake = FakeScheduler(spool_dir=os.path.join(work, "spool"))
    url = fake.serve()
    try:
        worker = Server(
            ServerConfig(cache_dir=os.path.join(work, "cache"), api_url=url,
                         single_run=True),
            SchedAPI(url),
        )
        if press:
            with open(hmm, "rb") as fp:
                job = fake.add_hmm("chip.hmm", fp.read()).job_id
            assert worker.run_one()
            assert fake.jobs[job].state == "done", fake.jobs[job].error
            db_meta = next(iter(fake.dbs.values()))
        else:
            with open(dtp, "rb") as fp:
                db_meta = fake.add_db("chip.dtp", fp.read())
        scan = fake.add_scan(db_meta.id,
                             [(f"r{i}", r) for i, r in enumerate(reads)])
        assert worker.run_one()
        assert fake.jobs[scan.job_id].state == "done", \
            fake.jobs[scan.job_id].error
        warm = getattr(worker, "_prewarm_thread", None)
        if warm is not None:
            warm.join()
        return read_prods(fake.products[-1], is_text=True)
    finally:
        fake.shutdown()


def run_gpu_tests() -> None:
    import pytest

    class Count:
        passed = skipped = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.skipped:
                self.skipped += 1
            elif report.failed:
                self.failed += 1
            elif report.when == "call":
                self.passed += 1

    count = Count()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests", "test_viterbi_gpu.py")],
        plugins=[count],
    )
    log(f"tests marked gpu: {count.passed} passed, {count.skipped} "
        f"skipped, {count.failed} failed")
    assert rc == 0 and count.passed and not count.skipped, "gpu tests"


def four_cards(args, work: str, device: dict) -> None:
    """The multi-device path alone: the mesh ScanEngine and the daemon's
    own mesh scan over 4 GPUs, against one engine on card 0."""
    from deciphon_tpu.db.format import TensorDB, write_db
    from deciphon_tpu.models.h3reader import build_profile
    from deciphon_tpu.ops.scan_engine import ScanEngine, ScanParams
    from deciphon_tpu.parallel.mesh import make_scan_mesh
    from deciphon_tpu.server.prod import ProdWriter

    assert device["count"] == 4, f"--four needs 4 GPUs, found {device}"
    # the same profiles, built without the .hmm text round trip
    dtp = os.path.join(work, "chip.dtp")
    write_db(dtp, (build_profile(h3) for h3 in deployment(args.seed)[1]))
    db = TensorDB.load(dtp)
    reads, planted = make_reads(db, args.seed)
    recs = records(reads)

    def rows(hits):
        w = ProdWriter(scan_id=0)
        for h in hits:
            w.add(h.seq_id, h.accession, h.alt_loglik, h.null_loglik,
                  h.match)
        return read_prods(w.render(), is_text=True)

    single = ScanEngine(db, ScanParams())
    a1, n1 = single.scores(recs)
    rows1 = rows(single.scan(recs))
    check_planted(rows1, planted, db)
    log(f"card 0: {len(rows1)} product rows")
    del single
    gc.collect()
    for paxis in (None, 2):
        mesh = make_scan_mesh(profile_axis=paxis)
        eng = ScanEngine(db, ScanParams(), mesh=mesh)
        a4, n4 = eng.scores(recs)
        label = f"mesh {mesh.shape['seqs']}x{mesh.shape['profiles']}"
        check_close(f"{label} alt", a4, a1, (0.0, 0.0))
        check_close(f"{label} null", n4, n1, (0.0, 0.0))
        assert rows(eng.scan(recs)) == rows1, f"{label} products differ"
        log(f"{label} (seqs x profiles): products equal card 0's")
        del eng
        gc.collect()
    assert run_daemon(work, None, reads, press=False, dtp=dtp) == rows1
    log("daemon mesh scan: products equal card 0's")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU mesh path and its comparison")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    try:
        from deciphon_tpu.utils import gpu, jaxcache
    except ImportError as exc:
        print(f"chip_smoke: the repository is not beside this file: {exc}",
              file=sys.stderr)
        return 2
    device = gpu.require_gpu()
    card = gpu.card_info()
    log(f"device: {device['kind']} x{device['count']} ({device['platform']})")
    log(f"card: {card}")
    jaxcache.enable()
    scratch = os.path.join(ROOT, "build")  # git-ignored
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as work:
        (four_cards if args.four else single_card)(args, work, device)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
