"""End-to-end scan: press synthetic .hmm -> .dtp -> batched scan -> products."""

import numpy as np
import pytest

from deciphon_tpu.db.format import TensorDB, write_db
from deciphon_tpu.models import codec
from deciphon_tpu.models import state as st
from deciphon_tpu.models.alphabet import DNA, STANDARD_CODE
from deciphon_tpu.models.h3reader import press_file
from deciphon_tpu.models.h3writer import random_h3, write_h3
from deciphon_tpu.models.profile import sample_profile
from deciphon_tpu.ops import viterbi_ref as vr
from deciphon_tpu.ops.scan_engine import (
    Hit,
    ScanEngine,
    ScanParams,
    SeqRecord,
    pad_seq_len,
)
from deciphon_tpu.server.prod import HEADER, ProdWriter


def consensus_dna(prof, gc=STANDARD_CODE):
    """A DNA read spelling the profile's most likely codon per node."""
    out = []
    for k in range(prof.core_size):
        best = int(np.argmax(prof.match_codonp[k]))
        out.append(gc.codon_str(best // 16, (best // 4) % 4, best % 4))
    return "".join(out)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scan")
    hmm = tmp / "synth.hmm"
    with open(hmm, "w") as fp:
        write_h3(
            fp,
            [random_h3(s, k, peak=0.9) for s, k in [(1, 4), (2, 6), (3, 9)]],
        )
    dbp = str(tmp / "synth.dtp")
    write_db(dbp, press_file(str(hmm)))
    return TensorDB.load(dbp)


def test_pad_seq_len():
    # every read <= 64 shares one tier
    assert pad_seq_len(5) == 64
    assert pad_seq_len(64) == 64
    assert pad_seq_len(65) == 128
    # power-of-two tiers bound compile variants
    assert pad_seq_len(500) == 512
    assert pad_seq_len(1100) == 2048
    for L in range(1, 4000, 7):
        p = pad_seq_len(L)
        assert p >= L and p & (p - 1) == 0 and p < 2 * max(L, 64)


def test_scan_finds_planted_hit(db):
    """A read spelling a profile's consensus codons must hit that profile."""
    target = db.profile(2)  # core_size 9 -> 27nt read
    read = consensus_dna(target)
    seqs = [
        SeqRecord(1, "planted", read),
        SeqRecord(2, "random", "ACGTACGTACGTACGTACGTACGT"),
    ]
    eng = ScanEngine(db, ScanParams(lrt_threshold=10.0))
    hits = eng.scan(seqs)
    assert any(h.seq_id == 1 and h.profile_idx == 2 for h in hits)
    h = next(h for h in hits if h.seq_id == 1 and h.profile_idx == 2)
    # scores agree with the oracle
    ora = vr.viterbi_alt(target, DNA.encode(read))
    orn = vr.viterbi_null(target, DNA.encode(read))
    assert h.alt_loglik == pytest.approx(ora.loglik, abs=2e-3)
    assert h.null_loglik == pytest.approx(orn.loglik, abs=2e-3)
    assert h.lrt == pytest.approx(-2 * (orn.loglik - ora.loglik), abs=4e-3)
    # path covers the read, match string well-formed
    assert sum(l for _, l in h.path) == len(read)
    cells = h.match.split(";")
    assert len(cells) == len(h.path)
    frag_total = "".join(c.split(",")[0] for c in cells)
    assert frag_total == read
    # mute steps have empty codon/amino
    for cell, (sid, slen) in zip(cells, h.path):
        f, s, c, a = cell.split(",")
        assert s == st.name(sid)
        if st.is_mute(sid):
            assert c == "" and a == ""
        else:
            assert len(c) == 3 and len(a) == 1


def test_scan_pallas_path_matches_jax(db):
    """The GPU kernel (Pallas interpreter on CPU) agrees with the XLA
    engine through the full ScanEngine pipeline."""
    read = consensus_dna(db.profile(2))
    seqs = [
        SeqRecord(1, "planted", read),
        SeqRecord(2, "random", "ACGTACGTACGTACGTACGTACGT"),
    ]
    ref = ScanEngine(db, ScanParams(lrt_threshold=10.0)).scan(seqs)
    got = ScanEngine(
        db, ScanParams(lrt_threshold=10.0), backend="kernel", interpret=True,
    ).scan(seqs)
    assert [(h.seq_id, h.profile_idx) for h in got] == [
        (h.seq_id, h.profile_idx) for h in ref
    ]
    for a, b in zip(got, ref):
        assert a.alt_loglik == pytest.approx(b.alt_loglik, abs=1e-4)
        assert a.null_loglik == pytest.approx(b.null_loglik, abs=1e-4)
        assert a.match == b.match


def test_scan_threshold_filters(db):
    read = consensus_dna(db.profile(2))
    eng_hi = ScanEngine(db, ScanParams(lrt_threshold=1e9))
    assert eng_hi.scan([SeqRecord(1, "r", read)]) == []


def test_scan_rejects_non_iupac(db):
    eng = ScanEngine(db)
    with pytest.raises(ValueError):
        eng.scan([SeqRecord(1, "r", "ACGTZ")])


def test_scan_accepts_iupac_n(db):
    """Reads containing N scan instead of raising (reference accepts
    IUPAC-ambiguous reads via imm_dna_iupac, src/server/hmm.c:72-73).
    Planting N into a consensus read must still hit its profile, and
    the engine LRT must match the base-5 oracle exactly on that pair."""
    from deciphon_tpu.models.alphabet import encode_iupac

    target = db.profile(2)
    read = consensus_dna(target)
    noisy = read[:6] + "N" + read[7:12] + "N" + read[13:]
    eng = ScanEngine(db, ScanParams(lrt_threshold=10.0))
    hits = eng.scan([SeqRecord(1, "r", noisy), SeqRecord(2, "c", read)])
    by_seq = {(h.seq_id, h.profile_idx) for h in hits}
    assert (1, 2) in by_seq and (2, 2) in by_seq
    h = next(h for h in hits if h.seq_id == 1 and h.profile_idx == 2)
    enc = encode_iupac(noisy)
    ora = vr.viterbi_alt(target, enc, base=5)
    orn = vr.viterbi_null(target, enc, base=5)
    assert h.alt_loglik == pytest.approx(ora.loglik, abs=1e-3)
    assert h.null_loglik == pytest.approx(orn.loglik, abs=1e-3)
    assert h.path == ora.path
    # N carries less information than the concrete consensus symbol
    assert h.lrt < next(
        g.lrt for g in hits if g.seq_id == 2 and g.profile_idx == 2
    )


def test_iupac_n_is_exact_marginal(db):
    """Fragment-table N scores == logsumexp over the 4 concrete
    substitutions (the multilinearity identity the base-5 layout relies
    on), checked against the per-term reference implementation."""
    from deciphon_tpu.models import frame

    prof = db.profile(1)
    fm5 = frame.fragment_table(
        prof.match_marg, prof.match_q, prof.cfg.epsilon, base=5
    )
    fm4 = frame.fragment_table(
        prof.match_marg, prof.match_q, prof.cfg.epsilon, base=4
    )
    # fragment "A N G" (len 3): sum over x of p(A x G)
    concrete = [
        fm4[:, frame.frag_index(np.array([0, x, 2]))] for x in range(4)
    ]
    want = np.logaddexp.reduce(np.stack(concrete), axis=0)
    got = fm5[:, frame.frag_index(np.array([0, 4, 2]), base=5)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # all-N fragment of length 2 sums to the total length-2 mass
    allc = [
        fm4[:, frame.frag_index(np.array([x, y]))]
        for x in range(4)
        for y in range(4)
    ]
    want2 = np.logaddexp.reduce(np.stack(allc), axis=0)
    got2 = fm5[:, frame.frag_index(np.array([4, 4]), base=5)]
    np.testing.assert_allclose(got2, want2, rtol=1e-6)
    # term-loop implementation agrees with the GEMM form in base 5
    fm5_terms = frame.fragment_table_terms(
        prof.match_marg, prof.match_q, prof.cfg.epsilon, base=5
    )
    np.testing.assert_allclose(fm5, fm5_terms, rtol=1e-9, atol=1e-12)


def test_prod_writer_format(db, tmp_path):
    target = db.profile(0)
    read = consensus_dna(target)
    eng = ScanEngine(db, ScanParams(lrt_threshold=0.0))
    hits = eng.scan([SeqRecord(7, "r", read)])
    w = ProdWriter(scan_id=3)
    for h in hits:
        w.add(h.seq_id, h.accession, h.alt_loglik, h.null_loglik, h.match)
    out = tmp_path / "prods.tsv"
    w.write(str(out))
    text = out.read_text()
    lines = text.splitlines()
    assert lines[0] + "\n" == HEADER
    assert len(lines) == 1 + len(hits)
    cols = lines[1].split("\t")
    assert len(cols) == 9
    assert cols[0] == "3" and cols[1] == "7"
    assert cols[3] == "dna" and cols[6] == "protein"
    # %.17g floats round-trip exactly
    assert float(cols[4]) == hits[0].alt_loglik


def test_codec_decode_stream():
    prof = sample_profile(1, 3)
    seq = "ATGGCCATT"
    res = vr.viterbi_alt(prof, DNA.encode(seq))
    codons = codec.decode_codons(prof, DNA.encode(seq), res.path)
    emitting = [
        s for s, l in res.path if l > 0 and not st.is_mute(s)
    ]
    assert len(codons) == len(emitting)
    for a, b, c in codons:
        assert 0 <= a < 4 and 0 <= b < 4 and 0 <= c < 4


def test_long_read_scan(db):
    """A multi-kb read runs through the GPU kernel's position loop
    (Pallas interpreter here)."""
    import numpy as np

    rng = np.random.default_rng(5)
    target = db.profile(2)
    consensus = consensus_dna(target)

    def r(n):
        return "".join(rng.choice(list("ACGT"), n))

    # three planted islands (multi-hit) so the signal survives ~3 kb of
    # random flanks (oracle LRT ~ 38)
    long_read = (
        r(1200) + consensus + r(800) + consensus + r(700) + consensus
        + r(500)
    )
    eng = ScanEngine(db, ScanParams(lrt_threshold=10.0), backend="kernel",
                     interpret=True)
    hits = eng.scan([SeqRecord(1, "long", long_read)])
    assert any(h.profile_idx == 2 for h in hits)


def test_scan_partial_iupac_codes_exact(db):
    """Partially-degenerate codes (R/Y/...) score as EXACT nucleotide-
    subset marginals, not the N superset: the engine routes each code
    set through extended base-(4+D) tables and matches the oracle."""
    from deciphon_tpu.models.alphabet import encode_extended

    target = db.profile(2)
    read = consensus_dna(target)
    code = {"A": "R", "G": "R", "C": "Y", "T": "Y"}[read[6]]
    noisy = read[:6] + code + read[7:]
    eng = ScanEngine(db, ScanParams(lrt_threshold=10.0))
    hits = eng.scan(
        [
            SeqRecord(1, "r", noisy),
            SeqRecord(2, "n", read[:6] + "N" + read[7:]),
            SeqRecord(3, "c", read),
        ]
    )
    h = {h.seq_id: h for h in hits if h.profile_idx == 2}
    assert set(h) == {1, 2, 3}
    enc, codes = encode_extended(noisy)
    assert codes == (code,)
    ora = vr.viterbi_alt(target, enc, codes=codes)
    orn = vr.viterbi_null(target, enc, codes=codes)
    assert h[1].alt_loglik == pytest.approx(ora.loglik, abs=1e-3)
    assert h[1].null_loglik == pytest.approx(orn.loglik, abs=1e-3)
    assert h[1].path == ora.path
    # subset monotonicity: P(concrete) <= P(code subset) <= P(N)
    assert h[3].alt_loglik <= h[1].alt_loglik + 1e-3
    assert h[1].alt_loglik <= h[2].alt_loglik + 1e-3
    # the R read genuinely differs from its N collapse (exactness)
    assert abs(h[1].alt_loglik - h[2].alt_loglik) > 1e-4


def test_scan_mixed_codes_one_read(db):
    """A read holding two distinct codes classes as base-6 and scans."""
    target = db.profile(2)
    read = consensus_dna(target)
    noisy = read[:3] + "N" + read[4:9] + "R" + read[10:]
    eng = ScanEngine(db, ScanParams(lrt_threshold=10.0))
    hits = eng.scan([SeqRecord(1, "r", noisy)])
    assert any(h.profile_idx == 2 for h in hits)
    from deciphon_tpu.models.alphabet import encode_extended

    enc, codes = encode_extended(noisy)
    assert codes == ("N", "R")
    h = next(h for h in hits if h.profile_idx == 2)
    ora = vr.viterbi_alt(target, enc, codes=codes)
    assert h.alt_loglik == pytest.approx(ora.loglik, abs=1e-3)


def test_batched_traceback_matches_per_hit(db):
    """All-pairs traceback (permissive threshold) through the batched
    backpointer DP is IDENTICAL to the per-hit jitted DP, and scores
    match the f64 oracle (paths may differ from the oracle only on
    f32-vs-f64 ties between genuinely distinct candidates — the
    documented viterbi_trace tolerance)."""
    from deciphon_tpu.models.alphabet import DNA
    from deciphon_tpu.ops import viterbi_trace as vtr
    from deciphon_tpu.ops.scan_engine import pad_seq_len

    seqs = [
        SeqRecord(1, "a", consensus_dna(db.profile(2))),
        SeqRecord(2, "b", consensus_dna(db.profile(0))),
        SeqRecord(3, "c", "ACGTACGTACGTACGTACGT"),
    ]
    fast = ScanEngine(db, ScanParams(lrt_threshold=-1e9)).scan(seqs)
    slow = ScanEngine(
        db, ScanParams(lrt_threshold=-1e9), traceback="oracle"
    ).scan(seqs)
    assert len(fast) == len(slow) == len(seqs) * db.nprofiles
    for f, s in zip(fast, slow):
        assert (f.seq_idx, f.profile_idx) == (s.seq_idx, s.profile_idx)
        assert f.alt_loglik == pytest.approx(s.alt_loglik, abs=1e-4)
        enc = DNA.encode(seqs[f.seq_idx].data)
        per = vtr.viterbi_alt(
            db.profile(f.profile_idx), enc,
            pad_to=pad_seq_len(len(enc)),
        )
        assert f.path == per.path
        assert sum(l for _, l in f.path) == len(enc)


def test_best_hits_device_reduction(db):
    """best_hits reduces each block's score matrix to per-read argmax ON
    DEVICE and agrees with the full scan's top hit per read."""
    seqs = [
        SeqRecord(1, "a", consensus_dna(db.profile(2))),
        SeqRecord(2, "b", consensus_dna(db.profile(0))),
    ]
    eng = ScanEngine(db, ScanParams(lrt_threshold=-1e9))
    full = eng.scan(seqs)
    best = eng.best_hits(seqs)
    assert len(best) == 2
    for b in best:
        mine = [h for h in full if h.seq_id == b.seq_id]
        top = max(mine, key=lambda h: h.lrt)
        assert b.profile_idx == top.profile_idx
        assert b.lrt == pytest.approx(top.lrt, abs=1e-4)
    assert best[0].profile_idx == 2 and best[1].profile_idx == 0


def test_scan_iupac_on_pallas_path(db, monkeypatch):
    """IUPAC classes score on the GPU kernel over extended tables (base 5
    for N: 3906 rows), never on another engine."""
    from deciphon_tpu.ops import scan_engine as se

    built = []
    orig = se.KernelBackend.prepare

    def spy(self, block):
        built.append(block.fm.shape[-1])  # table height (ntab)
        return orig(self, block)

    monkeypatch.setattr(se.KernelBackend, "prepare", spy)
    monkeypatch.setattr(
        se.XlaBackend, "score",
        lambda *a, **k: pytest.fail("XLA engine used on the gpu backend"),
    )
    target = db.profile(2)
    read = consensus_dna(target)
    noisy = read[:6] + "N" + read[7:]
    eng = ScanEngine(db, ScanParams(lrt_threshold=10.0), backend="kernel",
                     interpret=True)
    hits = eng.scan([SeqRecord(1, "n", noisy), SeqRecord(2, "c", read)])
    h = {h.seq_id: h for h in hits if h.profile_idx == 2}
    assert set(h) == {1, 2}
    assert 3906 in built and 1365 in built
    from deciphon_tpu.models.alphabet import encode_extended

    enc, codes = encode_extended(noisy)
    ora = vr.viterbi_alt(target, enc, codes=codes)
    assert h[1].alt_loglik == pytest.approx(ora.loglik, abs=1e-3)


@pytest.fixture(scope="module")
def wide_db(tmp_path_factory):
    """Cores spanning several core-width tiers so the engine builds
    multiple blocks."""
    tmp = tmp_path_factory.mktemp("wide")
    hmm = tmp / "wide.hmm"
    with open(hmm, "w") as fp:
        write_h3(
            fp,
            [
                random_h3(s, k, peak=0.9)
                for s, k in enumerate([4, 6, 9, 20, 40, 70, 130, 200])
            ],
        )
    dbp = str(tmp / "wide.dtp")
    write_db(dbp, press_file(str(hmm)))
    return TensorDB.load(dbp)


@pytest.mark.parametrize("algo", ["viterbi", "forward"])
def test_wide_scan_kernel_matches_xla(wide_db, algo):
    """Over several core-width blocks, the GPU kernel's scan returns the
    XLA engine's hits: same pairs, same match strings, same scores."""
    reads = [consensus_dna(wide_db.profile(i)) for i in (2, 5, 7)]
    seqs = [SeqRecord(i, f"r{i}", r) for i, r in enumerate(reads)] + [
        SeqRecord(9, "rand", "ACGTACGTACGTACGTACGTACGTACG")
    ]
    params = ScanParams(lrt_threshold=10.0, algo=algo)
    kern = ScanEngine(wide_db, params, backend="kernel", interpret=True)
    assert len({b.kpad for b in kern._blocks}) >= 4
    got = kern.scan(seqs)
    ref = ScanEngine(wide_db, params, backend="xla").scan(seqs)
    assert len(got) >= 3
    assert [(h.seq_id, h.profile_idx, h.match) for h in got] == [
        (h.seq_id, h.profile_idx, h.match) for h in ref
    ]
    for a, b in zip(got, ref):
        assert a.alt_loglik == pytest.approx(b.alt_loglik, abs=1e-3)
        assert a.null_loglik == pytest.approx(b.null_loglik, abs=1e-3)


@pytest.mark.parametrize("backend", ["xla", "kernel"])
def test_warmup_covers_scan_variants(wide_db, backend):
    """After warmup, a scan of the warmed (nseqs, max_len) shape adds NO
    new entries to the dispatch's jit cache — the cold-start contract of
    the daemon's spool-overlapped prewarm — and warmup reports real
    seconds on every backend."""
    from deciphon_tpu.ops import scan_engine as se

    eng = ScanEngine(
        wide_db, ScanParams(lrt_threshold=1e9), backend=backend,
        interpret=backend == "kernel",
    )
    seqs = [
        SeqRecord(i, f"s{i}", consensus_dna(wide_db.profile(7))[: 60 + i])
        for i in range(5)
    ]
    spent = eng.warmup(len(seqs), max(len(s.data) for s in seqs))
    assert spent > 0.0
    cached = se._score._cache_size()
    assert cached > 0
    eng.scan(seqs)
    assert se._score._cache_size() == cached


def test_best_hits_kernel_matches_xla(wide_db):
    """best_hits on the GPU kernel returns the XLA engine's per-read
    winners."""
    reads = [consensus_dna(wide_db.profile(i)) for i in (2, 5, 7)] + [
        "ACGTACGTACGTACGTACGTACGTACG"
    ]
    seqs = [SeqRecord(i, f"r{i}", r) for i, r in enumerate(reads)]
    params = ScanParams(lrt_threshold=-1e9)
    got = ScanEngine(
        wide_db, params, backend="kernel", interpret=True
    ).best_hits(seqs)
    ref = ScanEngine(wide_db, params, backend="xla").best_hits(seqs)
    assert [(b.seq_id, b.profile_idx) for b in got] == [
        (b.seq_id, b.profile_idx) for b in ref
    ]
    for a, b in zip(got, ref):
        assert a.lrt == pytest.approx(b.lrt, abs=1e-4)
        assert a.alt_loglik == pytest.approx(b.alt_loglik, abs=1e-4)


def test_backend_selection():
    """The backend follows the platform; interpret mode is never
    inferred, and an unknown platform is an error."""
    from deciphon_tpu.ops import scan_engine as se

    assert se.make_backend() == se.XlaBackend()  # tests run on the CPU
    assert se.backend_name("gpu") == "kernel"
    assert se.backend_name("cpu") == "xla"
    assert se.make_backend("kernel") == se.KernelBackend(interpret=False)
    assert se.make_backend("kernel", interpret=True).interpret
    for bad in ("rocm", "metal", "neuron"):
        with pytest.raises(ValueError):
            se.backend_name(bad)
    for name, interpret in (("xla", True), ("pallas", False)):
        with pytest.raises(ValueError):
            se.make_backend(name, interpret=interpret)


def test_padding_accounting(wide_db):
    """Each backend reports the cells it dispatched: the XLA engine runs
    every read to the length tier, the kernel each read tile to its
    longest read; true cells never exceed dispatched cells."""
    from deciphon_tpu.ops import scan_engine as se

    seqs = [
        SeqRecord(i, f"s{i}", consensus_dna(wide_db.profile(7))[: 30 + 40 * i])
        for i in range(4)
    ]
    eff = {}
    for backend in ("xla", "kernel"):
        eng = ScanEngine(wide_db, ScanParams(lrt_threshold=1e9),
                         backend=backend, interpret=backend == "kernel")
        eng.scan(seqs)
        c = eng._counters
        assert 0 < c.cells <= c.dispatched
        eff[backend] = c.padding_efficiency
    assert eff["kernel"] > eff["xla"]
    lens = np.array([len(s.data) for s in seqs], np.int32)[::-1]
    slen = np.ones(se.pad_batch(len(seqs)), np.int32)
    slen[: len(lens)] = np.sort(lens)[::-1]
    R = 32  # 1024 // 32 nodes: all four reads share one tile
    assert se.KernelBackend().dispatched_cells(32, 2, slen, 256) == (
        3 * 2 * 32 * R * (int(slen[0]) + 1)
    )
