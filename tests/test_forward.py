"""Forward algorithm (logsumexp semiring): oracle, XLA engine, Pallas.

The reference (like imm) only runs Viterbi; forward is the BASELINE.md
north-star extension.  Validation ladder: exhaustive path enumeration ->
f64 numpy oracle -> f32 XLA engine -> GPU kernel (Pallas interpreter).
"""

import numpy as np
import pytest

from deciphon_tpu.models.alphabet import DNA
from deciphon_tpu.models.profile import sample_profile
from deciphon_tpu.ops import viterbi_jax as vj
from deciphon_tpu.ops import viterbi_ref as vr
from deciphon_tpu.ops.emissions import fragment_indices


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(5)
    profs = [sample_profile(s + 1, int(rng.integers(2, 4))) for s in range(3)]
    seqs = [
        "".join(rng.choice(list("ACGT"), int(rng.integers(3, 7))))
        for _ in range(3)
    ]
    return profs, seqs


def test_forward_oracle_matches_brute_force(tiny):
    """f64 DP forward == exhaustive logsumexp over every path."""
    profs, seqs = tiny
    for prof in profs:
        for s in seqs:
            enc = DNA.encode(s)
            want = vr.brute_force_forward(prof, enc)
            got = vr.forward_alt(prof, enc)
            assert got == pytest.approx(want, abs=1e-8), (prof.accession, s)


def test_forward_exceeds_viterbi(tiny):
    """Total path mass >= best path, strictly when >1 path exists."""
    profs, seqs = tiny
    for prof in profs:
        for s in seqs:
            enc = DNA.encode(s)
            vit = vr.viterbi_alt(prof, enc).loglik
            fwd = vr.forward_alt(prof, enc)
            assert fwd >= vit - 1e-9
            assert vr.forward_null(prof, enc) >= vr.viterbi_null(
                prof, enc
            ).loglik - 1e-9


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(9)
    profs = [sample_profile(s + 1, int(rng.integers(2, 9))) for s in range(6)]
    block = vj.build_profile_block(profs)
    seqs = [
        "".join(rng.choice(list("ACGT"), int(rng.integers(8, 24))))
        for _ in range(5)
    ]
    lp = 24
    eidx = np.stack(
        [
            vj.end_fragment_indices(fragment_indices(DNA.encode(s), pad_to=lp))
            for s in seqs
        ]
    )
    slen = np.array([len(s) for s in seqs], np.int32)
    return profs, seqs, block, eidx, slen


def test_forward_engine_matches_oracle(batch):
    profs, seqs, block, eidx, slen = batch
    alt, null = vj.forward_scores(block, eidx, slen)
    alt = np.asarray(alt)
    null = np.asarray(null)
    for si, s in enumerate(seqs):
        enc = DNA.encode(s)
        for bi, prof in enumerate(profs):
            assert alt[si, bi] == pytest.approx(
                vr.forward_alt(prof, enc), abs=2e-3
            )
            assert null[si, bi] == pytest.approx(
                vr.forward_null(prof, enc), abs=2e-3
            )


def test_forward_pallas_matches_engine(batch):
    """The GPU kernel (Pallas interpreter) under the logsumexp semiring
    agrees with the XLA engine's forward scores."""
    from deciphon_tpu.db.partition import pad_core_size
    from deciphon_tpu.ops import viterbi_gpu as vg

    profs, seqs, block, eidx, slen = batch
    ref_alt, ref_null = vj.forward_scores(block, eidx, slen)
    kpad = pad_core_size(max(p.core_size for p in profs))
    gblock = vg.prepare_block(vj.build_profile_block(profs, kpad=kpad))
    alt, null = vg.viterbi_scores(
        gblock, eidx, slen, interpret=True, semiring="logsumexp"
    )
    np.testing.assert_allclose(alt, np.asarray(ref_alt), atol=2e-3)
    np.testing.assert_allclose(null, np.asarray(ref_null), atol=2e-3)


# ---------------------------------------------------------------------------
# End-to-end: ScanEngine(algo="forward") and the CLI --forward flag
# (VERDICT r4 #3/#4: forward was a tested library function, not a
# user-facing capability).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fwd_db(tmp_path_factory):
    from deciphon_tpu.db.format import TensorDB, write_db
    from deciphon_tpu.models.h3reader import press_file
    from deciphon_tpu.models.h3writer import random_h3, write_h3

    tmp = tmp_path_factory.mktemp("fwd")
    hmm = tmp / "fwd.hmm"
    with open(hmm, "w") as fp:
        write_h3(
            fp,
            [random_h3(s, k, peak=0.9) for s, k in enumerate([5, 9, 14])],
        )
    dbp = str(tmp / "fwd.dtp")
    write_db(dbp, press_file(str(hmm)))
    return TensorDB.load(dbp), str(hmm), dbp


def _consensus(prof):
    from deciphon_tpu.models.alphabet import STANDARD_CODE

    return "".join(
        STANDARD_CODE.codon_str(b // 16, (b // 4) % 4, b % 4)
        for b in map(int, np.argmax(prof.match_codonp, 1))
    )


@pytest.mark.parametrize("pallas", [False, True])
def test_scan_engine_forward_matches_oracle(fwd_db, pallas):
    """ScanEngine(algo='forward') logliks == f64 forward oracle, on both
    the XLA engine and the GPU kernel (Pallas interpreter)."""
    from deciphon_tpu.models.alphabet import encode_extended
    from deciphon_tpu.ops.scan_engine import (
        ScanEngine, ScanParams, SeqRecord,
    )

    db, _, _ = fwd_db
    reads = [_consensus(db.profile(1)), "ACGTACGTACGTACGTACG"]
    seqs = [SeqRecord(i, f"r{i}", r) for i, r in enumerate(reads)]
    eng = ScanEngine(
        db, ScanParams(lrt_threshold=-1e9, algo="forward"),
        backend="kernel" if pallas else "xla", interpret=pallas,
    )
    hits = eng.scan(seqs)
    assert len(hits) == len(seqs) * db.nprofiles
    for h in hits:
        enc, _ = encode_extended(reads[h.seq_idx])
        prof = db.profile(h.profile_idx)
        assert h.alt_loglik == pytest.approx(
            vr.forward_alt(prof, enc), abs=2e-3
        )
        assert h.null_loglik == pytest.approx(
            vr.forward_null(prof, enc), abs=2e-3
        )
        # forward mass >= the Viterbi best path everywhere
        assert h.alt_loglik >= vr.viterbi_alt(prof, enc).loglik - 1e-3


def test_scan_forward_gate_and_match(fwd_db):
    """At the production threshold, forward mode still gates on LRT and
    decodes the (Viterbi) match string for survivors."""
    from deciphon_tpu.ops.scan_engine import (
        ScanEngine, ScanParams, SeqRecord,
    )

    db, _, _ = fwd_db
    read = _consensus(db.profile(2))
    hits = ScanEngine(
        db, ScanParams(lrt_threshold=10.0, algo="forward"),
        backend="xla",
    ).scan([SeqRecord(1, "c", read)])
    assert [h.profile_idx for h in hits] == [2]
    assert hits[0].match  # Viterbi-path match string present
    assert ",M1," in hits[0].match


def test_cli_forward_flag(fwd_db, tmp_path, capsys):
    """dcp-tpu scan --forward writes forward logliks to the product TSV."""
    from deciphon_tpu.cli.main import main
    from deciphon_tpu.models.alphabet import encode_extended

    db, _, dbp = fwd_db
    read = _consensus(db.profile(1))
    fasta = tmp_path / "r.fa"
    fasta.write_text(f">planted\n{read}\n")
    out = tmp_path / "fwd.tsv"
    rc = main(["scan", dbp, str(fasta), "-o", str(out), "--forward"])
    assert rc == 0
    rows = [
        l.split("\t") for l in out.read_text().splitlines()[1:] if l
    ]
    planted = [r for r in rows if r[2] == db.profile(1).accession]
    assert planted
    enc, _ = encode_extended(read)
    assert float(planted[0][4]) == pytest.approx(
        vr.forward_alt(db.profile(1), enc), abs=2e-3
    )
