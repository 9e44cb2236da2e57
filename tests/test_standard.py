"""Standard (typeid 1, generic single-emission) profile scan path.

The reference declares this kind (src/model/standard_profile.c,
src/model/profile_typeid.h:4-9) but never instantiates it from a db
(src/db/profile_reader.c:95-98); the rebuild implements it fully:
model, batched XLA Viterbi, LRT scan, and db round-trip.
"""

import itertools

import numpy as np
import pytest

from deciphon_tpu.models.alphabet import DNA
from deciphon_tpu.models.standard import (
    NEG,
    StandardProfile,
    loop_null,
    sample_standard,
)
from deciphon_tpu.ops.viterbi_standard import (
    build_standard_block,
    scan_standard,
    standard_viterbi_scores,
)


def brute_force_viterbi(start, trans, emis, end, seq):
    """Exhaustive best-path loglik over all state paths (tiny S, L)."""
    S = len(start)
    L = len(seq)
    best = -np.inf
    for path in itertools.product(range(S), repeat=L):
        ll = start[path[0]] + emis[path[0], seq[0]]
        for i in range(1, L):
            ll += trans[path[i - 1], path[i]] + emis[path[i], seq[i]]
        ll += end[path[-1]]
        best = max(best, ll)
    return best


def test_standard_viterbi_vs_brute_force():
    rng = np.random.default_rng(0)
    profiles = [sample_standard(s + 1, (s % 3) + 2) for s in range(4)]
    block = build_standard_block(profiles)
    reads = ["ACGT", "TTTAC", "G"]
    Lp = 5
    seqs = np.zeros((3, Lp), np.int32)
    lens = np.zeros(3, np.int32)
    for i, r in enumerate(reads):
        e = DNA.encode(r)
        seqs[i, : len(e)] = e
        lens[i] = len(e)
    alt, null = standard_viterbi_scores(block, seqs, lens)
    for q, r in enumerate(reads):
        e = DNA.encode(r)
        for b, p in enumerate(profiles):
            want = brute_force_viterbi(
                p.alt_start, p.alt_trans, p.alt_emis, p.alt_end, e
            )
            assert float(alt[q, b]) == pytest.approx(want, abs=1e-4)
            wantn = brute_force_viterbi(
                p.null_start, p.null_trans, p.null_emis, p.null_end, e
            )
            assert float(null[q, b]) == pytest.approx(wantn, abs=1e-4)


def test_standard_hand_computed():
    """2-state deterministic chain: loglik is the product along the only
    viable path."""
    emis = np.log(np.array([[0.9, 0.1 / 3, 0.1 / 3, 0.1 / 3],
                            [0.1 / 3, 0.9, 0.1 / 3, 0.1 / 3]]))
    trans = np.log(np.array([[0.2, 0.8], [0.8, 0.2]]))
    prof = StandardProfile(
        accession="HAND", abc=DNA,
        alt_start=np.log(np.array([1.0, 1e-30])),
        alt_trans=trans, alt_emis=emis,
        alt_end=np.zeros(2),
        null_start=np.zeros(1), null_trans=np.zeros((1, 1)),
        null_emis=np.log(np.full((1, 4), 0.25)), null_end=np.zeros(1),
    )
    block = build_standard_block([prof])
    seqs = np.array([[0, 1]], np.int32)  # "AC": path 0 -> 1
    alt, null = standard_viterbi_scores(block, seqs, np.array([2], np.int32))
    want = np.log(1.0) + np.log(0.9) + np.log(0.8) + np.log(0.9)
    assert float(alt[0, 0]) == pytest.approx(want, abs=1e-5)
    assert float(null[0, 0]) == pytest.approx(2 * np.log(0.25), abs=1e-5)


def test_standard_scan_and_db_roundtrip(tmp_path):
    from deciphon_tpu.db.standard_db import (
        load_standard_db,
        write_standard_db,
    )

    rng = np.random.default_rng(3)
    profiles = [sample_standard(s + 1, 3) for s in range(5)]
    # plant: make profile 2 love "AAAA..." strongly
    target = profiles[2]
    target.alt_emis[:] = np.log(np.array([0.97, 0.01, 0.01, 0.01]))[None, :]
    path = str(tmp_path / "std.dtp")
    assert write_standard_db(path, profiles) == 5
    loaded = load_standard_db(path)
    assert [p.accession for p in loaded] == [p.accession for p in profiles]
    np.testing.assert_allclose(loaded[2].alt_emis, target.alt_emis)
    hits = scan_standard(loaded, ["A" * 12, "CGTCGTCGTCGT"], lrt_threshold=5.0)
    assert any(q == 0 and b == 2 for q, b, *_ in hits)
    # state naming parity (standard_state.c:124-129)
    assert loaded[0].state_name(0) == "S0"
    assert loaded[0].state_name(12) == "S12"


def test_typeid_dispatch(tmp_path):
    """db/dispatch routes by header typeid without loading payloads
    (the reference's profile vtable at open time, profile_reader.c:95-98)."""
    from deciphon_tpu.db.dispatch import STANDARD, db_typeid, open_db
    from deciphon_tpu.db.format import TensorDB, write_db
    from deciphon_tpu.db.standard_db import write_standard_db
    from deciphon_tpu.models.profile import sample_profile
    from deciphon_tpu.utils.rc import DcpError

    std = str(tmp_path / "std.dtp")
    write_standard_db(std, [sample_standard(1, 3)])
    assert db_typeid(std) == STANDARD
    tid, profs = open_db(std)
    assert tid == STANDARD and profs[0].accession == "STD00001"

    prot = str(tmp_path / "prot.dtp")
    write_db(prot, [sample_profile(1, 3)])
    assert db_typeid(prot) == "protein"
    tid, db = open_db(prot)
    assert tid == "protein" and isinstance(db, TensorDB)

    junk = str(tmp_path / "junk.dtp")
    with open(junk, "wb") as fp:
        fp.write(b"\x00not msgpack")
    with pytest.raises(DcpError):
        db_typeid(junk)


def test_cli_scan_dispatches_standard(tmp_path, capsys):
    """CLI scan routes a typeid-1 db through the standard engine and
    writes 'standard' product rows."""
    from deciphon_tpu.cli.main import main
    from deciphon_tpu.db.standard_db import write_standard_db

    profiles = [sample_standard(s + 1, 3) for s in range(3)]
    profiles[1].alt_emis[:] = np.log(
        np.array([0.97, 0.01, 0.01, 0.01])
    )[None, :]
    db = str(tmp_path / "std.dtp")
    write_standard_db(db, profiles)
    fa = tmp_path / "reads.fa"
    fa.write_text(">r1\nAAAAAAAAAAAA\n>r2\nCGTCGTCGTCGT\n")
    out = str(tmp_path / "prods.tsv")
    rc = main(["scan", db, str(fa), "-o", out, "--lrt-threshold", "5.0"])
    assert rc == 0
    rows = open(out).read().splitlines()
    assert rows[0].startswith("scan_id\t")
    hit = [r for r in rows[1:] if "\tSTD00002\t" in r]
    assert hit and "\tstandard\t" in hit[0]
    # info dispatches too
    rc = main(["info", db])
    assert rc == 0
    cap = capsys.readouterr().out
    assert "type:       standard" in cap


def test_standard_db_rejects_wrong_type(tmp_path):
    from deciphon_tpu.utils import msgpack

    from deciphon_tpu.db.standard_db import load_standard_db
    from deciphon_tpu.utils.rc import DcpError

    bad = str(tmp_path / "bad.dtp")
    with open(bad, "wb") as fp:
        fp.write(
            msgpack.packb(
                {"header": {"magic_number": 0xC6F0, "profile_typeid": 2},
                 "profiles": []}
            )
        )
    with pytest.raises(DcpError):
        load_standard_db(bad)
