"""HMMER3 parse/write round-trip, press pipeline, and DB format."""

import io

import numpy as np
import pytest

from deciphon_tpu.db.format import TensorDB, write_db
from deciphon_tpu.db.partition import (
    balanced_partitions,
    bucket_by_core_size,
    pad_core_size,
)
from deciphon_tpu.models.h3reader import (
    build_profile,
    count_profiles,
    press_file,
    read_h3,
)
from deciphon_tpu.models.h3writer import random_h3, write_h3
from deciphon_tpu.models.profile import ProteinCfg
from deciphon_tpu.ops import viterbi_ref as vr
from deciphon_tpu.models.alphabet import DNA
from deciphon_tpu.utils.rc import DcpError


@pytest.fixture()
def hmm_file(tmp_path):
    p = tmp_path / "synth.hmm"
    profs = [random_h3(1, 3), random_h3(2, 5, name="second")]
    with open(p, "w") as fp:
        write_h3(fp, profs)
    return str(p), profs


def test_h3_roundtrip(hmm_file):
    path, originals = hmm_file
    parsed = list(read_h3(path))
    assert len(parsed) == 2
    for orig, got in zip(originals, parsed):
        assert got.name == orig.name
        assert got.accession == orig.accession
        assert got.length == orig.length
        assert np.allclose(got.match_lprobs, orig.match_lprobs, atol=1e-4)
        assert got.consensus == orig.consensus
        # -inf survives the '*' encoding
        assert np.isneginf(got.trans[0, 6])
        assert np.isneginf(got.trans[-1, 2])
        finite = np.isfinite(orig.trans)
        assert np.allclose(got.trans[finite], orig.trans[finite], atol=1e-4)


def test_count_profiles(hmm_file):
    path, _ = hmm_file
    assert count_profiles(path) == 2


def test_h3_rejects_garbage(tmp_path):
    p = tmp_path / "bad.hmm"
    p.write_text("NOT A PROFILE\n")
    with pytest.raises(DcpError):
        list(read_h3(str(p)))


def test_press_and_scan(hmm_file):
    """Press -> profile -> oracle scan end-to-end on a synthetic profile."""
    path, _ = hmm_file
    profiles = list(press_file(path))
    assert [p.core_size for p in profiles] == [3, 5]
    seq = DNA.encode("ATGGCCATTACGGCC")
    for p in profiles:
        ra = vr.viterbi_alt(p, seq)
        rn = vr.viterbi_null(p, seq)
        assert np.isfinite(ra.loglik) and np.isfinite(rn.loglik)
        assert sum(l for _, l in ra.path) == len(seq)


def test_db_roundtrip(tmp_path, hmm_file):
    path, _ = hmm_file
    profiles = list(press_file(path))
    dbp = str(tmp_path / "synth.dtp")
    n = write_db(dbp, profiles)
    assert n == 2
    db = TensorDB.load(dbp)
    assert db.nprofiles == 2
    assert db.header["profile_typeid"] == "protein"
    assert db.cfg.epsilon == pytest.approx(0.01)
    assert db.core_sizes.tolist() == [3, 5]
    seq = DNA.encode("ATGGCCATTACG")
    for i, orig in enumerate(profiles):
        got = db.profile(i)
        assert got.accession == orig.accession
        # f32 storage round-trip: scores match to f32 precision
        r0 = vr.viterbi_alt(orig, seq)
        r1 = vr.viterbi_alt(got, seq)
        assert r1.loglik == pytest.approx(r0.loglik, abs=2e-3)
        assert r1.path == r0.path
        # codon probs recovered from the marginal table
        assert np.allclose(
            got.match_codonp, orig.match_codonp, atol=1e-5
        )


def test_db_bad_magic(tmp_path):
    p = tmp_path / "bad.dtp"
    p.write_bytes(b"\x81\xa6header\x81\xa5magic\x01")
    with pytest.raises(DcpError):
        TensorDB.load(str(p))


def test_balanced_partitions():
    w = np.array([5, 1, 1, 1, 5, 1, 1, 1, 5, 3])
    parts = balanced_partitions(w, 3)
    assert len(parts) == 3
    assert [p.start for p in parts] == [0, parts[0].stop, parts[1].stop]
    assert parts[-1].stop == len(w)
    sums = [float(w[list(p)].sum()) for p in parts]
    assert max(sums) <= w.sum() / 3 + w.max()
    # degenerate cases
    assert len(balanced_partitions(np.ones(2), 64)) == 2
    assert len(balanced_partitions(np.ones(100), 1)) == 1


def test_buckets():
    assert pad_core_size(3) == 32
    assert pad_core_size(32) == 32
    assert pad_core_size(33) == 64
    assert pad_core_size(100) == 128
    assert pad_core_size(129) == 256
    assert pad_core_size(300) == 512
    assert pad_core_size(4096) == 4096
    b = bucket_by_core_size(np.array([3, 7, 100, 120, 300]))
    assert set(b) == {32, 128, 512}
    assert b[32].tolist() == [0, 1]
    assert b[128].tolist() == [2, 3]


@pytest.mark.parametrize("max_lanes", [None, 4096, 256])
def test_pack_blocks(max_lanes):
    from deciphon_tpu.db.partition import pack_blocks

    cores = np.array([19, 300, 150, 4096, 128, 90, 2048, 40, 100, 120])
    blocks = pack_blocks(cores, max_lanes=max_lanes)
    # every index exactly once
    all_idx = np.concatenate([idx for _, idx in blocks])
    assert sorted(all_idx.tolist()) == list(range(len(cores)))
    for kpad, idx in blocks:
        # one power-of-two tier per block, wide enough for every core
        assert kpad & (kpad - 1) == 0
        assert all(pad_core_size(int(k)) == kpad for k in cores[idx])
        if max_lanes is not None:
            assert len(idx) == 1 or len(idx) * kpad <= max_lanes
    if max_lanes is None:
        assert len(blocks) == len(bucket_by_core_size(cores))
