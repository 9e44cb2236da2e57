"""Sharded scan on the virtual 8-device CPU mesh == single-device scan."""

import jax
import numpy as np
import pytest

from deciphon_tpu.models.alphabet import DNA
from deciphon_tpu.models.profile import sample_profile
from deciphon_tpu.ops import viterbi_jax as vj
from deciphon_tpu.ops.emissions import fragment_indices
from deciphon_tpu.parallel.mesh import make_scan_mesh
from deciphon_tpu.parallel.sharded_scan import (
    shard_block,
    shard_seqs,
    sharded_scan_step,
)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    profiles = [sample_profile(s, int(rng.integers(2, 5))) for s in range(8)]
    block = vj.build_profile_block(profiles)
    seqs = ["".join(rng.choice(list("ACGT"), rng.integers(6, 14))) for _ in range(8)]
    lp = 16
    eidx = np.stack(
        [
            vj.end_fragment_indices(fragment_indices(DNA.encode(s), pad_to=lp))
            for s in seqs
        ]
    )
    slen = np.array([len(s) for s in seqs], np.int32)
    return block, eidx, slen


def test_mesh_shapes():
    assert len(jax.devices()) == 8
    mesh = make_scan_mesh()
    assert mesh.shape["seqs"] * mesh.shape["profiles"] == 8
    mesh = make_scan_mesh(profile_axis=2)
    assert mesh.shape == {"seqs": 4, "profiles": 2}
    with pytest.raises(ValueError):
        make_scan_mesh(profile_axis=3, seq_axis=3)


@pytest.mark.parametrize("paxis", [1, 2, 4])
def test_sharded_matches_single_device(data, paxis):
    block, eidx, slen = data
    ref_alt, ref_null = vj.viterbi_scores(block, eidx, slen)
    ref_alt = np.asarray(ref_alt)
    ref_null = np.asarray(ref_null)

    mesh = make_scan_mesh(profile_axis=paxis)
    sblock = shard_block(mesh, block)
    seidx, sslen = shard_seqs(mesh, eidx, slen)
    alt, null, lrt, best, arg = sharded_scan_step(mesh, sblock, seidx, sslen)
    np.testing.assert_allclose(np.asarray(alt), ref_alt, atol=1e-5)
    np.testing.assert_allclose(np.asarray(null), ref_null, atol=1e-5)

    ref_lrt = -2.0 * (ref_null - ref_alt)
    np.testing.assert_allclose(np.asarray(lrt), ref_lrt, atol=1e-5)
    np.testing.assert_allclose(np.asarray(best), ref_lrt.max(1), atol=1e-5)
    assert np.array_equal(np.asarray(arg), ref_lrt.argmax(1))


# ---------------------------------------------------------------------------
# Production sharded ScanEngine (each backend under shard_map)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scan_db(tmp_path_factory):
    from deciphon_tpu.db.format import TensorDB, write_db

    rng = np.random.default_rng(11)
    path = str(tmp_path_factory.mktemp("db") / "mini.dtp")
    write_db(
        path,
        [sample_profile(s + 1, int(rng.integers(2, 12))) for s in range(10)],
    )
    seqs = [
        "".join(rng.choice(list("ACGT"), int(rng.integers(20, 60))))
        for _ in range(7)
    ]
    return TensorDB.load(path), seqs


def _hits(engine, seqs):
    from deciphon_tpu.ops.scan_engine import SeqRecord

    return engine.scan(
        [SeqRecord(i, f"s{i}", s) for i, s in enumerate(seqs)]
    )


@pytest.mark.parametrize("kernel", [True, False])
def test_sharded_scan_engine_matches_single(scan_db, kernel):
    """The production mesh mode extracts the SAME full hit list (every
    LRT-passing (seq, profile) pair) with the same match strings as the
    single-device engine — the scan-semantics bar of scan_thread.c:121-129
    + prod.c:106-145."""
    from deciphon_tpu.ops.scan_engine import ScanEngine, ScanParams

    db, seqs = scan_db
    params = ScanParams(lrt_threshold=-1e9)  # keep every pair
    mesh = make_scan_mesh(profile_axis=4, seq_axis=2)
    backend = "kernel" if kernel else "xla"
    sharded = ScanEngine(
        db, params, mesh=mesh, backend=backend, interpret=kernel,
    )
    single = ScanEngine(db, params, backend=backend, interpret=kernel)
    hs, h1 = _hits(sharded, seqs), _hits(single, seqs)
    assert len(hs) == len(h1) == len(seqs) * db.nprofiles
    for a, b in zip(hs, h1):
        assert (a.seq_idx, a.profile_idx) == (b.seq_idx, b.profile_idx)
        assert a.alt_loglik == pytest.approx(b.alt_loglik, abs=1e-4)
        assert a.null_loglik == pytest.approx(b.null_loglik, abs=1e-4)
        assert a.match == b.match


def test_sharded_scan_engine_thresholded(scan_db):
    """Real-threshold parity: hit coordinates survive sharding exactly."""
    from deciphon_tpu.ops.scan_engine import ScanEngine, ScanParams

    db, seqs = scan_db
    params = ScanParams(lrt_threshold=10.0)
    mesh = make_scan_mesh(profile_axis=2, seq_axis=4)
    hs = _hits(ScanEngine(db, params, mesh=mesh, backend="xla"), seqs)
    h1 = _hits(ScanEngine(db, params, backend="xla"), seqs)
    assert [(h.seq_idx, h.profile_idx, h.match) for h in hs] == [
        (h.seq_idx, h.profile_idx, h.match) for h in h1
    ]


def test_mesh_warmup_covers_scan_variants(scan_db):
    """Mesh-path warmup must compile every variant the real scan will
    use: after warmup, scanning adds NO new entries to the sharded
    dispatch's jit cache."""
    from deciphon_tpu.ops import scan_engine as se
    from deciphon_tpu.ops.scan_engine import ScanEngine, ScanParams, SeqRecord

    db, seqs = scan_db
    mesh = make_scan_mesh(profile_axis=4, seq_axis=2)
    eng = ScanEngine(
        db, ScanParams(lrt_threshold=1e9), mesh=mesh,
        backend="kernel", interpret=True,
    )
    spent = eng.warmup(len(seqs), max(len(s) for s in seqs))
    assert spent > 0.0
    cached = se._score._cache_size()
    assert cached > 0
    eng.scan([SeqRecord(i, f"s{i}", s) for i, s in enumerate(seqs)])
    assert se._score._cache_size() == cached


def test_best_hits_sharded_equals_unsharded(scan_db):
    """best_hits on a mesh (argmax crossing profile shards as an XLA
    collective) returns the same per-read winners as single-device."""
    from deciphon_tpu.ops.scan_engine import ScanEngine, ScanParams, SeqRecord

    db, seqs = scan_db
    recs = [SeqRecord(i, f"s{i}", s) for i, s in enumerate(seqs)]
    params = ScanParams(lrt_threshold=-1e9)
    mesh = make_scan_mesh(profile_axis=4, seq_axis=2)
    bs = ScanEngine(db, params, mesh=mesh, backend="xla").best_hits(recs)
    b1 = ScanEngine(db, params, backend="xla").best_hits(recs)
    assert [(b.seq_id, b.profile_idx) for b in bs] == [
        (b.seq_id, b.profile_idx) for b in b1
    ]
    for a, b in zip(bs, b1):
        assert a.lrt == pytest.approx(b.lrt, abs=1e-4)
