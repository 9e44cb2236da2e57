"""Device-side fragment-table synthesis vs the host f64 path.

ops/tables.synth_fragment_tables must reproduce models/frame.fragment_table
(the host dgemm that replaces imm's press-time per-state table precompute,
reference src/model/protein_model.c:247-254) up to f32 rounding, in base 4
and base 5, and ops/tables.device_profile_block must build the same block
as the host viterbi_jax.build_profile_block.
"""

import numpy as np
import pytest

from deciphon_tpu.models import frame
from deciphon_tpu.models.profile import sample_profile
from deciphon_tpu.ops import viterbi_jax as vj
from deciphon_tpu.ops.tables import synth_fragment_tables


def _rand_state(rng):
    """Random (marg125_log, q5_log) pair for one frame state."""
    codonp = rng.dirichlet(np.ones(64))
    lcodon = np.log(codonp)
    marg = frame.codon_marg(lcodon)
    q = frame.q5_pad(frame.nuclt_lprob_from_codon(lcodon))
    return marg, q


@pytest.mark.parametrize("base", [4, 5])
@pytest.mark.parametrize("eps", [0.01, 0.1])
def test_synth_matches_host_tables(eps, base):
    rng = np.random.default_rng(0)
    margs, qs = zip(*[_rand_state(rng) for _ in range(6)])
    marg = np.stack(margs)
    q = np.stack(qs)
    host = frame.fragment_table(marg, q, eps, base)  # [6, NTAB] f64
    dev = np.asarray(
        synth_fragment_tables(
            np.exp(marg).astype(np.float32),
            np.exp(q).astype(np.float32),
            eps=eps,
            row_chunk=8,
            base=base,
        )
    )
    assert dev.shape == host.shape
    # -inf rows clamp to NEG on device
    finite = np.isfinite(host)
    np.testing.assert_allclose(dev[finite], host[finite], atol=2e-5)
    assert np.all(dev[~finite] <= vj.NEG / 2)


@pytest.mark.parametrize("codes", [(), ("N",), ("R",)])
def test_device_block_matches_host_block(tmp_path, codes):
    from deciphon_tpu.db.format import TensorDB, write_db
    from deciphon_tpu.ops.tables import device_profile_block

    profiles = [sample_profile(s + 1, (s % 5) + 2) for s in range(10)]
    write_db(str(tmp_path / "t.dtp"), profiles)
    db = TensorDB.load(str(tmp_path / "t.dtp"))
    idxs = np.array([7, 2, 5])
    host = vj.build_profile_block(
        [db.profile(int(i)) for i in idxs], kpad=32, codes=codes
    )
    dev = device_profile_block(db, idxs, 32, codes)
    for name, h, d in zip(vj.ProfileBlock._fields, host, dev):
        d = np.asarray(d)
        assert d.shape == h.shape, name
        live = h > vj.NEG / 2
        np.testing.assert_allclose(d[live], h[live], atol=2e-5, err_msg=name)
        assert np.all(d[~live] <= vj.NEG / 2), name
