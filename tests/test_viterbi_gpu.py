"""The GPU scoring kernel (ops/viterbi_gpu.py) against the XLA engine.

Here the kernel runs through the Pallas interpreter and is lowered, not
compiled, for CUDA.  Tests marked ``gpu`` compile and run it on the card;
they skip on a machine without one (run them with ``python chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deciphon_tpu.db.partition import pad_core_size
from deciphon_tpu.models.alphabet import DNA, encode_iupac
from deciphon_tpu.models.profile import sample_profile
from deciphon_tpu.ops import viterbi_gpu as vg
from deciphon_tpu.ops import viterbi_jax as vj
from deciphon_tpu.ops.emissions import fragment_indices


def _case(cores, nseqs, lo, hi, base=4, seed=0):
    """(ProfileBlock at the kernel's padded width, eidx, slen) for random
    reads of lo..hi nt, longest first; base 5 plants N symbols."""
    rng = np.random.default_rng(seed)
    profs = [sample_profile(s + 1, k) for s, k in enumerate(cores)]
    block = vj.build_profile_block(
        profs, kpad=pad_core_size(max(cores)), base=base
    )
    alphabet = list("ACGT") + (["N"] if base == 5 else [])
    seqs = [
        "".join(rng.choice(alphabet, int(rng.integers(lo, hi + 1))))
        for _ in range(nseqs)
    ]
    seqs.sort(key=len, reverse=True)
    lp = max(len(s) for s in seqs)
    encode = encode_iupac if base == 5 else DNA.encode
    eidx = np.stack([
        vj.end_fragment_indices(
            fragment_indices(encode(s), pad_to=lp, base=base), base=base
        )
        for s in seqs
    ])
    slen = np.array([len(s) for s in seqs], np.int32)
    return block, eidx, slen


def _check(block, eidx, slen, tol=1e-3, **kw):
    ref = vj.viterbi_scores(
        vj.ProfileBlock(*map(jnp.asarray, block)), eidx, slen, **kw
    )
    got = vg.viterbi_scores(
        vg.prepare_block(block), eidx, slen, interpret=True, **kw
    )
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape == (len(slen), block.fm.shape[0])
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, r, atol=tol, rtol=1e-5)


@pytest.mark.parametrize("hmmer3_compat", [False, True])
@pytest.mark.parametrize("multi_hits", [True, False])
@pytest.mark.parametrize("semiring", ["max", "logsumexp"])
def test_kernel_matches_xla_flags(semiring, multi_hits, hmmer3_compat):
    block, eidx, slen = _case([5, 11, 17, 30], nseqs=6, lo=6, hi=40)
    _check(block, eidx, slen, semiring=semiring, multi_hits=multi_hits,
           hmmer3_compat=hmmer3_compat)


@pytest.mark.parametrize("base", [4, 5])
@pytest.mark.parametrize(
    "cores",
    [[2, 3], [31, 7], [33, 20], [100, 64, 90], [600, 300], [4096]],
    ids=["tiny", "non-pow2", "past-32", "k128", "k1024", "k4096"],
)
def test_kernel_matches_xla_cores(cores, base):
    # more reads than one tile of R reads holds, of mixed lengths, so
    # tiles run to different lengths
    nseqs = 2 * vg.reads_per_program(pad_core_size(max(cores)), 64) + 3
    nseqs = min(nseqs, 40)
    block, eidx, slen = _case(cores, nseqs=nseqs, lo=5, hi=70, base=base)
    _check(block, eidx, slen)


def test_reads_per_program():
    # R * K holds the ring at ELEMS cells; R is a power of two
    assert vg.reads_per_program(32, 1000) == vg.ELEMS // 32
    assert vg.reads_per_program(4096, 1000) == 1
    assert vg.reads_per_program(32, 3) == 4  # no more than the batch needs
    for k in (32, 64, 256, 1024, 4096):
        for s in (1, 5, 64, 1024):
            r = vg.reads_per_program(k, s)
            assert r & (r - 1) == 0 and r * k <= max(vg.ELEMS, k)


def test_padding_reads_do_not_leak():
    """A batch that is not a multiple of R pads with dead reads; the real
    rows equal the same reads scored in a full batch."""
    block, eidx, slen = _case([20, 9], nseqs=9, lo=10, hi=30)
    gb = vg.prepare_block(block)
    full = np.asarray(vg.viterbi_scores(gb, eidx, slen, interpret=True)[0])
    part = np.asarray(
        vg.viterbi_scores(gb, eidx[:5], slen[:5], interpret=True)[0]
    )
    assert part.shape == (5, 2)
    np.testing.assert_array_equal(part, full[:5])


def test_prepare_block_layout():
    block, _, _ = _case([20, 9], nseqs=1, lo=5, hi=5)
    gb = vg.prepare_block(block)
    B, K, NT = block.fm.shape
    assert (gb.nprofiles, gb.kpad, gb.ntab) == (B, K, NT)
    np.testing.assert_array_equal(gb.fm, np.transpose(block.fm, (0, 2, 1)))
    tr = {n: np.asarray(gb.tr[:, i]) for i, n in enumerate(vg.TR_ROWS)}
    np.testing.assert_array_equal(tr["mm_s"][:, :-1], block.mm_in[:, 1:])
    np.testing.assert_array_equal(tr["dm_ss"][:, :-2], block.dm_in[:, 2:])
    assert np.all(tr["dm_ss"][:, -2:] == vg.NEG)
    np.testing.assert_array_equal(tr["entry"], block.entry)


def test_non_pow2_width_rejected():
    block, eidx, slen = _case([20], nseqs=2, lo=5, hi=9)
    gb = vg.prepare_block(vj.build_profile_block(
        [sample_profile(1, 20)], kpad=48))
    with pytest.raises(ValueError):
        vg.viterbi_scores(gb, eidx, slen, interpret=True)


@pytest.mark.parametrize("semiring", ["max", "logsumexp"])
@pytest.mark.parametrize("K", [32, 4096])
def test_kernel_lowers_for_cuda(K, semiring):
    """The kernel lowers through the Triton route for a CUDA device (the
    D-chain scans included), here on a machine without one."""
    B, S, Lp, NT = 3, 64, 128, 1365
    f32 = jnp.float32
    gb = vg.GpuBlock(
        jax.ShapeDtypeStruct((B, NT, K), f32),
        jax.ShapeDtypeStruct((B, NT), f32),
        jax.ShapeDtypeStruct((B, NT), f32),
        jax.ShapeDtypeStruct((B, len(vg.TR_ROWS), K), f32),
    )
    low = vg.viterbi_scores.trace(
        gb, jax.ShapeDtypeStruct((S, Lp, 5), jnp.int32),
        jax.ShapeDtypeStruct((S,), jnp.int32), semiring=semiring,
    ).lower(lowering_platforms=("cuda",))
    text = low.as_text()
    assert "__gpu$xla.gpu.triton" in text or "triton" in text


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run python chip_smoke.py on one")


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", ["max", "logsumexp"])
@pytest.mark.parametrize("kpad", [32, 256, 1024, 4096])
def test_kernel_on_card(gpu, kpad, semiring):
    """Compiled for the card at every core tier, against the XLA engine
    on the same card: Viterbi to f32 add-order rounding, forward to its
    logsumexp rounding."""
    cores = [kpad // 2 + 1, kpad]
    block, eidx, slen = _case(cores, nseqs=96, lo=150, hi=500)
    tol = 1e-3 if semiring == "max" else 1e-2
    ref = vj.viterbi_scores(
        vj.ProfileBlock(*map(jnp.asarray, block)), eidx, slen,
        semiring=semiring,
    )
    got = vg.viterbi_scores(vg.prepare_block(block), eidx, slen,
                            semiring=semiring)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   atol=tol, rtol=1e-5)
