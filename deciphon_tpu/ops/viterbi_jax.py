"""Batched JAX Viterbi over tensorized protein profiles.

The scan-time hot path, expressed as a jit/vmap-friendly ``lax.scan`` over
sequence positions (static shapes, ring-buffered 5-position lookback).
Replaces the reference's per-(profile, seq) imm_dp_viterbi calls
(src/server/scan_thread.c:115-118) with one program scoring a whole
[profiles x sequences] block at once:

  - node axis (K) is vectorized,
  - the mute D-chain is a log-depth prefix cummax, not a serial loop,
  - both hypotheses (null R-loop and alt plan-7) run in the same scan,
  - emissions are per-position gathers into per-state fragment tables.

Score-only: traceback for the rare LRT hits is a second pass via the numpy
oracle (ops/viterbi_ref.py), mirroring the reference's hit-rarity design
(scan_thread.c:121-129); a Pallas backpointer kernel can replace it later.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from deciphon_tpu.models.frame import FRAG_SENTINEL
from deciphon_tpu.models.profile import ProteinProfile

NEG = -1e30  # effective -inf that stays NaN-free through cumsum tricks


class ProfileBlock(NamedTuple):
    """A batch of profiles padded to a common core size Kpad.

    Dead padding nodes carry -inf transitions so they never score.
    """

    fm: jax.Array  # [B, Kpad, 1366] match fragment tables
    fi: jax.Array  # [B, 1366] insert fragment table
    fn: jax.Array  # [B, 1366] null/special fragment table (R,N,J,C)
    entry: jax.Array  # [B, Kpad]
    mm_in: jax.Array  # [B, Kpad]
    im_in: jax.Array  # [B, Kpad]
    dm_in: jax.Array  # [B, Kpad]
    md_in: jax.Array  # [B, Kpad]
    dd_in: jax.Array  # [B, Kpad]
    mi: jax.Array  # [B, Kpad]
    ii: jax.Array  # [B, Kpad]
    core_size: jax.Array  # [B] int32

    @property
    def nprofiles(self) -> int:
        return self.fm.shape[0]

    @property
    def kpad(self) -> int:
        return self.fm.shape[1]


def _clamp(a: np.ndarray, dtype=np.float32) -> np.ndarray:
    return np.maximum(np.asarray(a, dtype=np.float64), NEG).astype(dtype)


def build_profile_block(
    profiles: list[ProteinProfile], kpad: int | None = None, base: int = 4,
    dtype=np.float32, codes: tuple | None = None,
) -> ProfileBlock:
    """Stack + pad host-side profiles into a block of HOST (numpy) arrays.

    Kept on host deliberately: callers upload the arrays they need in
    their own layout.  The scan engine does not use this for its blocks:
    it synthesizes the tables on the device (ops/tables.py).

    ``codes`` switches to exact-subset IUPAC tables over base
    4+len(codes) (models/frame.fragment_table_codes)."""
    B = len(profiles)
    K = max(p.core_size for p in profiles)
    if kpad is not None:
        assert kpad >= K
        K = kpad
    from deciphon_tpu.models.frame import frag_layout

    if codes is not None:
        codes = tuple(codes)
        base = 4 + len(codes)
    ntab = frag_layout(base)[1] + 1

    def padk(a, fill):
        out = np.full(K, fill, dtype=np.float64)
        out[: len(a)] = a
        return _clamp(out, dtype)

    fm = np.full((B, K, ntab), NEG, dtype=dtype)
    fi = np.empty((B, ntab), dtype=dtype)
    fn = np.empty((B, ntab), dtype=dtype)
    arrs = {
        name: np.empty((B, K), dtype=dtype)
        for name in (
            "entry", "mm_in", "im_in", "dm_in", "md_in", "dd_in", "mi", "ii"
        )
    }
    core = np.empty(B, dtype=np.int32)
    for b, p in enumerate(profiles):
        fmat, fins, fnull = p.fragment_tables(base=base, codes=codes)
        fm[b, : p.core_size] = _clamp(fmat, dtype)
        fi[b] = _clamp(fins, dtype)
        fn[b] = _clamp(fnull, dtype)
        for name in arrs:
            arrs[name][b] = padk(getattr(p, name), -np.inf)
        core[b] = p.core_size
    return ProfileBlock(fm=fm, fi=fi, fn=fn, core_size=core, **arrs)


def end_fragment_indices(fidx: np.ndarray, base: int = 4) -> np.ndarray:
    """[Lp, 5] indices of fragments *ending* at position i (i = 1..Lp).

    eidx[i-1, l-1] = fragment index of seq[i-l : i] (start-indexed table
    fidx from ops/emissions.fragment_indices), or the -inf sentinel when
    i - l < 0.
    """
    from deciphon_tpu.models.frame import frag_layout

    sentinel = frag_layout(base)[1]
    Lp = fidx.shape[0]
    out = np.full((Lp, 5), sentinel, dtype=np.int32)
    for l in range(1, 6):
        out[l - 1 :, l - 1] = fidx[: Lp - l + 1, l - 1]
    return out


def _specials(seq_len, multi_hits: bool, hmmer3_compat: bool):
    """Length-dependent special transitions, traced on seq_len.

    Mirrors protein_profile_setup (src/model/protein_profile.c:155-216).
    """
    L = seq_len.astype(jnp.float64 if jax.config.x64_enabled else jnp.float32)
    if multi_hits:
        q = 0.5
        log_q = float(np.log(0.5))
    else:
        q = 0.0
        log_q = NEG
    denom = jnp.log(L + 2.0 + q / (1.0 - q))
    lp = jnp.log(L) - denom
    l1p = jnp.log(2.0 + q / (1.0 - q)) - denom
    lr = jnp.log(L) - jnp.log(L + 1.0)
    nn = cc = jj = lp
    if hmmer3_compat:
        nn = cc = jj = jnp.zeros_like(lp)
    return dict(
        NN=nn, NB=l1p, EC=float(np.log(1.0 - q)) if q < 1 else NEG,
        CC=cc, CT=l1p, EJ=log_q, JJ=jj, JB=l1p, RR=lr,
    )


# Semiring ops: (pairwise, axis-reduce, prefix-scan).  "max" = Viterbi
# (best path); "logsumexp" = forward algorithm (total path mass) — the
# identical recurrence with max-plus swapped for log-plus, including the
# D-chain prefix trick (cummax -> cumlogsumexp).
def _semiring(name: str):
    if name == "max":
        return jnp.maximum, jnp.max, jax.lax.cummax
    assert name == "logsumexp"

    def reduce_lse(x, axis=None):
        return jax.scipy.special.logsumexp(x, axis=axis)

    return jnp.logaddexp, reduce_lse, jax.lax.cumlogsumexp


def _viterbi_single(
    block_row, eidx, seq_len, multi_hits, hmmer3_compat, semiring="max"
):
    """Score one profile against one sequence. Returns (alt, null) logliks."""
    (fm, fi, fn, entry, mm_in, im_in, dm_in, md_in, dd_in, mi, ii, core) = (
        block_row
    )
    join, reduce_, cumred = _semiring(semiring)
    K = fm.shape[0]
    # specials compute in the widest enabled float, then cast to the
    # block dtype so the lax.scan carry type is width-stable (under
    # JAX_ENABLE_X64 an uncast f64 special silently promoted the whole
    # carry and broke the scan's carry-type invariant)
    xt = {
        k: jnp.asarray(v).astype(fm.dtype)
        for k, v in _specials(seq_len, multi_hits, hmmer3_compat).items()
    }

    # prefix sums for the D-chain trick: VD[k] = cdd[k] + cummax(a)[k-1]
    # with a[j] = VM[j] + md_next[j] - cdd[j+1]
    dd_safe = jnp.maximum(dd_in, NEG / 1e6)  # keep cumsum finite
    cdd = jnp.cumsum(dd_safe.at[0].set(0.0))  # cdd[k] = sum_{m<=k} dd_in[m]
    md_next = jnp.concatenate([md_in[1:], jnp.full((1,), NEG)])  # [K]
    cdd_next = jnp.concatenate([cdd[1:], cdd[-1:]])  # cdd[j+1]

    dt = fm.dtype
    neg_k = jnp.full((5, K), NEG, dtype=dt)
    neg_5 = jnp.full((5,), NEG, dtype=dt)

    carry0 = dict(
        VM=neg_k, VI=neg_k, VD=neg_k,
        VS=neg_5.at[0].set(0.0),  # position 0 in slot 0
        VN=neg_5, VJ=neg_5, VC=neg_5, VE=neg_5,
        VB=neg_5.at[0].set(xt["NB"]),  # VB[0] = S->B
        VR=neg_5,
    )

    def shift_k(a):  # shift along node axis: a[..., k] -> a[..., k-1]
        return jnp.concatenate(
            [jnp.full(a.shape[:-1] + (1,), NEG, a.dtype), a[..., :-1]], -1
        )

    def step(carry, eidx_i):
        em_m = fm[:, eidx_i].T  # [5, K]
        em_i = fi[eidx_i]  # [5]
        em_n = fn[eidx_i]  # [5]

        # match states
        cand = join(
            carry["VB"][:, None] + entry[None, :],
            join(
                shift_k(carry["VM"]) + mm_in,
                join(
                    shift_k(carry["VI"]) + im_in,
                    shift_k(carry["VD"]) + dm_in,
                ),
            ),
        )
        VM = reduce_(cand + em_m, axis=0)  # [K]
        # insert states
        VI = reduce_(
            join(carry["VM"] + mi, carry["VI"] + ii)
            + em_i[:, None],
            axis=0,
        )
        # N / J / C loops (emit from the null dist, reference
        # protein_model.c:250-254)
        VN = reduce_(
            join(carry["VS"], carry["VN"]) + xt["NN"] + em_n, axis=None
        )
        VJ = reduce_(
            join(carry["VE"] + xt["EJ"], carry["VJ"])
            + xt["JJ"] + em_n, axis=None
        )
        VC = reduce_(
            join(carry["VE"] + xt["EC"], carry["VC"])
            + xt["CC"] + em_n, axis=None
        )
        # null-model R loop: first emission free of RR (VS marks position 0)
        VR = reduce_(
            join(carry["VR"] + xt["RR"], carry["VS"]) + em_n, axis=None
        )

        # D-chain: same-position mute cascade as a prefix scan
        a = VM + md_next - cdd_next
        b = cumred(a)
        VD = cdd + jnp.concatenate([jnp.full((1,), NEG), b[:-1]])
        VD = jnp.maximum(VD, NEG)  # numeric clamp, not a semiring op

        VE = join(reduce_(VM, axis=None), reduce_(VD, axis=None))
        VB = join(
            VN + xt["NB"],
            join(VE + xt["EJ"] + xt["JB"], VJ + xt["JB"]),
        )
        VT = join(VE + xt["EC"] + xt["CT"], VC + xt["CT"])

        def push(ring, new):
            return jnp.concatenate([new[None], ring[:-1]], axis=0)

        new_carry = dict(
            VM=push(carry["VM"], VM), VI=push(carry["VI"], VI),
            VD=push(carry["VD"], VD), VS=push(carry["VS"], neg_5[0]),
            VN=push(carry["VN"], VN), VJ=push(carry["VJ"], VJ),
            VC=push(carry["VC"], VC), VE=push(carry["VE"], VE),
            VB=push(carry["VB"], VB), VR=push(carry["VR"], VR),
        )
        return new_carry, (VT, VR)

    _, (VTs, VRs) = jax.lax.scan(step, carry0, eidx)
    alt = VTs[seq_len - 1]
    null = VRs[seq_len - 1]
    return alt, null


@functools.partial(
    jax.jit, static_argnames=("multi_hits", "hmmer3_compat", "semiring")
)
def viterbi_scores(
    block: ProfileBlock,
    eidx: jax.Array,  # [S, Lp, 5] int32 end-fragment indices
    seq_len: jax.Array,  # [S] int32
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
    semiring: str = "max",
):
    """Score every (sequence, profile) pair.

    Returns (alt_loglik [S, B], null_loglik [S, B]) float32.
    ``semiring="logsumexp"`` runs the forward algorithm instead of
    Viterbi (same recurrence, total path mass instead of best path).
    """

    def one_pair(row, e, n):
        return _viterbi_single(
            row, e, n, multi_hits, hmmer3_compat, semiring
        )

    row = tuple(block)
    over_profiles = jax.vmap(
        one_pair, in_axes=(tuple(0 for _ in row), None, None)
    )
    over_seqs = jax.vmap(over_profiles, in_axes=(None, 0, 0))
    alt, null = over_seqs(row, eidx, seq_len)
    return alt, null


def forward_scores(
    block: ProfileBlock,
    eidx: jax.Array,
    seq_len: jax.Array,
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
):
    """Forward-algorithm (alt, null) log-likelihoods [S, B]: logsumexp
    over all state paths.  BASELINE.json north-star counterpart of
    ``viterbi_scores`` (the reference, like imm, only runs Viterbi)."""
    return viterbi_scores(
        block, eidx, seq_len,
        multi_hits=multi_hits, hmmer3_compat=hmmer3_compat,
        semiring="logsumexp",
    )


def lrt(null_loglik, alt_loglik):
    return -2.0 * (null_loglik - alt_loglik)
