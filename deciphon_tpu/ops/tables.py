"""Device-side synthesis of frame-state fragment score tables.

Scan setup cost is dominated by building the per-node fragment tables
F[1365] (models/frame.py): the host dgemm formulation burns ~a hundred
seconds for a Pfam-scale DB and then ships ~GBs of tables to the device.
This module synthesizes the same tables ON DEVICE from the compact
per-node inputs (codon log-marginals [125] + background nuclt log-probs
[5] — ~10x smaller than the tables), as two one-hot matmuls per fragment
length:

    probs[n, f] = sum_t  coef_t * qq[n, pair(f,t)] * Mp[n, midx(f,t)]
                = ((Mp @ E_l) * (qq @ G_l)).reshape(N, F, T).sum(-1)

with E_l [125, F*T] one-hot over codon-marginal entries and G_l [25, F*T]
one-hot over background-pair entries scaled by the per-class error-model
coefficient (frame.term_coefs).  Both matmuls run at
``Precision.HIGHEST``: a GPU's default float32 matmul rounds its inputs
to TF32 (10 mantissa bits), which would skew every table entry by ~1e-3
and whole-read Viterbi scores by ~0.05.  At HIGHEST the arithmetic is
exact selection, so the only deviation from the host f64 path is f32
product/sum rounding (~1e-7 relative).  Base 5 (ACGT + N) uses the same
selectors over the extended fragment set: an N routes to the "any"
marginal entry, which is the exact A/C/G/T marginal.

The reference has no analogue (imm precomputes per-state tables on the
CPU at press time, cf. src/model/protein_model.c:247-254).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from deciphon_tpu.models.frame import (
    FRAG_OFFSET,
    FRAG_SENTINEL,
    NFRAGS,
    TERMS,
    _enumerate_frags,
    term_coefs,
)
from deciphon_tpu.ops.viterbi_jax import NEG

_CONSTS_CACHE: dict[tuple[float, int], list] = {}


def _length_consts(eps: float, base: int = 4):
    """Per-length (E [125, F*T], Gc [25, F*T], F, T) one-hot selectors."""
    if (eps, base) in _CONSTS_CACHE:
        return _CONSTS_CACHE[eps, base]
    coefs = term_coefs(eps)
    out = []
    for length in range(1, 6):
        frags = _enumerate_frags(length, base)  # [F, length]
        F = frags.shape[0]
        fragx = np.concatenate(
            [frags, np.full((F, 1), 4, dtype=frags.dtype)], axis=1
        )
        marg_sel, ins_sel, cls = TERMS[length]
        T = marg_sel.shape[0]
        sel = np.where(marg_sel < 0, length, marg_sel)
        zabc = fragx[:, sel]  # [F, T, 3]
        midx = zabc[..., 0] * 25 + zabc[..., 1] * 5 + zabc[..., 2]  # [F, T]
        isel = np.where(ins_sel < 0, length, ins_sel)
        iidx = fragx[:, isel]  # [F, T, 2] values 0..4
        pair = iidx[..., 0] * 5 + iidx[..., 1]  # [F, T] into qq[25]
        coef = np.array([coefs[c] for c in cls])  # [T]

        E = np.zeros((125, F * T), dtype=np.float32)
        G = np.zeros((25, F * T), dtype=np.float32)
        cols = np.arange(F * T)
        E[midx.reshape(-1), cols] = 1.0
        G[pair.reshape(-1), cols] = np.broadcast_to(coef, (F, T)).reshape(-1)
        out.append((E, G, F, T))
    _CONSTS_CACHE[eps, base] = out
    return out


@functools.partial(jax.jit, static_argnames=("eps", "base"))
def _synth_chunk(mp, q, eps: float, base: int = 4):
    """One fixed-shape [R, 125] x [R, 5] -> [R, NFRAGS] synthesis chunk.

    Shape-stable on purpose: every caller pads to the same R, so the
    whole press/scan pipeline compiles this GEMM graph exactly ONCE
    (a data-dependent lax.map here used to recompile per profile block
    and dominated cold-start)."""
    consts = _length_consts(eps, base)
    qq = (q[:, :, None] * q[:, None, :]).reshape(q.shape[0], 25)
    # HIGHEST precision is load-bearing: without it the GPU runs the f32
    # matmul in TF32 (see module docstring)
    dot = functools.partial(
        jnp.matmul, precision=jax.lax.Precision.HIGHEST
    )
    parts = []
    for E, G, F, T in consts:
        p = dot(mp, jnp.asarray(E)) * dot(qq, jnp.asarray(G))
        parts.append(p.reshape(p.shape[0], F, T).sum(-1))
    probs = jnp.concatenate(parts, axis=1)  # [R, NFRAGS]
    return jnp.maximum(jnp.log(probs), NEG)


def synth_fragment_tables(margp, qp, eps: float, row_chunk: int = 4096,
                          base: int = 4):
    """[N, NTAB] log fragment tables from linear-space inputs.

    Args:
      margp: [N, 125] codon-marginal probabilities (exp of frame.codon_marg).
      qp: [N, 5] background nucleotide probs with qp[:, 4] = 1 (the
          "no-insertion" sentinel, exp of frame.q5_pad output).
      eps: indel error rate (static).
      base: 4 (ACGT) or 5 (ACGT + N).

    Returns [N, NTAB] float32 log-probs, -inf clamped to viterbi_jax.NEG,
    sentinel column NEG.  Dispatches fixed-shape row chunks so XLA
    compiles the synthesis once regardless of N.
    """
    N = margp.shape[0]
    Np = (N + row_chunk - 1) // row_chunk * row_chunk
    margp = jnp.pad(
        jnp.asarray(margp, jnp.float32), ((0, Np - N), (0, 0))
    )
    qp = jnp.pad(jnp.asarray(qp, jnp.float32), ((0, Np - N), (0, 0)))
    logs = [
        _synth_chunk(
            jax.lax.dynamic_slice_in_dim(margp, i, row_chunk),
            jax.lax.dynamic_slice_in_dim(qp, i, row_chunk),
            eps=float(eps), base=base,
        )
        for i in range(0, Np, row_chunk)
    ]
    logs = jnp.concatenate(logs, axis=0)[:N] if len(logs) > 1 else logs[0][:N]
    # append the -inf padding sentinel column
    return jnp.concatenate(
        [logs, jnp.full((N, 1), NEG, jnp.float32)], axis=1
    )


def device_profile_block(db, idxs, kpad: int, codes: tuple = ()):
    """Device-resident ``viterbi_jax.ProfileBlock`` for profiles ``idxs``
    of TensorDB ``db``, padded to ``kpad`` nodes.

    ACGT and ACGT+N tables are synthesized here on the device from the
    DB's compact per-node arrays; other IUPAC code sets fall back to the
    host's exact-subset tables (models/frame.fragment_table_codes)."""
    from deciphon_tpu.ops import viterbi_jax as vj

    idxs = np.asarray(idxs, np.int64)
    if codes not in ((), ("N",)):
        profiles = [db.profile(int(i)) for i in idxs]
        host = vj.build_profile_block(profiles, kpad=kpad, codes=codes)
        return vj.ProfileBlock(*(jnp.asarray(a) for a in host))
    base = 4 + len(codes)
    arr = db.arrays
    off = arr["node_offset"]
    B = len(idxs)
    margp = np.zeros((B, kpad, 125), np.float32)
    qp = np.zeros((B, kpad, 5), np.float32)
    trans = {
        name: np.full((B, kpad), NEG, np.float32)
        for name in vj.ProfileBlock._fields[3:11]
    }
    for b, i in enumerate(idxs):
        s, e = int(off[i]), int(off[i + 1])
        margp[b, : e - s] = np.exp(arr["match_marg"][s:e])
        qp[b, : e - s] = np.exp(arr["match_q"][s:e])
        for name, t in trans.items():
            t[b, : e - s] = np.maximum(arr[name][s:e], NEG)
    eps = float(db.cfg.epsilon)

    def synth(m, q):
        return synth_fragment_tables(
            jnp.asarray(m.reshape(-1, 125)), jnp.asarray(q.reshape(-1, 5)),
            eps=eps, base=base,
        )

    fm = synth(margp, qp).reshape(B, kpad, -1)
    fi = synth(np.exp(arr["insert_marg"][idxs]), np.exp(arr["insert_q"][idxs]))
    fn = synth(np.exp(arr["null_marg"][idxs]), np.exp(arr["null_q"][idxs]))
    return vj.ProfileBlock(
        fm=fm, fi=fi, fn=fn,
        core_size=jnp.asarray(db.core_sizes[idxs].astype(np.int32)),
        **{name: jnp.asarray(t) for name, t in trans.items()},
    )
