"""Batched Viterbi for standard (generic single-emission) profiles.

The compute path behind the typeid-1 profile kind (reference
src/model/standard_profile.c:22-63: two packed imm_dp's run by the same
scan vtable as protein profiles).  The recurrence is the textbook dense
HMM Viterbi — V'[j] = max_i (V[i] + T[i,j]) + E[j, x] — expressed as a
lax.scan over positions and vmapped over (profiles x sequences); the
max-plus inner step vectorizes over the state axis.

Profiles batch by padding states to a common S with NEG rows/columns;
sequences batch by padding positions (scores are captured at each
sequence's true length).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from deciphon_tpu.models.standard import NEG, StandardProfile


class StandardBlock(NamedTuple):
    """A batch of standard profiles padded to a common state count."""

    alt_start: jax.Array  # [B, S]
    alt_trans: jax.Array  # [B, S, S]
    alt_emis: jax.Array  # [B, S, A]
    alt_end: jax.Array  # [B, S]
    null_start: jax.Array  # [B, Sn]
    null_trans: jax.Array  # [B, Sn, Sn]
    null_emis: jax.Array  # [B, Sn, A]
    null_end: jax.Array  # [B, Sn]


def _pad_states(start, trans, emis, end, S: int):
    s = len(start)
    out_start = np.full(S, NEG, np.float32)
    out_start[:s] = np.maximum(start, NEG)
    out_trans = np.full((S, S), NEG, np.float32)
    out_trans[:s, :s] = np.maximum(trans, NEG)
    out_emis = np.full((S, emis.shape[1]), NEG, np.float32)
    out_emis[:s] = np.maximum(emis, NEG)
    out_end = np.full(S, NEG, np.float32)
    out_end[:s] = np.maximum(end, NEG)
    return out_start, out_trans, out_emis, out_end


def build_standard_block(profiles: list[StandardProfile]) -> StandardBlock:
    S = max(p.nstates for p in profiles)
    Sn = max(p.null_emis.shape[0] for p in profiles)
    alt = [_pad_states(p.alt_start, p.alt_trans, p.alt_emis, p.alt_end, S)
           for p in profiles]
    nul = [
        _pad_states(p.null_start, p.null_trans, p.null_emis, p.null_end, Sn)
        for p in profiles
    ]
    stack = lambda xs: jnp.asarray(np.stack(xs))  # noqa: E731
    return StandardBlock(
        alt_start=stack([a[0] for a in alt]),
        alt_trans=stack([a[1] for a in alt]),
        alt_emis=stack([a[2] for a in alt]),
        alt_end=stack([a[3] for a in alt]),
        null_start=stack([n[0] for n in nul]),
        null_trans=stack([n[1] for n in nul]),
        null_emis=stack([n[2] for n in nul]),
        null_end=stack([n[3] for n in nul]),
    )


def _viterbi_one(start, trans, emis, end, seq, seq_len):
    """Best-path loglik of one profile vs one padded sequence."""

    def step(V, x):
        # V [S]; new V'[j] = max_i(V[i] + T[i,j]) + E[j, x]
        Vn = jnp.max(V[:, None] + trans, axis=0) + emis[:, x]
        return Vn, Vn

    V1 = start + emis[:, seq[0]]
    _, Vs = jax.lax.scan(step, V1, seq[1:])
    Vs = jnp.concatenate([V1[None], Vs], axis=0)  # [L, S]
    finals = jnp.max(Vs + end[None, :], axis=1)  # [L]
    return finals[seq_len - 1]


@functools.partial(jax.jit)
def standard_viterbi_scores(block: StandardBlock, seqs, seq_len):
    """(alt [Q, B], null [Q, B]) logliks for encoded, padded sequences.

    seqs: [Q, Lp] int32 symbol indices (padding values are read but the
    score is captured at seq_len).  seq_len: [Q] int32.
    """

    def alt_one(b_idx_free, seq, sl):
        st_, tr, em, en = b_idx_free
        return _viterbi_one(st_, tr, em, en, seq, sl)

    def over_profiles(arrs, seq, sl):
        return jax.vmap(lambda s, t, e, n: _viterbi_one(s, t, e, n, seq, sl))(
            *arrs
        )

    alt = jax.vmap(
        lambda seq, sl: over_profiles(
            (block.alt_start, block.alt_trans, block.alt_emis,
             block.alt_end), seq, sl
        )
    )(seqs, seq_len)
    null = jax.vmap(
        lambda seq, sl: over_profiles(
            (block.null_start, block.null_trans, block.null_emis,
             block.null_end), seq, sl
        )
    )(seqs, seq_len)
    return alt, null


def scan_standard(
    profiles: list[StandardProfile],
    reads: list[str],
    lrt_threshold: float = 10.0,
):
    """LRT-gated standard-profile scan: [(seq_idx, profile_idx, alt,
    null, lrt)] for every passing pair, ordered like the protein scan."""
    abc = profiles[0].abc
    block = build_standard_block(profiles)
    Lp = max(len(r) for r in reads)
    seqs = np.zeros((len(reads), Lp), np.int32)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        enc = abc.encode(r)
        seqs[i, : len(enc)] = enc
        lens[i] = len(enc)
    alt, null = standard_viterbi_scores(
        block, jnp.asarray(seqs), jnp.asarray(lens)
    )
    alt = np.asarray(alt, np.float64)
    null = np.asarray(null, np.float64)
    lrt = -2.0 * (null - alt)
    out = []
    for q, b in np.argwhere(
        np.isfinite(lrt) & (lrt >= lrt_threshold) & (alt > NEG / 2)
    ):
        out.append(
            (int(q), int(b), float(alt[q, b]), float(null[q, b]),
             float(lrt[q, b]))
        )
    return out
