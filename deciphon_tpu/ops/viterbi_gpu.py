"""Batched codon-frame Viterbi / forward scoring kernel for NVIDIA GPUs.

Pallas through Triton (``backend="triton"``), so the same kernel runs in
interpret mode on the CPU for tests.  Same contract as
``viterbi_jax.viterbi_scores``: every (read, profile) pair of a block is
scored and ``(alt, null)`` log-likelihoods come back as [S, B].

Design (from the recurrence, not from any earlier kernel):

  - work item = (profile b, tile of R reads).  A fixed grid of ``nprog``
    persistent programs walks the items with stride ``nprog``; items are
    read-tile-minor, so programs running at the same time share a few
    profiles' fragment tables in L2.
  - the position loop runs inside the program, to the longest read of its
    tile.  The whole [R, K] DP row (K = the block's padded core width) and
    its 5-deep lookback ring stay in registers across positions.  R * K is
    held at ``ELEMS`` so that the ring fits whatever the core size.
  - the ring holds P[j] = the best entry into M_k at position j before the
    emission (B->M, M_{k-1}->M, I_{k-1}->M and D_{k-1}->M joined once), and
    Q[j] = the best entry into I_k.  Then M at position i is
    join_l(P[i-l-1] + em_l) and I is join_l(Q[i-l-1] + emi_l): ten [R, K]
    tensors instead of fifteen, and each transition is added once, not
    once per lookback.
  - emissions: each read loads its own five fragment-row indices and
    gathers the five [K] table rows (tables are [B, NTAB, K], node axis
    contiguous).
  - the mute D-chain is a prefix max (prefix logsumexp for forward) along
    K, the cumsum trick of viterbi_jax; it lowers to one Triton scan
    (``_register_scan_rules``).  The k -> k+1 shift of the M/I/D exits has
    no register form in Triton: it goes through a per-program scratch
    buffer (store, CTA barrier, load one or two nodes back), double
    buffered by position parity so one barrier per position suffices.

Arithmetic is float32, in the order viterbi_jax uses where it matters for
Viterbi (each join of the max semiring is exact, so only additions can
round differently).  Forward rounds its logsumexp on another path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from deciphon_tpu.ops import viterbi_jax as vj

NEG = vj.NEG

# DP cells per program (R reads x K nodes): the register budget of the
# ring at 4 warps (8 floats per thread per ring tensor).
ELEMS = 1024
# Persistent programs (grid size); each owns a 4*R*K-float scratch slot.
MAX_PROGRAMS = 1024
# Row order of the per-profile transition table ``tr``.
TR_ROWS = ("entry", "mm_s", "im_s", "dm_ss", "md_next", "cdd_next", "mi", "ii")
# Row order of the per-read special transitions (viterbi_jax._specials).
SPECIALS = ("NN", "NB", "EC", "CC", "CT", "EJ", "JJ", "JB", "RR")


def reads_per_program(kpad: int, nseqs: int) -> int:
    """R for a block of padded width ``kpad``: ELEMS // kpad reads, no more
    than the batch needs (a power of two either way)."""
    r = max(1, ELEMS // kpad)
    need = 1
    while need < nseqs:
        need *= 2
    return max(1, min(r, need))


class GpuBlock(NamedTuple):
    """One block's device tensors in the kernel's layout (profile axis
    leading, so a mesh shards every field the same way)."""

    fm: jax.Array  # [B, NTAB, K] match fragment tables, node axis minor
    fi: jax.Array  # [B, NTAB] insert fragment table
    fn: jax.Array  # [B, NTAB] null fragment table
    tr: jax.Array  # [B, 8, K] transitions, TR_ROWS order

    @property
    def nprofiles(self) -> int:
        return self.fm.shape[0]

    @property
    def ntab(self) -> int:
        return self.fm.shape[1]

    @property
    def kpad(self) -> int:
        return self.fm.shape[2]


@jax.jit
def prepare_block(block: vj.ProfileBlock) -> GpuBlock:
    """ProfileBlock (host or device arrays) -> kernel layout.

    The transition rows are pre-shifted along K so the kernel never
    shifts a parameter: mm_s[j] = mm_in[j+1], im_s[j] = im_in[j+1],
    dm_ss[j] = dm_in[j+2], and the D-chain prefix sums are those of
    viterbi_jax._viterbi_single."""
    fm = jnp.asarray(block.fm)
    B, K, NT = fm.shape
    neg = jnp.full((B, 1), NEG, fm.dtype)

    def nxt(a, n=1):
        a = jnp.asarray(a, fm.dtype)
        return jnp.concatenate([a[:, n:]] + [neg] * n, axis=1)

    dd_safe = jnp.maximum(jnp.asarray(block.dd_in, fm.dtype), NEG / 1e6)
    cdd = jnp.cumsum(dd_safe.at[:, 0].set(0.0), axis=1)
    cdd_next = jnp.concatenate([cdd[:, 1:], cdd[:, -1:]], axis=1)
    rows = dict(
        entry=jnp.asarray(block.entry, fm.dtype),
        mm_s=nxt(block.mm_in), im_s=nxt(block.im_in),
        dm_ss=nxt(block.dm_in, 2), md_next=nxt(block.md_in),
        cdd_next=cdd_next,
        mi=jnp.asarray(block.mi, fm.dtype), ii=jnp.asarray(block.ii, fm.dtype),
    )
    tr = jnp.stack([rows[n] for n in TR_ROWS], axis=1)  # [B, 8, K]
    return GpuBlock(
        fm=jnp.transpose(fm, (0, 2, 1)),
        fi=jnp.asarray(block.fi, fm.dtype),
        fn=jnp.asarray(block.fn, fm.dtype),
        tr=tr,
    )


def _register_scan_rules() -> None:
    """Teach the Triton lowering the two prefix scans of the D-chain.

    The installed Pallas Triton lowering has a rule for cumsum only; the
    generic ``tt.scan`` builder it uses takes any associative combine, so
    cummax (Viterbi) and cumlogsumexp (forward) lower the same way."""
    from jax._src.pallas.triton import lowering as tl

    def lse(a, b):
        m = jnp.maximum(a, b)
        return m + jnp.log1p(jnp.exp(jnp.minimum(a, b) - m))

    for prim, combine in ((lax.cummax_p, jnp.maximum),
                          (lax.cumlogsumexp_p, lse)):
        if prim in tl.triton_lowering_rules:
            continue

        def rule(ctx, x, *, axis, reverse, _combine=combine):
            if reverse:
                raise NotImplementedError("reverse scan")
            return tl._associative_scan_lowering(
                _combine, ctx, x, (axis,)
            )[0]

        tl.register_lowering(prim)(rule)


def _ops(semiring: str):
    """(join, join-of-list, row-reduce, prefix-scan) of a semiring."""
    if semiring == "max":
        def join_all(xs):
            out = xs[0]
            for x in xs[1:]:
                out = jnp.maximum(out, x)
            return out

        return (jnp.maximum, join_all,
                lambda x: jnp.max(x, axis=-1), lambda x: lax.cummax(x, axis=1))
    if semiring != "logsumexp":
        raise ValueError(f"unknown semiring {semiring!r}")

    def join(a, b):
        m = jnp.maximum(a, b)
        return m + jnp.log1p(jnp.exp(jnp.minimum(a, b) - m))

    def join_all(xs):
        m = xs[0]
        for x in xs[1:]:
            m = jnp.maximum(m, x)
        s = jnp.exp(xs[0] - m)
        for x in xs[1:]:
            s = s + jnp.exp(x - m)
        return m + jnp.log(s)

    def reduce_row(x):
        m = jnp.max(x, axis=-1)
        return m + jnp.log(jnp.sum(jnp.exp(x - m[:, None]), axis=-1))

    return join, join_all, reduce_row, lambda x: lax.cumlogsumexp(x, axis=1)


def _kernel(fm_ref, fi_ref, fn_ref, tr_ref, spec_ref, eidx_ref, slen_ref,
            alt_ref, null_ref, scr_ref, *, R, K, NT, S, nitems, ntiles,
            nprog, semiring, interpret):
    join, join_all, reduce_row, prefix = _ops(semiring)
    p = pl.program_id(0)
    r_i = lax.broadcasted_iota(jnp.int32, (R,), 0)
    k_i = lax.broadcasted_iota(jnp.int32, (K,), 0)
    rk_r = lax.broadcasted_iota(jnp.int32, (R, K), 0)
    rk_k = lax.broadcasted_iota(jnp.int32, (R, K), 1)
    negrk = jnp.full((R, K), NEG, jnp.float32)
    negr = jnp.full((R,), NEG, jnp.float32)
    # scratch slot of this program: [2 parities, 2 exits, R, K]
    slot = p * (4 * R * K) + rk_r * K

    def item(j, carry):
        w = p + j * nprog
        b = lax.div(w, ntiles)
        r0 = lax.rem(w, ntiles) * R
        rows = r0 + r_i
        slen = slen_ref[rows]
        sp = {n: spec_ref[x * S + rows] for x, n in enumerate(SPECIALS)}

        def trow(name):
            return tr_ref[(b * len(TR_ROWS) + TR_ROWS.index(name)) * K + k_i]

        entry = trow("entry")
        vb0 = sp["NB"]
        ring_p = tuple(
            join(v[:, None] + entry[None, :], negrk)
            for v in (vb0, negr, negr, negr, negr)
        )
        ring_q = (negrk,) * 5
        zero = jnp.zeros((R,), jnp.float32)
        scal = dict(
            VS=(zero, negr, negr, negr, negr),
            VN=(negr,) * 5, VJ=(negr,) * 5, VC=(negr,) * 5, VE=(negr,) * 5,
            VB=(vb0, negr, negr, negr, negr), VR=(negr,) * 5,
        )

        def position(i, carry):
            ring_p, ring_q, scal, alt, null = carry
            eidx = [eidx_ref[(i * 5 + l) * S + rows] for l in range(5)]
            frow = [b * NT + e for e in eidx]
            em = [fm_ref[fr, pl.ds(0, K)] for fr in frow]
            emi = [fi_ref[fr] for fr in frow]
            emn = [fn_ref[fr] for fr in frow]
            tr = {n: trow(n) for n in TR_ROWS}

            VM = join_all([ring_p[l] + em[l] for l in range(5)])
            VI = join_all([ring_q[l] + emi[l][:, None] for l in range(5)])
            s = scal
            VN = join_all([join(s["VS"][l], s["VN"][l]) + sp["NN"] + emn[l]
                           for l in range(5)])
            VJ = join_all([join(s["VE"][l] + sp["EJ"], s["VJ"][l])
                           + sp["JJ"] + emn[l] for l in range(5)])
            VC = join_all([join(s["VE"][l] + sp["EC"], s["VC"][l])
                           + sp["CC"] + emn[l] for l in range(5)])
            VR = join_all([join(s["VR"][l] + sp["RR"], s["VS"][l]) + emn[l]
                           for l in range(5)])

            # D-chain: Y[j] = VD[j+1] (viterbi_jax's cumsum trick)
            a = VM + tr["md_next"][None, :] - tr["cdd_next"][None, :]
            Y = jnp.maximum(tr["cdd_next"][None, :] + prefix(a), NEG)
            VD_all = jnp.where(rk_k < K - 1, Y, NEG)
            VE = join(reduce_row(VM), reduce_row(VD_all))
            VB = join(VN + sp["NB"],
                      join(VE + sp["EJ"] + sp["JB"], VJ + sp["JB"]))
            VT = join(VE + sp["EC"] + sp["CT"], VC + sp["CT"])

            # exits of node j into node j+1 (M, I) and j+2 (D via Y)
            Z1 = join(VM + tr["mm_s"][None, :], VI + tr["im_s"][None, :])
            Z2 = Y + tr["dm_ss"][None, :]
            base = slot + lax.rem(i, 2) * (2 * R * K)
            scr_ref[base + rk_k] = Z1
            scr_ref[base + R * K + rk_k] = Z2
            if not interpret:
                plgpu.debug_barrier()
            Z1s = scr_ref[base + jnp.maximum(rk_k - 1, 0)]
            Z2s = scr_ref[base + R * K + jnp.maximum(rk_k - 2, 0)]
            Pn = join(jnp.where(rk_k >= 1, Z1s, NEG),
                      jnp.where(rk_k >= 2, Z2s, NEG))
            Pn = join(VB[:, None] + entry[None, :], Pn)
            Qn = join(VM + tr["mi"][None, :], VI + tr["ii"][None, :])

            def push(ring, new):
                return (new,) + tuple(ring[:4])

            new = dict(
                VS=push(s["VS"], negr), VN=push(s["VN"], VN),
                VJ=push(s["VJ"], VJ), VC=push(s["VC"], VC),
                VE=push(s["VE"], VE), VB=push(s["VB"], VB),
                VR=push(s["VR"], VR),
            )
            last = i == slen - 1
            alt = jnp.where(last, VT, alt)
            null = jnp.where(last, VR, null)
            return push(ring_p, Pn), push(ring_q, Qn), new, alt, null

        lmax = jnp.max(slen)
        _, _, _, alt, null = lax.fori_loop(
            0, lmax, position, (ring_p, ring_q, scal, negr, negr)
        )
        alt_ref[b * S + rows] = alt
        null_ref[b * S + rows] = null
        if not interpret:
            # the next item reuses this program's scratch slot
            plgpu.debug_barrier()
        return carry

    nmine = lax.div(nitems - p + nprog - 1, nprog)
    lax.fori_loop(0, nmine, item, jnp.int32(0))


@functools.partial(
    jax.jit,
    static_argnames=("multi_hits", "hmmer3_compat", "semiring", "interpret"),
)
def viterbi_scores(
    block: GpuBlock,
    eidx: jax.Array,  # [S, Lp, 5] int32 end-fragment indices
    seq_len: jax.Array,  # [S] int32
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
    semiring: str = "max",
    interpret: bool = False,
):
    """Score every (read, profile) pair of ``block``: (alt, null) [S, B].

    ``interpret=True`` runs the kernel through the Pallas interpreter (CPU
    tests); it is never chosen by platform."""
    S, Lp, _ = eidx.shape
    B, K, NT = block.nprofiles, block.kpad, block.ntab
    if K & (K - 1):
        raise ValueError(f"padded core width {K} is not a power of two")
    R = reads_per_program(K, S)
    Sp = -(-S // R) * R
    sentinel = NT - 1
    eidx = jnp.pad(jnp.asarray(eidx, jnp.int32), ((0, Sp - S), (0, 0), (0, 0)),
                   constant_values=sentinel)
    slen = jnp.pad(jnp.asarray(seq_len, jnp.int32), (0, Sp - S),
                   constant_values=1)
    xt = vj._specials(slen, multi_hits, hmmer3_compat)
    spec = jnp.stack(
        [jnp.broadcast_to(jnp.asarray(xt[n], jnp.float32), (Sp,))
         for n in SPECIALS]
    ).reshape(-1)
    eidx_t = jnp.transpose(eidx, (1, 2, 0)).reshape(-1)  # [Lp, 5, Sp]
    ntiles = Sp // R
    nitems = B * ntiles
    nprog = min(nitems, MAX_PROGRAMS)
    if not interpret:
        _register_scan_rules()
    kernel = functools.partial(
        _kernel, R=R, K=K, NT=NT, S=Sp, nitems=nitems, ntiles=ntiles,
        nprog=nprog, semiring=semiring, interpret=interpret,
    )
    f32 = jnp.float32
    alt, null, _ = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((B * Sp,), f32),
            jax.ShapeDtypeStruct((B * Sp,), f32),
            jax.ShapeDtypeStruct((nprog * 4 * R * K,), f32),
        ),
        grid=(nprog,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(4, R * K // 256), num_stages=1
        ),
        interpret=interpret,
        name="viterbi_gpu",
    )(block.fm.reshape(B * NT, K), block.fi.reshape(-1),
      block.fn.reshape(-1), block.tr.reshape(-1), spec, eidx_t, slen)
    alt = alt.reshape(B, Sp)[:, :S].T
    null = null.reshape(B, Sp)[:, :S].T
    return alt, null
