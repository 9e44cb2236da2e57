"""NumPy oracle Viterbi for the codon-frame plan-7 profile.

Slow, obviously-correct reference implementation of the DP the device engines
implement (ops/viterbi_jax.py, ops/viterbi_gpu.py).  Semantics replace
imm_dp_viterbi over the profile graph built by the reference
(src/model/protein_model.c wiring; length-dependent specials from
protein_profile_setup, src/model/protein_profile.c:155-216):

alt model states: S -> N* -> B -> {M_k / I_k / D_k core} -> E -> {J -> B,
C} -> T, with frame states (M, I, N, J, C) emitting 1..5 nt fragments and
mute states (S, B, D, E, T) emitting none.  The D chain D_k -> D_{k+1} is a
same-position mute cascade.  null model: single self-looping frame state R.

Paths are step lists [(state_id, seqlen), ...] exactly like imm paths
(consumed by the product writer, reference src/server/prod.c:153-181).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from deciphon_tpu.models import state as st
from deciphon_tpu.models.profile import ProteinProfile, special_transitions
from deciphon_tpu.ops.emissions import fragment_indices

NEG = -np.inf


@dataclass
class ViterbiResult:
    loglik: float
    path: list[tuple[int, int]]  # [(state_id, seqlen)]


def viterbi_null(prof: ProteinProfile, seq_idx: np.ndarray,
                 multi_hits: bool = True, hmmer3_compat: bool = False,
                 base: int = 4, codes: tuple | None = None) -> ViterbiResult:
    """Null-model Viterbi: R self-loop with cost RR per extra step."""
    if codes is not None:
        base = 4 + len(codes)
    L = len(seq_idx)
    xt = special_transitions(L, multi_hits, hmmer3_compat)
    fidx = fragment_indices(seq_idx, base=base)
    _, _, fnull = prof.fragment_tables(base=base, codes=codes)

    V = np.full(L + 1, NEG)
    bp_len = np.zeros(L + 1, dtype=np.int32)
    for i in range(1, L + 1):
        best, bl = NEG, 0
        for l in range(1, min(5, i) + 1):
            prev = i - l
            base = 0.0 if prev == 0 else V[prev] + xt.RR
            cand = base + fnull[fidx[prev, l - 1]]
            if cand > best:
                best, bl = cand, l
        V[i] = best
        bp_len[i] = bl
    path = []
    i = L
    while i > 0:
        l = int(bp_len[i])
        path.append((st.R, l))
        i -= l
    path.reverse()
    return ViterbiResult(float(V[L]), path)


def viterbi_alt(prof: ProteinProfile, seq_idx: np.ndarray,
                multi_hits: bool = True, hmmer3_compat: bool = False,
                base: int = 4, codes: tuple | None = None) -> ViterbiResult:
    if codes is not None:
        base = 4 + len(codes)
    K = prof.core_size
    L = len(seq_idx)
    xt = special_transitions(L, multi_hits, hmmer3_compat)
    fidx = fragment_indices(seq_idx, base=base)
    fm, fi, fn = prof.fragment_tables(base=base, codes=codes)

    VM = np.full((L + 1, K), NEG)
    VI = np.full((L + 1, K), NEG)
    VD = np.full((L + 1, K), NEG)
    VS = np.full(L + 1, NEG)
    VN = np.full(L + 1, NEG)
    VB = np.full(L + 1, NEG)
    VE = np.full(L + 1, NEG)
    VJ = np.full(L + 1, NEG)
    VC = np.full(L + 1, NEG)
    VT = np.full(L + 1, NEG)

    # backpointers: packed (origin, len); origins per state kind
    bpM = np.zeros((L + 1, K, 2), dtype=np.int32)  # origin: 0=B 1=M 2=I 3=D
    bpI = np.zeros((L + 1, K, 2), dtype=np.int32)  # 0=M 1=I
    bpD = np.zeros((L + 1, K), dtype=np.int32)  # 0=M(k-1) 1=D(k-1)
    bpN = np.zeros((L + 1, 2), dtype=np.int32)  # 0=S 1=N
    bpJ = np.zeros((L + 1, 2), dtype=np.int32)  # 0=E 1=J
    bpC = np.zeros((L + 1, 2), dtype=np.int32)  # 0=E 1=C
    bpB = np.zeros(L + 1, dtype=np.int32)  # 0=S 1=N 2=E 3=J
    bpE = np.zeros((L + 1, 2), dtype=np.int32)  # (0=M 1=D, k)
    bpT = np.zeros(L + 1, dtype=np.int32)  # 0=E 1=C

    VS[0] = 0.0
    VB[0] = VS[0] + xt.NB  # S -> B
    bpB[0] = 0

    for i in range(1, L + 1):
        # emitting states: consider fragments ending at i
        bestM = np.full(K, NEG)
        bestI = np.full(K, NEG)
        bestN, bestJ, bestC = NEG, NEG, NEG
        for l in range(1, min(5, i) + 1):
            prev = i - l
            em = fm[np.arange(K), fidx[prev, l - 1]]  # match frag scores
            # M: from B / M_{k-1} / I_{k-1} / D_{k-1}
            fromB = VB[prev] + prof.entry
            shifted = lambda a: np.concatenate(([NEG], a[:-1]))
            cands = np.stack([
                fromB,
                shifted(VM[prev]) + prof.mm_in,
                shifted(VI[prev]) + prof.im_in,
                shifted(VD[prev]) + prof.dm_in,
            ])  # [4, K]
            origin = np.argmax(cands, axis=0)
            val = cands[origin, np.arange(K)] + em
            upd = val > bestM
            bpM[i, upd] = np.stack([origin[upd], np.full(upd.sum(), l)], -1)
            bestM = np.where(upd, val, bestM)
            # I: from M_k / I_k
            emI = fi[fidx[prev, l - 1]]
            candsI = np.stack([VM[prev] + prof.mi, VI[prev] + prof.ii])
            originI = np.argmax(candsI, axis=0)
            valI = candsI[originI, np.arange(K)] + emI
            updI = valI > bestI
            bpI[i, updI] = np.stack(
                [originI[updI], np.full(updI.sum(), l)], -1)
            bestI = np.where(updI, valI, bestI)
            # N: from S / N (both cost NN per emission)
            emN = fn[fidx[prev, l - 1]]
            for o, v in ((0, VS[prev] + xt.NN), (1, VN[prev] + xt.NN)):
                if v + emN > bestN:
                    bestN = v + emN
                    bpN[i] = (o, l)
            # J: from E (EJ+JJ) / J (JJ)
            for o, v in ((0, VE[prev] + xt.EJ + xt.JJ),
                         (1, VJ[prev] + xt.JJ)):
                if v + emN > bestJ:
                    bestJ = v + emN
                    bpJ[i] = (o, l)
            # C: from E (EC+CC) / C (CC)
            for o, v in ((0, VE[prev] + xt.EC + xt.CC),
                         (1, VC[prev] + xt.CC)):
                if v + emN > bestC:
                    bestC = v + emN
                    bpC[i] = (o, l)
        VM[i] = bestM
        VI[i] = bestI
        VN[i] = bestN
        VJ[i] = bestJ
        VC[i] = bestC

        # D chain (mute, same position): D_k from M_{k-1}/D_{k-1}
        for k in range(1, K):
            a = VM[i, k - 1] + prof.md_in[k]
            b = VD[i, k - 1] + prof.dd_in[k]
            VD[i, k] = max(a, b)
            bpD[i, k] = 0 if a >= b else 1

        # E: from any M_k (k>=0) or D_k (k>=1), exit cost log 1 = 0
        km = int(np.argmax(VM[i]))
        best, bo, bk = VM[i, km], 0, km
        if K > 1:
            kd = 1 + int(np.argmax(VD[i, 1:]))
            if VD[i, kd] > best:
                best, bo, bk = VD[i, kd], 1, kd
        VE[i] = best
        bpE[i] = (bo, bk)

        # B: from S/N (NB), E (EJ+JB), J (JB)
        cands = [VS[i] + xt.NB, VN[i] + xt.NB,
                 VE[i] + xt.EJ + xt.JB, VJ[i] + xt.JB]
        bpB[i] = int(np.argmax(cands))
        VB[i] = cands[bpB[i]]

        # T: from E (EC+CT, skipping C) or C (CT)
        cands = [VE[i] + xt.EC + xt.CT, VC[i] + xt.CT]
        bpT[i] = int(np.argmax(cands))
        VT[i] = cands[bpT[i]]

    # traceback from T at L
    path: list[tuple[int, int]] = []
    i = L
    cur = ("T", 0)
    path.append((st.T, 0))
    if bpT[L] == 0:
        cur = ("E", 0)
    else:
        cur = ("C", 0)
    while True:
        kind, k = cur
        if kind == "E":
            path.append((st.E, 0))
            o, kk = bpE[i]
            cur = ("M", kk) if o == 0 else ("D", kk)
        elif kind == "C":
            path.append((st.C, int(bpC[i, 1])))
            o, l = bpC[i]
            i -= l
            cur = ("E", 0) if o == 0 else ("C", 0)
        elif kind == "J":
            path.append((st.J, int(bpJ[i, 1])))
            o, l = bpJ[i]
            i -= l
            cur = ("E", 0) if o == 0 else ("J", 0)
        elif kind == "N":
            path.append((st.N, int(bpN[i, 1])))
            o, l = bpN[i]
            i -= l
            cur = ("S", 0) if o == 0 else ("N", 0)
        elif kind == "B":
            path.append((st.B, 0))
            o = bpB[i]
            cur = {0: ("S", 0), 1: ("N", 0), 2: ("E", 0), 3: ("J", 0)}[o]
        elif kind == "M":
            path.append((st.match_id(k), int(bpM[i, k, 1])))
            o, l = bpM[i, k]
            i -= l
            cur = {0: ("B", 0), 1: ("M", k - 1), 2: ("I", k - 1),
                   3: ("D", k - 1)}[o]
        elif kind == "I":
            path.append((st.insert_id(k), int(bpI[i, k, 1])))
            o, l = bpI[i, k]
            i -= l
            cur = ("M", k) if o == 0 else ("I", k)
        elif kind == "D":
            path.append((st.delete_id(k), 0))
            o = bpD[i, k]
            cur = ("M", k - 1) if o == 0 else ("D", k - 1)
        elif kind == "S":
            path.append((st.S, 0))
            break
    path.reverse()
    return ViterbiResult(float(VT[L]), path)


# ---------------------------------------------------------------------------
# Brute-force path enumeration (exponential; tiny cases only) — validates the
# DP wiring independently of any DP implementation.
# ---------------------------------------------------------------------------


def _build_graph(prof: ProteinProfile, xt):
    """Explicit (states, transitions) graph of the alt model."""
    K = prof.core_size
    fm, fi, fn = prof.fragment_tables()
    states: dict[int, tuple] = {}  # id -> (emit_table or None)
    states[st.S] = None
    states[st.N] = fn
    states[st.B] = None
    states[st.E] = None
    states[st.J] = fn
    states[st.C] = fn
    states[st.T] = None
    for k in range(K):
        states[st.match_id(k)] = fm[k]
        states[st.insert_id(k)] = fi
        states[st.delete_id(k)] = None

    trans: dict[int, list[tuple[int, float]]] = {sid: [] for sid in states}

    def add(a, b, lp):
        if np.isfinite(lp):
            trans[a].append((b, float(lp)))

    add(st.S, st.N, xt.NN)
    add(st.S, st.B, xt.NB)
    add(st.N, st.N, xt.NN)
    add(st.N, st.B, xt.NB)
    add(st.E, st.T, xt.EC + xt.CT)
    add(st.E, st.C, xt.EC + xt.CC)
    add(st.C, st.C, xt.CC)
    add(st.C, st.T, xt.CT)
    add(st.E, st.B, xt.EJ + xt.JB)
    add(st.E, st.J, xt.EJ + xt.JJ)
    add(st.J, st.J, xt.JJ)
    add(st.J, st.B, xt.JB)
    for k in range(K):
        add(st.B, st.match_id(k), prof.entry[k])
        add(st.match_id(k), st.E, 0.0)
        if k >= 1:
            add(st.delete_id(k), st.E, 0.0)
            add(st.match_id(k - 1), st.match_id(k), prof.mm_in[k])
            add(st.insert_id(k - 1), st.match_id(k), prof.im_in[k])
            add(st.delete_id(k - 1), st.match_id(k), prof.dm_in[k])
            add(st.match_id(k - 1), st.delete_id(k), prof.md_in[k])
            add(st.delete_id(k - 1), st.delete_id(k), prof.dd_in[k])
        add(st.match_id(k), st.insert_id(k), prof.mi[k])
        add(st.insert_id(k), st.insert_id(k), prof.ii[k])
    return states, trans


def brute_force_alt(prof: ProteinProfile, seq_idx: np.ndarray,
                    multi_hits: bool = True, hmmer3_compat: bool = False
                    ) -> ViterbiResult:
    """Enumerate every path S -> T consuming the whole sequence."""
    L = len(seq_idx)
    xt = special_transitions(L, multi_hits, hmmer3_compat)
    fidx = fragment_indices(seq_idx)
    states, trans = _build_graph(prof, xt)

    best = [NEG, None]

    def dfs(sid, pos, score, path, depth):
        if depth > 2 * L + 2 * prof.core_size + 8:
            return
        if sid == st.T:
            if pos == L and score > best[0]:
                best[0] = score
                best[1] = list(path)
            return
        for nxt, tlp in trans[sid]:
            table = states[nxt]
            if table is None:
                path.append((nxt, 0))
                dfs(nxt, pos, score + tlp, path, depth + 1)
                path.pop()
            else:
                for l in range(1, min(5, L - pos) + 1):
                    em = table[fidx[pos, l - 1]]
                    if not np.isfinite(em):
                        continue
                    path.append((nxt, l))
                    dfs(nxt, pos + l, score + tlp + em, path, depth + 1)
                    path.pop()

    dfs(st.S, 0, 0.0, [(st.S, 0)], 0)
    return ViterbiResult(best[0], best[1] or [])


# ---------------------------------------------------------------------------
# Forward algorithm (f64 oracle): logsumexp over ALL state paths — the
# sum-semiring twin of the Viterbi recurrences above.  The reference (like
# imm) only runs Viterbi; forward is a north-star extension (BASELINE.md).
# ---------------------------------------------------------------------------


def _lse(*vals: float) -> float:
    arr = np.array(vals, dtype=np.float64)
    m = arr.max()
    if not np.isfinite(m):
        return NEG
    return float(m + np.log(np.exp(arr - m).sum()))


def forward_null(prof: ProteinProfile, seq_idx: np.ndarray,
                 multi_hits: bool = True, hmmer3_compat: bool = False,
                 base: int = 4, codes: tuple | None = None) -> float:
    if codes is not None:
        base = 4 + len(codes)
    L = len(seq_idx)
    xt = special_transitions(L, multi_hits, hmmer3_compat)
    fidx = fragment_indices(seq_idx, base=base)
    _, _, fnull = prof.fragment_tables(base=base, codes=codes)
    V = np.full(L + 1, NEG)
    for i in range(1, L + 1):
        acc = []
        for l in range(1, min(5, i) + 1):
            prev = i - l
            b = 0.0 if prev == 0 else V[prev] + xt.RR
            acc.append(b + fnull[fidx[prev, l - 1]])
        V[i] = _lse(*acc)
    return float(V[L])


def forward_alt(prof: ProteinProfile, seq_idx: np.ndarray,
                multi_hits: bool = True, hmmer3_compat: bool = False,
                base: int = 4, codes: tuple | None = None) -> float:
    if codes is not None:
        base = 4 + len(codes)
    K = prof.core_size
    L = len(seq_idx)
    xt = special_transitions(L, multi_hits, hmmer3_compat)
    fidx = fragment_indices(seq_idx, base=base)
    fm, fi, fn = prof.fragment_tables(base=base, codes=codes)

    def lsev(a, axis=0):
        m = np.max(a, axis=axis, keepdims=True)
        m = np.where(np.isfinite(m), m, 0.0)
        with np.errstate(divide="ignore"):  # all-NEG column -> log(0)
            return np.squeeze(m, axis) + np.log(
                np.exp(a - m).sum(axis=axis)
            )

    VM = np.full((L + 1, K), NEG)
    VI = np.full((L + 1, K), NEG)
    VD = np.full((L + 1, K), NEG)
    VS = np.full(L + 1, NEG)
    VN = np.full(L + 1, NEG)
    VB = np.full(L + 1, NEG)
    VE = np.full(L + 1, NEG)
    VJ = np.full(L + 1, NEG)
    VC = np.full(L + 1, NEG)
    VT = np.full(L + 1, NEG)
    VS[0] = 0.0
    VB[0] = xt.NB

    shifted = lambda a: np.concatenate(([NEG], a[:-1]))  # noqa: E731
    for i in range(1, L + 1):
        accM = np.full((0, K), NEG)
        accI = np.full((0, K), NEG)
        accN, accJ, accC = [], [], []
        for l in range(1, min(5, i) + 1):
            prev = i - l
            em = fm[np.arange(K), fidx[prev, l - 1]]
            inflow = lsev(np.stack([
                VB[prev] + prof.entry,
                shifted(VM[prev]) + prof.mm_in,
                shifted(VI[prev]) + prof.im_in,
                shifted(VD[prev]) + prof.dm_in,
            ]))
            accM = np.vstack([accM, (inflow + em)[None]])
            emI = fi[fidx[prev, l - 1]]
            inflowI = lsev(np.stack([
                VM[prev] + prof.mi, VI[prev] + prof.ii,
            ]))
            accI = np.vstack([accI, (inflowI + emI)[None]])
            emN = fn[fidx[prev, l - 1]]
            accN.append(_lse(VS[prev], VN[prev]) + xt.NN + emN)
            accJ.append(
                _lse(VE[prev] + xt.EJ, VJ[prev]) + xt.JJ + emN
            )
            accC.append(
                _lse(VE[prev] + xt.EC, VC[prev]) + xt.CC + emN
            )
        VM[i] = lsev(accM)
        VI[i] = lsev(accI)
        VN[i] = _lse(*accN)
        VJ[i] = _lse(*accJ)
        VC[i] = _lse(*accC)
        for k in range(1, K):
            VD[i, k] = _lse(
                VM[i, k - 1] + prof.md_in[k],
                VD[i, k - 1] + prof.dd_in[k],
            )
        VE[i] = _lse(lsev(VM[i]), lsev(VD[i, 1:]) if K > 1 else NEG)
        VB[i] = _lse(
            VN[i] + xt.NB, VE[i] + xt.EJ + xt.JB, VJ[i] + xt.JB
        )
        VT[i] = _lse(VE[i] + xt.EC + xt.CT, VC[i] + xt.CT)
    return float(VT[L])


def brute_force_forward(prof: ProteinProfile, seq_idx: np.ndarray,
                        multi_hits: bool = True,
                        hmmer3_compat: bool = False) -> float:
    """Exhaustive logsumexp over every S -> T path (tiny cases only)."""
    L = len(seq_idx)
    xt = special_transitions(L, multi_hits, hmmer3_compat)
    fidx = fragment_indices(seq_idx)
    states, trans = _build_graph(prof, xt)
    total = [0.0, False]  # (prob mass, any)

    def dfs(sid, pos, score, depth):
        if depth > 2 * L + 2 * prof.core_size + 8:
            return
        if sid == st.T:
            if pos == L:
                total[0] += np.exp(score)
                total[1] = True
            return
        for nxt, tlp in trans[sid]:
            table = states[nxt]
            if table is None:
                dfs(nxt, pos, score + tlp, depth + 1)
            else:
                for l in range(1, min(5, L - pos) + 1):
                    em = table[fidx[pos, l - 1]]
                    if not np.isfinite(em):
                        continue
                    dfs(nxt, pos + l, score + tlp + em, depth + 1)

    dfs(st.S, 0, 0.0, 0)
    return float(np.log(total[0])) if total[1] else NEG
