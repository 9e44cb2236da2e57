"""Batched scan engine: sequences x profile-database -> LRT hits + products.

The compute core of the scan workload, replacing the reference's per-thread
rescan loop (src/server/scan.c:227-258 + scan_thread.c:86-129) with a
two-pass batched design:

  pass 1 (hot, device): profiles grouped into blocks of one padded core
    width (db/partition.pack_blocks) and kept resident in device memory;
    reads sorted by length; every (read, profile) pair scored by the
    platform's backend.  All blocks are dispatched asynchronously and
    synced once, then the LRT filter is applied (xmath.h:236-247,
    threshold 10.0 per scan.c:221).
  pass 2 (rare): only LRT survivors are re-run with traceback — a jitted
    backpointer DP (ops/viterbi_trace.py) — and decoded into match
    strings; hits are rare by construction, mirroring the reference's gate
    placement (scan_thread.c:121-129).

The backend is the one seam between platforms: on a GPU, "kernel" scores
with the Pallas-Triton kernel (ops/viterbi_gpu.py); on the CPU, "xla"
scores with the lax.scan engine (ops/viterbi_jax.py).  Each packs
profiles into blocks, gives a block its device form, scores a read batch
against it and counts the cells it dispatched.  Every block, at every
core width and alphabet, scores on the chosen backend.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from deciphon_tpu.db.format import TensorDB
from deciphon_tpu.db.partition import pack_blocks
from deciphon_tpu.models import codec
from deciphon_tpu.ops import viterbi_gpu as vg
from deciphon_tpu.ops import viterbi_jax as vj
from deciphon_tpu.ops import viterbi_ref as vr
from deciphon_tpu.ops.emissions import fragment_indices
from deciphon_tpu.utils import trace, xmath

# Read batches pad to a multiple of this many reads, so that a batch
# whose few ambiguous reads split off into their own class still scores
# its ACGT reads at the warmed shape.
BATCH_TIER = 64
# Node lanes per XLA-engine block: its vmapped lax.scan carries
# [reads, profiles, 5, K] rings, so big tiers split into several blocks.
XLA_BLOCK_LANES = 16384


@dataclass(frozen=True)
class ScanParams:
    """Mirrors sched_scan flags + the scan threshold (scan.c:221).

    ``algo`` extends the reference (which only runs Viterbi,
    scan_thread.c:115-118): "forward" scores every (seq, profile) pair
    with the forward algorithm — the same kernels under the logsumexp
    semiring — so logliks/LRT measure TOTAL path mass instead of the
    best path.  Hit match strings still decode the Viterbi path (the
    forward semiring has no single path to decode)."""

    multi_hits: bool = True
    hmmer3_compat: bool = False
    lrt_threshold: float = 10.0
    algo: str = "viterbi"  # "viterbi" | "forward"

    @property
    def semiring(self) -> str:
        if self.algo not in ("viterbi", "forward"):
            raise ValueError(f"unknown algo {self.algo!r}")
        return "logsumexp" if self.algo == "forward" else "max"


@dataclass
class SeqRecord:
    seq_id: int
    name: str
    data: str


@dataclass
class Hit:
    seq_id: int
    seq_idx: int
    profile_idx: int
    accession: str
    alt_loglik: float
    null_loglik: float
    lrt: float
    path: list[tuple[int, int]]
    match: str


@dataclass
class BestHit:
    """Per-read best profile, from the device-side reduction path."""

    seq_id: int
    profile_idx: int
    accession: str
    alt_loglik: float
    null_loglik: float
    lrt: float


def pad_seq_len(L: int) -> int:
    """Read-length tier: the next power of two >= L, at least 64.

    Each tier is one compile variant.  The GPU kernel runs each tile of
    reads only to its own longest read, so the tier costs it index bytes,
    not DP cells; the XLA engine runs every read to the tier."""
    p = 64
    while p < L:
        p *= 2
    return p


def frag_sentinel(base: int) -> int:
    """Fragment-table row that scores NEG (padding positions and reads)."""
    from deciphon_tpu.models.frame import frag_layout

    return frag_layout(base)[1]


def pad_batch(n: int) -> int:
    """Read-batch size tier: ``n`` rounded up to a multiple of BATCH_TIER."""
    return max(1, -(-n // BATCH_TIER)) * BATCH_TIER


@dataclass(frozen=True)
class XlaBackend:
    """The lax.scan engine (ops/viterbi_jax.py): CPU scans and tests."""

    name = "xla"

    def pack(self, core_sizes):
        return pack_blocks(core_sizes, max_lanes=XLA_BLOCK_LANES)

    def prepare(self, block: vj.ProfileBlock):
        return block

    def score(self, dev, eidx, slen, **kw):
        return vj.viterbi_scores(dev, eidx, slen, **kw)

    def dispatched_cells(self, kpad: int, nprofiles: int, slen, lp: int):
        return 3 * nprofiles * kpad * len(slen) * lp


@dataclass(frozen=True)
class KernelBackend:
    """The Pallas-Triton kernel (ops/viterbi_gpu.py).  ``interpret`` runs
    it through the Pallas interpreter: a test argument, never chosen by
    platform."""

    interpret: bool = False
    name = "kernel"

    def pack(self, core_sizes):
        return pack_blocks(core_sizes)

    def prepare(self, block: vj.ProfileBlock):
        return vg.prepare_block(block)

    def score(self, dev, eidx, slen, **kw):
        return vg.viterbi_scores(dev, eidx, slen, interpret=self.interpret,
                                 **kw)

    def dispatched_cells(self, kpad: int, nprofiles: int, slen, lp: int):
        # each tile of R reads (sorted longest first) runs to its first
        # read's length
        R = vg.reads_per_program(kpad, len(slen))
        tile_max = np.asarray(slen)[::R]
        return 3 * nprofiles * kpad * R * int(tile_max.sum())


# The backend each platform scans with; any other platform is an error.
PLATFORM_BACKENDS = {"gpu": "kernel", "cpu": "xla"}


def backend_name(platform: str) -> str:
    if platform not in PLATFORM_BACKENDS:
        raise ValueError(f"no scan backend for platform {platform!r}")
    return PLATFORM_BACKENDS[platform]


def make_backend(name: str | None = None, interpret: bool = False):
    """Backend ``name`` ("kernel" | "xla"), by default the one of the
    first JAX device's platform.  ``interpret`` (the kernel under the
    Pallas interpreter) must be asked for explicitly."""
    if name is None:
        name = backend_name(jax.devices()[0].platform)
    if name == "kernel":
        return KernelBackend(interpret=interpret)
    if name == "xla" and not interpret:
        return XlaBackend()
    raise ValueError(f"no backend {name!r} (interpret={interpret})")


class _Block:
    """One dispatch unit: profiles sharing a padded core width ``kpad``.

    Device forms are built lazily and cached per alphabet (``codes``, the
    read class's IUPAC codes); the extended forms are dropped after each
    scan that needed them — ambiguous reads are rare and the tables are
    ~3x the base-4 size."""

    __slots__ = ("chunk", "kpad", "dev")

    def __init__(self, chunk: np.ndarray, kpad: int):
        self.chunk = chunk
        self.kpad = kpad
        self.dev: dict[tuple, object] = {}


def _pad0(a, mult: int):
    """Pad axis 0 of a device array to a multiple of ``mult`` with dead
    entries (NEG scores, length/core 1)."""
    n = a.shape[0]
    extra = -(-n // mult) * mult - n
    if not extra:
        return a
    fill = 1 if jnp.issubdtype(a.dtype, jnp.integer) else vj.NEG
    pad = [(0, extra)] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, pad, constant_values=fill)


@functools.partial(
    jax.jit,
    static_argnames=("backend", "mesh", "multi_hits", "hmmer3_compat",
                     "semiring"),
)
def _score(backend, mesh, dev, eidx, slen, *, multi_hits, hmmer3_compat,
           semiring):
    """One block's (alt, null) [S, B]: the backend's score, under
    shard_map over ('seqs', 'profiles') when a mesh is given."""
    kw = dict(multi_hits=multi_hits, hmmer3_compat=hmmer3_compat,
              semiring=semiring)
    if mesh is None:
        return backend.score(dev, eidx, slen, **kw)
    kind = type(dev)

    def local(d, e, n):
        return backend.score(kind(*d), e, n, **kw)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(tuple(P("profiles") for _ in dev), P("seqs"), P("seqs")),
        out_specs=(P("seqs", "profiles"), P("seqs", "profiles")),
        check_vma=False,
    )
    return fn(tuple(dev), eidx, slen)


class ScanEngine:
    """Scans sequences against a TensorDB."""

    def __init__(
        self,
        db: TensorDB,
        params: ScanParams = ScanParams(),
        progress=None,
        traceback: str = "jax",  # "jax" (fast) | "oracle" (numpy)
        mesh=None,  # jax.sharding.Mesh('seqs', 'profiles') -> SPMD scan
        subset=None,  # profile indices to scan (share-nothing sharding)
        backend: str | None = None,  # "kernel" | "xla"; None: by platform
        interpret: bool = False,
    ):
        self.backend = make_backend(backend, interpret)
        self.mesh = mesh
        self.db = db
        self.params = params
        self.progress = progress
        self.traceback = traceback
        self._warm_lock = threading.Lock()
        # subset = one share-nothing DB partition (the reference's
        # scale-out unit: N workers x contiguous size-balanced slices,
        # src/db/profile_reader.c:44-72 via db/partition.py)
        subset = None if subset is None else np.asarray(subset, np.int64)
        self.subset = subset
        sizes = db.core_sizes if subset is None else db.core_sizes[subset]
        self._blocks: list[_Block] = []
        self._kpad_of: dict[int, int] = {}
        for kpad, idxs in self.backend.pack(sizes):
            if subset is not None:
                idxs = subset[idxs]
            self._blocks.append(_Block(idxs, kpad))
            for gi in idxs:
                self._kpad_of[int(gi)] = kpad

    # -- device forms ------------------------------------------------------

    def _device_block(self, blk: _Block, codes: tuple):
        """The backend's device form of ``blk`` for reads over ``codes``
        (tables synthesized on device, ops/tables.py), sharded over
        'profiles' on a mesh.  Built once and cached."""
        if codes not in blk.dev:
            from deciphon_tpu.ops.tables import device_profile_block

            dev = self.backend.prepare(
                device_profile_block(self.db, blk.chunk, blk.kpad, codes)
            )
            if self.mesh is not None:
                sh = NamedSharding(self.mesh, P("profiles"))
                dp = self.mesh.shape["profiles"]
                dev = type(dev)(
                    *(jax.device_put(_pad0(a, dp), sh) for a in dev)
                )
            blk.dev[codes] = dev
        return blk.dev[codes]

    def _put_reads(self, eidx: np.ndarray, slen: np.ndarray):
        """Upload one read class (sharded over 'seqs' on a mesh)."""
        if self.mesh is None:
            return jnp.asarray(eidx), jnp.asarray(slen)
        sh = NamedSharding(self.mesh, P("seqs"))
        ds = self.mesh.shape["seqs"]
        return (jax.device_put(_pad0(jnp.asarray(eidx), ds), sh),
                jax.device_put(_pad0(jnp.asarray(slen), ds), sh))

    def _dispatch(self, blk: _Block, codes: tuple, eidx, slen, nseqs: int):
        """Queue one block's scoring; device (alt, null) [nseqs, B]."""
        p = self.params
        alt, null = _score(
            self.backend, self.mesh, self._device_block(blk, codes),
            eidx, slen, multi_hits=p.multi_hits,
            hmmer3_compat=p.hmmer3_compat, semiring=p.semiring,
        )
        B = len(blk.chunk)
        return alt[:nseqs, :B], null[:nseqs, :B]

    def warmup(self, nseqs: int, max_len: int) -> float:
        """Compile and run once every variant a scan of ``nseqs`` ACGT
        reads up to ``max_len`` nt dispatches: each block's device tables,
        its scoring program at the batch's padded shape, and the pull of
        its results.  Reads with IUPAC codes score against extended tables
        that are built, and compiled for, on first use.  Returns seconds
        spent."""
        with self._warm_lock:
            t0 = time.perf_counter()
            S, Lp = pad_batch(nseqs), pad_seq_len(max_len)
            eidx = np.full((S, Lp, 5), frag_sentinel(4), np.int32)
            eidx, slen = self._put_reads(eidx, np.ones(S, np.int32))
            outs = [self._dispatch(b, (), eidx, slen, S) for b in self._blocks]
            for alt, null in outs:
                np.asarray(alt)
                np.asarray(null)
            return time.perf_counter() - t0

    # -- scans -------------------------------------------------------------

    def scan(self, seqs: Sequence[SeqRecord]) -> list[Hit]:
        """Score all (seq, profile) pairs; return LRT-passing hits with
        traceback + decoded match strings, ordered (seq, profile).

        Set DCP_PROFILE_DIR to capture a jax.profiler trace of pass 1;
        throughput (GCUPS) is logged per scan either way."""
        with trace.device_trace("scan"):
            encoded, pending = self._queue_dispatches(seqs)
            return self._gate_and_traceback(seqs, encoded, pending)

    def scores(self, seqs: Sequence[SeqRecord]):
        """(alt, null) log-likelihoods of every (read, profile) pair as
        host arrays [len(seqs), nprofiles] (profiles outside ``subset``
        stay NaN): pass 1 alone, no gate."""
        _, pending = self._queue_dispatches(seqs)
        alt = np.full((len(seqs), self.db.nprofiles), np.nan)
        null = alt.copy()
        for seq_ids, blk, _, a, n in pending:
            rows = np.asarray(seq_ids)[:, None]
            alt[rows, blk.chunk] = np.asarray(a)
            null[rows, blk.chunk] = np.asarray(n)
        self._finish_scan()
        return alt, null

    def best_hits(self, seqs: Sequence[SeqRecord]) -> list[BestHit]:
        """Per-read best profile via DEVICE-SIDE reduction: each block's
        [S, B] score matrices reduce to [S] (argmax over the profile
        axis) before leaving the device, so the host transfer shrinks by
        the DB width.  On a mesh the reduction crosses profile shards as
        an XLA collective (the production form of the pmax merge,
        parallel/sharded_scan.py).  No traceback — use ``scan`` for
        products."""

        @jax.jit
        def block_best(alt, null):
            lrt = -2.0 * (null - alt)
            lrt = jnp.where(alt > vj.NEG / 2, lrt, -jnp.inf)
            bi = jnp.argmax(lrt, axis=1)
            rows = jnp.arange(alt.shape[0])
            return bi, lrt[rows, bi], alt[rows, bi], null[rows, bi]

        with trace.device_trace("best_hits"):
            _, pending = self._queue_dispatches(seqs)
            reduced = [
                (seq_ids, blk, block_best(alt, null))
                for seq_ids, blk, _, alt, null in pending
            ]
        self._finish_scan()
        best: dict[int, BestHit] = {}
        for seq_ids, blk, (bi, lrt, alt, null) in reduced:
            bi, lrt = np.asarray(bi), np.asarray(lrt)
            alt, null = np.asarray(alt), np.asarray(null)
            if self.progress is not None:
                self.progress.consume(len(seq_ids) * len(blk.chunk))
            for i, si in enumerate(seq_ids):
                if not np.isfinite(lrt[i]):
                    continue
                cur = best.get(si)
                if cur is None or lrt[i] > cur.lrt:
                    gi = int(blk.chunk[int(bi[i])])
                    best[si] = BestHit(
                        seq_id=seqs[si].seq_id,
                        profile_idx=gi,
                        accession=self.db.profile(gi).accession,
                        alt_loglik=float(alt[i]),
                        null_loglik=float(null[i]),
                        lrt=float(lrt[i]),
                    )
        return [best[si] for si in sorted(best)]

    def _queue_dispatches(self, seqs: Sequence[SeqRecord]):
        # Split reads into classes by their set of IUPAC ambiguity codes:
        # each class scores over EXACT base-(4+D) subset tables
        # (models/frame.fragment_table_codes) — the subset-exact
        # refinement of the reference's imm_dna_iupac scan alphabet
        # (hmm.c:72-73).  Each class sorts by length DESCENDING so a tile
        # of reads shares a length profile.
        from deciphon_tpu.models.alphabet import encode_extended

        encoded = []
        classes: dict[tuple, list[int]] = {}
        for si, rec in enumerate(seqs):
            enc, cds = encode_extended(rec.data)
            encoded.append(enc)
            classes.setdefault(cds, []).append(si)

        counters = trace.ScanCounters()
        # (seq_ids, blk, codes, alt_dev, null_dev): every dispatch queued
        # before any host sync so device compute pipelines across blocks
        pending: list[tuple[list[int], _Block, tuple, object, object]] = []
        for codes in sorted(classes):
            seq_ids = sorted(classes[codes], key=lambda si: -len(encoded[si]))
            base = 4 + len(codes)
            n = len(seq_ids)
            Lp = pad_seq_len(max(len(encoded[si]) for si in seq_ids))
            S = pad_batch(n)
            eidx = np.full((S, Lp, 5), frag_sentinel(base), np.int32)
            for row, si in enumerate(seq_ids):
                eidx[row] = vj.end_fragment_indices(
                    fragment_indices(encoded[si], pad_to=Lp, base=base),
                    base=base,
                )
            slen = np.ones(S, np.int32)
            slen[:n] = [len(encoded[si]) for si in seq_ids]
            deidx, dslen = self._put_reads(eidx, slen)
            for blk in self._blocks:
                counters.consume(
                    int(slen[:n].sum()),
                    int(self.db.core_sizes[blk.chunk].sum()),
                    self.backend.dispatched_cells(
                        blk.kpad, len(blk.chunk), slen, Lp
                    ),
                )
                alt, null = self._dispatch(blk, codes, deidx, dslen, n)
                pending.append((seq_ids, blk, codes, alt, null))
        self._counters = counters
        return encoded, pending

    def _finish_scan(self) -> None:
        """Post-sync bookkeeping shared by scan/best_hits: extended tables
        are ~3x the base-4 footprint, so drop them rather than let one
        ambiguous read pin the whole DB twice."""
        for blk in self._blocks:
            for codes in [c for c in blk.dev if c]:
                del blk.dev[codes]
        self._counters.report()

    def _gate_and_traceback(
        self, seqs: Sequence[SeqRecord], encoded: list, pending: list
    ) -> list[Hit]:
        p = self.params
        # single host-sync pass: LRT gate, then pass-2 traceback of the
        # survivors batched by (kpad, length-bucket, codes) — one jitted
        # backpointer dispatch per group instead of one per hit
        survivors: list[tuple] = []
        for seq_ids, blk, codes, alt, null in pending:
            alt = np.asarray(alt, dtype=np.float64)
            null = np.asarray(null, dtype=np.float64)
            lrt = xmath.lrt(null, alt)
            ok = np.isfinite(lrt) & (lrt >= p.lrt_threshold)
            ok &= alt > vj.NEG / 2
            if self.progress is not None:
                self.progress.consume(len(seq_ids) * len(blk.chunk))
            for si_local, bi in np.argwhere(ok):
                si = seq_ids[int(si_local)]
                gi = int(blk.chunk[int(bi)])
                survivors.append(
                    (
                        si, gi, codes,
                        float(alt[si_local, bi]),
                        float(null[si_local, bi]),
                        float(lrt[si_local, bi]),
                    )
                )
        hits = self._traceback_all(seqs, encoded, survivors)
        self._finish_scan()
        hits.sort(key=lambda h: (h.seq_idx, h.profile_idx))
        return hits

    def _traceback_all(
        self, seqs: Sequence[SeqRecord], encoded: list, survivors: list
    ) -> list[Hit]:
        """Pass-2 traceback of all LRT survivors.

        Default path batches survivors by (kpad, length-bucket, codes)
        and runs ONE jitted backpointer DP per group (the reference
        tracebacks per hit, scan_thread.c:125-129 — fine at production
        thresholds, serial at permissive ones)."""
        hits: list[Hit] = []
        if self.traceback == "oracle":
            for si, gi, codes, alt, null, lrt in survivors:
                prof = self.db.profile(gi)
                res = vr.viterbi_alt(
                    prof, encoded[si],
                    multi_hits=self.params.multi_hits,
                    hmmer3_compat=self.params.hmmer3_compat,
                    codes=codes,
                )
                hits.append(
                    self._hit(seqs[si], si, gi, prof, alt, null, lrt, res)
                )
            return hits
        from deciphon_tpu.ops import viterbi_trace as vtr

        groups: dict[tuple, list] = {}
        for item in survivors:
            si, gi = item[0], item[1]
            key = (
                self._kpad_of[gi],
                pad_seq_len(len(encoded[si])),
                item[2],
            )
            groups.setdefault(key, []).append(item)
        for (kpad, Lp, codes), items in groups.items():
            profs = [self.db.profile(gi) for _, gi, *_ in items]
            results = vtr.viterbi_alt_batch(
                profs,
                [encoded[si] for si, *_ in items],
                multi_hits=self.params.multi_hits,
                hmmer3_compat=self.params.hmmer3_compat,
                kpad=kpad, pad_to=Lp, codes=codes,
            )
            for (si, gi, _, alt, null, lrt), prof, res in zip(
                items, profs, results
            ):
                hits.append(
                    self._hit(seqs[si], si, gi, prof, alt, null, lrt, res)
                )
        return hits

    def _hit(self, rec, si, profile_idx, prof, alt, null, lrt, res) -> Hit:
        match = codec.render_match(codec.match_steps(prof, rec.data, res.path))
        return Hit(
            seq_id=rec.seq_id,
            seq_idx=si,
            profile_idx=profile_idx,
            accession=prof.accession,
            alt_loglik=alt,
            null_loglik=null,
            lrt=lrt,
            path=res.path,
            match=match,
        )
