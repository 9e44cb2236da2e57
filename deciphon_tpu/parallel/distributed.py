"""Multi-host (multi-process) scan over the JAX distributed runtime.

The reference scales out by running more share-nothing daemons against
one scheduler (SURVEY.md §5: job-level parallelism).  This rebuild
additionally scales a SINGLE scan across processes: every process calls
``initialize()``, the mesh spans all processes' devices (XLA hands the
collectives to NCCL between GPUs), profile shards are placed per process
with ``make_global_block``, and ``global_viterbi_scores`` runs one
globally-sharded scan step.

Exercised end-to-end over localhost CPU processes by
``benchmarks/scaling.py --multiprocess N`` and by
``tests/test_distributed.py`` (2 processes, score parity vs the
unsharded engine); ``--gpu`` gives each process one card.
"""

from __future__ import annotations

import os

import numpy as np


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
) -> None:
    """jax.distributed.initialize with DCP_* env fallbacks.

    Env: DCP_COORDINATOR (host:port), DCP_NUM_PROCS, DCP_PROC_ID — all
    three are required, nothing detects a cluster.  ``local_device_ids``
    gives this process its own GPUs (one process per card).
    """
    import jax

    coordinator = coordinator or os.environ.get("DCP_COORDINATOR")
    if num_processes is None and os.environ.get("DCP_NUM_PROCS"):
        num_processes = int(os.environ["DCP_NUM_PROCS"])
    if process_id is None and os.environ.get("DCP_PROC_ID"):
        process_id = int(os.environ["DCP_PROC_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_scan_mesh(profile_axis: int | None = None):
    """('seqs' x 'profiles') mesh over ALL processes' devices."""
    from deciphon_tpu.parallel.mesh import make_scan_mesh

    return make_scan_mesh(profile_axis=profile_axis)


def make_global_array(mesh, spec, host_array: np.ndarray):
    """Globally-sharded jax.Array from identical per-process host data.

    Every process passes the same full ``host_array`` (deterministic
    build or broadcast); each contributes only its addressable shards.
    """
    import jax
    from jax.sharding import NamedSharding

    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        host_array.shape, sh, lambda idx: host_array[idx]
    )


def _pad_axis0(a: np.ndarray, mult: int, fill) -> np.ndarray:
    n = a.shape[0]
    extra = -(-n // mult) * mult - n
    if not extra:
        return a
    pad = np.full((extra,) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def make_global_block(mesh, block):
    """ProfileBlock sharded over the global 'profiles' axis (padded to
    the axis size so every process holds equal shards)."""
    from jax.sharding import PartitionSpec as P

    from deciphon_tpu.ops import viterbi_jax as vj

    dp = mesh.shape["profiles"]
    return vj.ProfileBlock(
        *(
            make_global_array(
                mesh, P("profiles"),
                _pad_axis0(np.asarray(a), dp,
                           1 if np.asarray(a).dtype == np.int32 else vj.NEG),
            )
            for a in block
        )
    )


def global_viterbi_scores(
    mesh,
    block,  # host (numpy) ProfileBlock, identical on every process
    eidx: np.ndarray,
    seq_len: np.ndarray,
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
    dev_block=None,
):
    """One globally-sharded XLA-engine scan step across all processes.

    The multi-process counterpart of the ScanEngine's mesh dispatch
    (ops/scan_engine._score): inputs are assembled with
    make_array_from_callback (device_put cannot address other processes'
    devices) and the same shard_map program runs SPMD over the global
    mesh.  Returns the sharded [S, B] score matrices (each process holds
    its addressable shards).
    """
    from jax.sharding import PartitionSpec as P

    from deciphon_tpu.ops import scan_engine as se
    from deciphon_tpu.ops import viterbi_jax as vj

    ds = mesh.shape["seqs"]
    B = block.fm.shape[0]
    S = eidx.shape[0]
    if dev_block is None:
        dev_block = tuple(make_global_block(mesh, block))
    eidx_p = _pad_axis0(np.asarray(eidx, np.int32), ds, 0)
    slen_p = _pad_axis0(np.asarray(seq_len, np.int32), ds, 1)
    deidx = make_global_array(mesh, P("seqs"), eidx_p)
    dslen = make_global_array(mesh, P("seqs"), slen_p)
    alt, null = se._score(
        se.XlaBackend(), mesh, vj.ProfileBlock(*dev_block), deidx, dslen,
        multi_hits=multi_hits, hmmer3_compat=hmmer3_compat, semiring="max",
    )
    return alt[:S, :B], null[:S, :B]


def worker_parity_check(
    nprofiles: int = 8, nseqs: int = 6, core: int = 5, seq_len: int = 40
):
    """Run one globally-sharded scan step and assert this process's
    addressable score shards match the unsharded local engine.

    Called inside an initialized multi-process runtime (every process
    runs it); returns (seconds, cells) for throughput accounting.  Used
    by tests/test_distributed.py and benchmarks/scaling.py
    --multiprocess.
    """
    import time

    from deciphon_tpu.models.alphabet import DNA
    from deciphon_tpu.models.h3reader import build_profile
    from deciphon_tpu.models.h3writer import random_h3
    from deciphon_tpu.ops import viterbi_jax as vj
    from deciphon_tpu.ops.emissions import fragment_indices

    rng = np.random.default_rng(7)
    profiles = [
        build_profile(random_h3(s + 1, core, peak=0.8))
        for s in range(nprofiles)
    ]
    block = vj.build_profile_block(profiles)
    seqs = ["".join(rng.choice(list("ACGT"), seq_len)) for _ in range(nseqs)]
    eidx = np.stack(
        [
            vj.end_fragment_indices(
                fragment_indices(DNA.encode(s), pad_to=seq_len)
            )
            for s in seqs
        ]
    )
    slen = np.array([len(s) for s in seqs], np.int32)

    mesh = global_scan_mesh()
    dev_block = tuple(make_global_block(mesh, block))
    t0 = time.perf_counter()
    alt, null = global_viterbi_scores(
        mesh, block, eidx, slen, dev_block=dev_block
    )
    null.block_until_ready()
    dt = time.perf_counter() - t0

    # parity: every addressable shard vs a purely-local unsharded run
    import jax

    ref_alt, ref_null = vj.viterbi_scores(
        block, jax.numpy.asarray(eidx), jax.numpy.asarray(slen)
    )
    ref_alt = np.asarray(ref_alt)
    ref_null = np.asarray(ref_null)
    checked = 0
    for arr, ref in ((alt, ref_alt), (null, ref_null)):
        for shard in arr.addressable_shards:
            got = np.asarray(shard.data)
            want = ref[shard.index]
            np.testing.assert_allclose(got, want, atol=1e-5)
            checked += got.size
    assert checked > 0
    cells = float(nseqs) * nprofiles * seq_len * core * 3
    return dt, cells
