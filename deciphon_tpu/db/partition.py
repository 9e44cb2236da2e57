"""Profile partitioning and padding buckets.

Two layers of work division:

- ``balanced_partitions``: contiguous, size-balanced partitions by prefix
  sums of per-profile weights — the tensor analogue of the reference's
  profile_reader partitioning (src/db/profile_reader.c:44-72 over
  profile byte sizes, limits ceiling NUM_THREADS=64).  Used to shard the
  DB across devices/hosts.
- ``bucket_by_core_size`` / ``pack_blocks``: group profiles into padded
  core-width tiers, one dispatch block per tier (the reference has no
  analogue — its DP is per-profile sparse; dense batching makes padding
  economics matter, SURVEY.md §7 hard part (d)).
"""

from __future__ import annotations

import numpy as np


def balanced_partitions(weights: np.ndarray, nparts: int) -> list[range]:
    """Split indices 0..N-1 into <= nparts contiguous ranges with roughly
    equal total weight (greedy prefix walk against the ideal boundary).
    ``nparts`` is clamped to NUM_PARTITIONS_MAX, the reference's thread /
    partition ceiling (core/limits.h:8 via profile_reader_setup)."""
    from deciphon_tpu.utils.limits import NUM_PARTITIONS_MAX

    weights = np.asarray(weights, dtype=np.float64)
    n = len(weights)
    nparts = max(1, min(nparts, n, NUM_PARTITIONS_MAX))
    total = float(weights.sum())
    csum = np.concatenate([[0.0], np.cumsum(weights)])
    bounds = [0]
    for p in range(1, nparts):
        target = total * p / nparts
        # first index whose prefix sum reaches the target
        j = int(np.searchsorted(csum, target, side="left"))
        j = max(bounds[-1] + 1, min(j, n - (nparts - p)))
        bounds.append(j)
    bounds.append(n)
    return [range(bounds[i], bounds[i + 1]) for i in range(nparts)]


def pad_core_size(k: int) -> int:
    """Padded core width of a profile block: the next power of two >= k,
    at least 32.  The GPU kernel holds a block's whole padded core in one
    Triton tile, whose shape must be a power of two
    (ops/viterbi_gpu.py); the XLA engine shares the same tiers."""
    p = 32
    while p < k:
        p *= 2
    return p


def pack_blocks(
    core_sizes: np.ndarray, max_lanes: int | None = None
) -> list[tuple[int, np.ndarray]]:
    """Dispatch blocks: profiles of one core-width tier
    (``bucket_by_core_size``), split so that no block holds more than
    ``max_lanes`` padded nodes.  Returns [(kpad, profile indices)], every
    index exactly once."""
    out = []
    for kpad, idxs in bucket_by_core_size(core_sizes).items():
        step = len(idxs) if max_lanes is None else max(1, max_lanes // kpad)
        for lo in range(0, len(idxs), step):
            out.append((kpad, idxs[lo : lo + step]))
    return out


def bucket_by_core_size(core_sizes: np.ndarray) -> dict[int, np.ndarray]:
    """Group profile indices by padded core size.

    Returns {kpad: sorted array of profile indices}.
    """
    core_sizes = np.asarray(core_sizes)
    buckets: dict[int, list[int]] = {}
    for i, k in enumerate(core_sizes):
        kp = pad_core_size(int(k))
        buckets.setdefault(kp, []).append(i)
    return {k: np.asarray(v, dtype=np.int64) for k, v in sorted(buckets.items())}
