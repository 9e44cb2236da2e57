"""Device mesh construction for scans.

The scan's two data axes map onto a 2-D jax.sharding.Mesh:

  'profiles' — shards the profile database (the tensor analogue of the
      reference's <=64 contiguous DB partitions, src/db/profile_reader.c);
  'seqs'    — data-parallel over the read batch (the reference scans one
      sequence at a time on all threads, src/server/scan.c:227-258; here
      reads batch across devices).

Small DBs replicate over 'profiles' (set profile_axis=1); large DBs shard.
Multi-host runs extend the same mesh over jax.distributed processes — all
collectives go to NCCL between GPUs and across hosts automatically.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_scan_mesh(
    profile_axis: int | None = None,
    seq_axis: int | None = None,
    devices=None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if profile_axis is None and seq_axis is None:
        # favor sequence data-parallelism; shard profiles on the rest
        seq_axis = 1
        while seq_axis * 2 <= n and (n // (seq_axis * 2)) * (seq_axis * 2) == n:
            seq_axis *= 2
        profile_axis = n // seq_axis
    elif profile_axis is None:
        profile_axis = n // seq_axis
    elif seq_axis is None:
        seq_axis = n // profile_axis
    if profile_axis * seq_axis != n:
        raise ValueError(
            f"mesh {profile_axis}x{seq_axis} != {n} devices"
        )
    arr = np.array(devices).reshape(seq_axis, profile_axis)
    return Mesh(arr, ("seqs", "profiles"))
