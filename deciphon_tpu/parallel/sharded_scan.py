"""SPMD sharded scan step over a ('seqs', 'profiles') mesh.

Each device scores its (read-shard x profile-shard) tile with the batched
Viterbi, then per-read best hits merge across the profile axis with
max/argmax collectives — the SPMD analogue of the reference's
share-nothing OpenMP partitions + merged product files
(src/server/scan.c:239-258, src/server/prod.c:106-145).  The full LRT
matrix stays sharded for the host to fetch hit coordinates from.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from deciphon_tpu.ops import viterbi_jax as vj


def _local_step(block_row, eidx, seq_len, multi_hits, hmmer3_compat):
    block = vj.ProfileBlock(*block_row)
    alt, null = vj.viterbi_scores(
        block, eidx, seq_len,
        multi_hits=multi_hits, hmmer3_compat=hmmer3_compat,
    )
    lrt = -2.0 * (null - alt)
    lrt = jnp.where(alt > vj.NEG / 2, lrt, -jnp.inf)

    # per-read best hit across the local then global profile axis
    local_best = jnp.max(lrt, axis=1)
    local_arg = jnp.argmax(lrt, axis=1).astype(jnp.int32)
    # globalize the argmax: lexicographic (score, -index) max via pmax
    nlocal = lrt.shape[1]
    shard = jax.lax.axis_index("profiles")
    global_arg = local_arg + shard * nlocal
    best = jax.lax.pmax(local_best, "profiles")
    # winner shard contributes its index; others -1; pmax picks it
    arg = jnp.where(local_best >= best, global_arg, -1)
    arg = jax.lax.pmax(arg, "profiles")
    return alt, null, lrt, best, arg


@functools.partial(
    jax.jit, static_argnames=("mesh", "multi_hits", "hmmer3_compat")
)
def _sharded_step(mesh, block, eidx, seq_len, *, multi_hits,
                  hmmer3_compat):
    block_specs = tuple(P("profiles") for _ in range(len(block)))
    fn = jax.shard_map(
        functools.partial(
            _local_step,
            multi_hits=multi_hits,
            hmmer3_compat=hmmer3_compat,
        ),
        mesh=mesh,
        in_specs=(block_specs, P("seqs"), P("seqs")),
        out_specs=(
            P("seqs", "profiles"),
            P("seqs", "profiles"),
            P("seqs", "profiles"),
            P("seqs"),
            P("seqs"),
        ),
        check_vma=False,
    )
    return fn(block, eidx, seq_len)


def sharded_scan_step(
    mesh: Mesh,
    block: vj.ProfileBlock,
    eidx,
    seq_len,
    multi_hits: bool = True,
    hmmer3_compat: bool = False,
):
    """Run one fully-sharded scan step.

    block arrays must have their leading (profile) axis divisible by the
    'profiles' mesh axis; eidx/seq_len leading (seq) axis divisible by
    'seqs'.  Returns (alt [S,B], null [S,B], lrt [S,B], best_lrt [S],
    best_profile [S]) with the matrices sharded over the mesh.

    The jit is module-cached with the mesh static: wrapping a fresh
    ``jax.jit(shard_map(...))`` closure per call (the round-1..4 form)
    retraced the whole step EVERY call, an overhead that grew with the
    device count and polluted the scaling harness (VERDICT r4 #5).
    """
    return _sharded_step(
        mesh, tuple(block), eidx, seq_len,
        multi_hits=multi_hits, hmmer3_compat=hmmer3_compat,
    )


def shard_block(mesh: Mesh, block: vj.ProfileBlock) -> vj.ProfileBlock:
    """device_put a profile block sharded over the 'profiles' axis."""
    sh = NamedSharding(mesh, P("profiles"))
    return vj.ProfileBlock(*(jax.device_put(a, sh) for a in block))


def shard_seqs(mesh: Mesh, eidx, seq_len):
    sh = NamedSharding(mesh, P("seqs"))
    return jax.device_put(eidx, sh), jax.device_put(seq_len, sh)
