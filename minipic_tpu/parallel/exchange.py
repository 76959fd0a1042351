"""Cross-shard particle routing — the on-device descendant of tile migration.

The reference moves *tiles* between ranks (blocking MPI sends of the tile
payload + a replicated owner table, Auxiliar_functions.cpp:242-272,
PIC_2D.cpp:398-412).  Here tile placement is static and the *particles*
move: when a particle's position leaves its shard's block, it is packed
into a fixed-capacity directional buffer and shipped to the neighbor chip
with lax.ppermute, then merged into the destination shard's next re-binning
sort.  Like the halo exchange, diagonal routes compose from an x-hop and a
y-hop (two-pass), so 8 directions cost 4 collectives.

Runs inside shard_map over ('ry', 'rx').  All shapes are static: buffers
hold `cap` slots per direction; overflow is counted, never reordered into
dynamic shapes (the same fixed-capacity discipline as the tile buckets,
SURVEY.md §7 hard part #2).

CFL bounds displacement to <1 cell/step, so a destination shard is always
a (periodic) mesh neighbor provided rebinning happens at least every
`shard_block/1` steps — in practice every 1-8 steps.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.state import ParticleState
from .halo import _shift

_NF = 6  # x, y, px, py, pz, w


def _pack(p_flat: ParticleState, dr, dc, cap: int):
    """Pack off-shard particles into [3, 3, 6, cap] directional buffers.

    dr/dc in {-1, 0, +1}; (0, 0) entries stay local (not packed).  Returns
    (buffers, stay_mask, n_dropped)."""
    moving = ((dr != 0) | (dc != 0)) & (p_flat.w > 0)
    dir9 = (dr + 1) * 3 + (dc + 1)  # 4 == local
    dir9 = jnp.where(moving, dir9, 4)
    # Rank within each direction via one-hot cumulative counts.
    onehot = (dir9[:, None] == jnp.arange(9)[None, :]) & moving[:, None]
    rank = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - 1
    rank = jnp.take_along_axis(rank, dir9[:, None], axis=1)[:, 0]
    dropped = jnp.sum(moving & (rank >= cap)).astype(jnp.int32)
    dest = jnp.where(moving & (rank < cap), dir9 * cap + rank, 9 * cap)

    fields = jnp.stack(tuple(p_flat))  # [6, N]
    buf = jnp.zeros((_NF, 9 * cap + 1), fields.dtype)
    buf = buf.at[:, dest].set(jnp.where(moving, fields, 0.0), mode="drop")
    buf = buf[:, : 9 * cap].reshape(_NF, 3, 3, cap).transpose(1, 2, 0, 3)
    return buf, ~moving, dropped


def _route(buf, rows: int, cols: int):
    """Two-pass ppermute of the [3, 3, 6, cap] buffer array.  After
    routing, entry (dr+1, dc+1) on a shard holds the particles sent *to* it
    from shard (-dr, -dc) away — i.e. everything in the array belongs
    here."""
    # x pass: dc=-1 plane goes to the left neighbor, dc=+1 to the right.
    to_left = _shift(buf[:, 0], "rx", up=True, n=cols)
    to_right = _shift(buf[:, 2], "rx", up=False, n=cols)
    buf = jnp.stack([to_left, buf[:, 1], to_right], axis=1)
    # y pass
    to_up = _shift(buf[0], "ry", up=True, n=rows)
    to_down = _shift(buf[2], "ry", up=False, n=rows)
    return jnp.stack([to_up, buf[1], to_down], axis=0)


def exchange_particles(
    p: ParticleState,
    *,
    block_x0,
    block_y0,
    block_nx: int,
    block_ny: int,
    nx: int,
    ny: int,
    rows: int,
    cols: int,
    cap: int,
) -> Tuple[ParticleState, jax.Array]:
    """Ship off-shard particles to neighbor shards.

    p: local [T_local, K] buffers, positions global (already box-wrapped).
    block_x0/block_y0: this shard's cell-block origin (traced).
    Returns (merged, n_dropped): a flat local+received ParticleState of
    length T_local*K + 9*cap (dead slots padded with w=0), and the count of
    particles dropped (buffer overflow, or >1 shard-hop away — see below).
    Feed the result to the local re-binning sort.
    """
    n = p.num_tiles * p.capacity
    flat = jax.tree_util.tree_map(lambda a: a.reshape(n), p)

    # Destination shard offset with periodic minimal wrap.
    scol = jnp.floor_divide(flat.x.astype(jnp.int32), block_nx)
    srow = jnp.floor_divide(flat.y.astype(jnp.int32), block_ny)
    mycol = block_x0 // block_nx
    myrow = block_y0 // block_ny
    dc = scol - mycol
    dr = srow - myrow
    dc = dc - cols * jnp.rint(dc / cols).astype(jnp.int32) if cols > 1 else dc * 0
    dr = dr - rows * jnp.rint(dr / rows).astype(jnp.int32) if rows > 1 else dr * 0
    # Anything beyond one hop is unreachable this pass: count it as dropped
    # and kill it (w=0) so it is neither shipped one clipped hop with live
    # weight nor double-counted downstream as an off-grid-live slot.
    # Deck.validate + build_sharded_step bound drift so this cannot happen
    # for physical motion; it guards against corrupted positions.
    too_far = (jnp.abs(dc) > 1) | (jnp.abs(dr) > 1)
    n_too_far = jnp.sum(too_far & (flat.w > 0)).astype(jnp.int32)
    flat = flat._replace(w=jnp.where(too_far, 0.0, flat.w))
    dc = jnp.clip(dc, -1, 1)
    dr = jnp.clip(dr, -1, 1)

    buf, stay, dropped = _pack(flat, dr, dc, cap)
    dropped = dropped + n_too_far
    routed = _route(buf, rows, cols)  # [3,3,6,cap], all local now

    recv = routed.transpose(2, 0, 1, 3).reshape(_NF, 9 * cap)
    kept = jax.tree_util.tree_map(lambda a: jnp.where(stay, a, 0.0), flat)
    merged = ParticleState(
        *(jnp.concatenate([k, r]) for k, r in zip(tuple(kept), recv))
    )
    return merged, dropped
