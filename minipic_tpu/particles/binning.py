"""Particle re-binning into fixed-capacity tile buckets — the on-device
load-balance mechanism.

The reference balances load by migrating whole tiles between MPI ranks
through blocking sends and a replicated owner table
(removeTileFromRank/addTileToRank, Auxiliar_functions.cpp:242-272;
owner re-sync PIC_2D.cpp:398-412).  Here the equivalent invariant — "a
tile's identity is its (row, col); physics is independent of where its
particles are stored" (SURVEY.md §7) — is maintained *inside* the arrays:
particles are sorted by destination tile ID into a static
(num_tiles, capacity) layout whenever the re-bin schedule fires.  Cost: one
multi-operand sort over the flat slot space, O(N log N) on device, no host
round-trips, jit-stable shapes.

Boundary handling happens here too (the only place positions are wrapped):
periodic wrap, or absorption (w := 0) for open boundaries.

Overflow: if more particles target a tile than its capacity, the excess is
dropped and counted (returned so drivers can grow capacity between jitted
segments — dynamic shapes are not available inside jit).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.geometry import Tiling
from ..core.state import ParticleState


def wrap_positions(p: ParticleState, nx: int, ny: int, periodic: bool) -> ParticleState:
    """Apply the box boundary to raw (unwrapped) positions in cell units.

    f32 gotcha: jnp.mod(a, n) can round to exactly n for a just below n,
    yielding an out-of-grid position that downstream binning would treat as
    off-grid (silently dropped, or worse).  Clamp the == n edge to 0.
    """
    if periodic:
        x = jnp.mod(p.x, nx)
        y = jnp.mod(p.y, ny)
        x = jnp.where(x >= nx, x - nx, x)
        y = jnp.where(y >= ny, y - ny, y)
        return p._replace(x=x, y=y)
    inside = (p.x >= 0) & (p.x < nx) & (p.y >= 0) & (p.y < ny)
    return p._replace(
        w=jnp.where(inside, p.w, 0.0),
        x=jnp.clip(p.x, 0.0, nx - 1e-3),
        y=jnp.clip(p.y, 0.0, ny - 1e-3),
    )


def rebin_flat(
    flat: ParticleState,
    *,
    tile_rows: int,
    tile_cols: int,
    tile_nx: int,
    tile_ny: int,
    capacity: int,
    row0=0,
    col0=0,
    method: str = "sort",
) -> Tuple[ParticleState, jax.Array]:
    """Sort a flat slot pool into (tile_rows*tile_cols, capacity) buckets.

    Tile indices derive from *global* positions minus the (row0, col0) tile
    offset of this (shard-local) tile grid — the sharded path reuses the
    same sort with traced offsets.  Slots landing outside the local grid or
    with w == 0 are dropped silently (off-grid slots must have been routed
    away beforehand); capacity overflow is counted and returned.
    """
    num_tiles = tile_rows * tile_cols
    col = jnp.floor(flat.x / tile_nx).astype(jnp.int32) - col0
    row = jnp.floor(flat.y / tile_ny).astype(jnp.int32) - row0
    in_grid = (col >= 0) & (col < tile_cols) & (row >= 0) & (row < tile_rows)
    tid = (row * tile_cols + col).astype(jnp.int32)
    return rebin_by_tid(flat, tid, in_grid, num_tiles, capacity, method)


def rebin_by_tid(
    flat: ParticleState,
    tid: jax.Array,
    in_grid: jax.Array,
    num_tiles: int,
    capacity: int,
    method: str = "sort",
) -> Tuple[ParticleState, jax.Array]:
    """Filler-key sort with caller-supplied destination buckets: `tid` is
    each slot's local bucket index and `in_grid` whether the slot belongs
    to this shard at all.  rebin_flat derives (tid, in_grid) from positions
    on a contiguous local tile grid; the striped/balanced placement
    (parallel/balanced.py) derives them from an arbitrary gid -> local
    map.  Semantics otherwise identical to rebin_flat.

    `method`: jnp.searchsorted's method for the filler lookup.  Results do
    not depend on it; "sort" was the fastest of "sort", "scan" (bisection)
    and "compare_all" on an H100 at the headline deck (1.1e8 slots into
    4,096 tiles: 251, 260 and 306 ms per re-bin)."""
    n = flat.x.shape[0]
    out_n = num_tiles * capacity
    assert n >= out_n, "slot pool smaller than bucket space"

    alive = (flat.w > 0) & in_grid
    # Live slots *outside* the grid must not exist (wrap/routing handles
    # them); if any slip through, the filler bookkeeping below would assign
    # them as live-weight "fillers" in arbitrary buckets.  Force the slow
    # path and count them.
    off_grid_live = jnp.sum(((flat.w > 0) & ~in_grid).astype(jnp.int32))

    # ONE multi-operand sort whose result is already the bucket layout.
    # Trick: assign every dead slot a *filler key* chosen so tile t
    # receives exactly (capacity - count_t) fillers; then the stable sort
    # emits exactly `capacity` elements per tile and bucketizing is a
    # reshape — no gathers, no scatters.
    #
    # Fast path precondition: no tile over capacity.  Overflow is detected
    # from the key-only pre-sort and handled by a gather-based slow path
    # under lax.cond (rare; pays ~6 gathers only when it actually happens).
    key_alive = jnp.where(alive, tid, num_tiles)
    sorted_keys = jnp.sort(key_alive)
    starts = jnp.searchsorted(sorted_keys, jnp.arange(num_tiles + 1, dtype=jnp.int32))
    counts = starts[1:] - starts[:num_tiles]
    overflow = jnp.sum(jnp.maximum(counts - capacity, 0)).astype(jnp.int32)

    payload = tuple(flat)

    def fast(_):
        fill = capacity - jnp.minimum(counts, capacity)  # [T]
        fill_cum = jnp.cumsum(fill)
        dead_rank = jnp.cumsum((~alive).astype(jnp.int32))  # 1-based among dead
        filler_tid = jnp.searchsorted(
            fill_cum, dead_rank, side="left", method=method
        ).astype(jnp.int32)
        # Alive keys 2t sort before filler keys 2t+1, so each bucket comes
        # out *live-compacted* (live slots first) — which lets the fused
        # kernels bound their trip counts by per-tile occupancy.
        keys = jnp.where(alive, 2 * tid, 2 * filler_tid + 1)
        s = jax.lax.sort((keys,) + payload, num_keys=1)
        return tuple(a[:out_n].reshape(num_tiles, capacity) for a in s[1:])

    def slow(_):
        order = jnp.argsort(key_alive)
        src = order[
            jnp.minimum(starts[:num_tiles, None] + jnp.arange(capacity)[None, :], n - 1)
        ]
        valid = jnp.arange(capacity)[None, :] < counts[:, None]
        return tuple(jnp.where(valid, a[src], 0) for a in payload)

    outs = jax.lax.cond((overflow == 0) & (off_grid_live == 0), fast, slow, None)
    return ParticleState(*outs), (overflow + off_grid_live).astype(jnp.int32)


def rebin(p: ParticleState, tiling: Tiling,
          method: str = "sort") -> Tuple[ParticleState, jax.Array]:
    """Single-device re-binning over the full tile grid."""
    flat = jax.tree_util.tree_map(lambda a: a.reshape(p.num_tiles * p.capacity), p)
    return rebin_flat(
        flat,
        tile_rows=tiling.tile_rows,
        tile_cols=tiling.tile_cols,
        tile_nx=tiling.tile_nx,
        tile_ny=tiling.tile_ny,
        capacity=p.capacity,
        method=method,
    )


def tile_counts(p: ParticleState) -> jax.Array:
    """Alive particles per tile — the load-balance observable (the
    reference's per-rank tile census, made a per-step on-device metric)."""
    return jnp.sum((p.w > 0).astype(jnp.int32), axis=1)
