"""Tiling load balance, on device.

What the reference does: moves whole tiles between MPI ranks when a rank is
overloaded, tracked by a replicated owner table (Auxiliar_functions.cpp:
242-272, PIC_2D.cpp:398-412), with a hard-coded trigger policy.

Why the problem is different here: tile->shard placement is static (a
shard's field block is its tiles), and the particle advance walks whole
buckets, so per-device advance work follows bucket capacity; live
particles set the re-bin and exchange volume, and would set the advance
cost too under an occupancy-bounded advance.  Load balance therefore has
two axes:

* **capacity waste** — bucket size K must cover the most crowded tile and
  buffers scale with K (memory, re-bin slot costs);
* **work skew** — max/mean live particles per shard (StepDiag.shard_live,
  RunHistory.live_skew).  Weighted loading equalizes the *initial* count
  distribution; dynamic bunching (two-stream saturation, wakefield
  snowplow) can still concentrate particles onto one device; striped
  placement (parallel/balanced.py) spreads them.

The mechanisms:

1. **Census** (this module): per-tile live counts and occupancy statistics,
   on device, psum-aggregated — the observable the reference never had
   (it *proposed* MPI_Wtime-driven balancing as future work, report §5);
   plus the per-shard work census in every StepDiag.
2. **Re-binning** (particles/binning.py + parallel/exchange.py): keeps
   every particle in the bucket of the tile that owns its cells — the
   mechanism that replaces tile migration, run every rebin_interval steps.
3. **Adaptive capacity** (this module): when occupancy approaches K (or
   overflow drops particles), grow the buckets between jitted segments —
   the bounded-recompile answer to dynamic shapes (SURVEY.md §7 hard
   part #2).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.state import ParticleState


class LoadStats(NamedTuple):
    total: int  # live particles
    max_tile: int  # most crowded tile
    mean_tile: float
    capacity: int
    occupancy: float  # max_tile / capacity
    imbalance: float  # max_tile / mean_tile (1.0 = perfectly uniform)


def census(p: ParticleState) -> LoadStats:
    """Host-side load statistics for one species (works on sharded arrays —
    jnp reductions run distributed and replicate the scalars)."""
    counts = jnp.sum((p.w > 0).astype(jnp.int32), axis=1)
    total = int(counts.sum())
    mx = int(counts.max())
    mean = total / max(1, p.num_tiles)
    return LoadStats(
        total=total,
        max_tile=mx,
        mean_tile=mean,
        capacity=p.capacity,
        occupancy=mx / p.capacity,
        imbalance=mx / max(mean, 1e-9),
    )


def positional_tile_counts(p: ParticleState, tiling, row0: int = 0, col0: int = 0) -> jax.Array:
    """Live particles per *destination* tile — the POSITIONAL census (which
    tile each particle belongs to now), as opposed to bucket occupancy:
    between re-bins a drifted particle sits in a stale bucket.  Runs fully
    on device ([T] int32 counts); callers pull at most T scalars, never the
    position arrays (a host-side variant would pull ~2.4 GB per shrink
    attempt at 1e8 particles)."""
    col = jnp.clip(
        jnp.floor(p.x / tiling.tile_nx).astype(jnp.int32) - col0,
        0, tiling.tile_cols - 1,
    )
    row = jnp.clip(
        jnp.floor(p.y / tiling.tile_ny).astype(jnp.int32) - row0,
        0, tiling.tile_rows - 1,
    )
    tid = (row * tiling.tile_cols + col).ravel()
    alive = (p.w > 0).ravel().astype(jnp.int32)
    return jnp.zeros(tiling.num_tiles, jnp.int32).at[tid].add(alive)


def with_capacity(p: ParticleState, new_cap: int, tiling=None) -> ParticleState:
    """Grow or shrink bucket capacity.  Growth pads with dead slots; shrink
    compacts by re-binning the slot pool into the smaller buckets (requires
    `tiling`, and every tile's live count must fit — checked, since losing
    particles to a *shrink* would be absurd).  Host-side, outside jit."""
    cap = p.capacity
    if new_cap == cap:
        return p
    if new_cap > cap:
        def grow(a):
            return jnp.pad(a, ((0, 0), (0, new_cap - cap)))

        return ParticleState(*(grow(a) for a in p))
    if tiling is None:
        raise ValueError("shrinking requires the tiling (to re-bin at the new capacity)")
    from ..particles.binning import rebin_flat

    # The fit check must use the POSITIONAL census (which tile each
    # particle belongs to now), not bucket occupancy: between re-bins a
    # drifted particle sits in a stale bucket, and rebin_flat sorts by
    # position — a bucket-count check would pass while the destination
    # tile overflows.  Device-side reduction; only one scalar crosses to
    # the host.
    max_live = int(positional_tile_counts(p, tiling).max())
    if max_live > new_cap:
        raise ValueError(f"cannot shrink to {new_cap}: a tile holds {max_live} live particles")
    flat = jax.tree_util.tree_map(lambda a: a.reshape(p.num_tiles * cap), p)
    out, ovf = rebin_flat(
        flat,
        tile_rows=tiling.tile_rows,
        tile_cols=tiling.tile_cols,
        tile_nx=tiling.tile_nx,
        tile_ny=tiling.tile_ny,
        capacity=new_cap,
    )
    if int(ovf) != 0:
        raise RuntimeError("shrink overflow despite positional census check")
    return out


class CapacityManager:
    """Grow-on-pressure policy: watches StepDiag.overflow and occupancy and
    reallocates buckets between jitted segments.

    Every growth invalidates the compiled step (shapes change) — the driver
    re-jits; growth is geometric so the number of recompiles over a run is
    O(log(final/initial)).
    """

    def __init__(
        self,
        high_water: float = 0.9,
        growth: float = 1.5,
        check_every: int = 50,
        low_water: float = 0.35,
        shrink_patience: int = 4,
        shrink_headroom: float = 1.4,
    ):
        self.high_water = high_water
        self.growth = growth
        self.check_every = check_every
        self.low_water = low_water
        self.shrink_patience = shrink_patience
        self.shrink_headroom = shrink_headroom
        self._calm = 0  # consecutive low-occupancy checks

    def plan(self, stats: LoadStats, overflow: int) -> Optional[int]:
        """Return a new capacity if a change is warranted, else None.

        Growth fires immediately on overflow or high occupancy.  Shrink
        (closing the capacity lifecycle: a transient hot spot must not
        inflate every tile's dense compute forever) waits out
        `shrink_patience` consecutive calm checks, then resizes to the
        observed peak plus headroom — hysteresis between low_water and
        1/shrink_headroom prevents flapping."""
        if overflow > 0 or stats.occupancy >= self.high_water:
            self._calm = 0
            need = max(stats.max_tile + overflow, int(stats.capacity * self.growth))
            return -(-need // 8) * 8
        if stats.occupancy < self.low_water:
            self._calm += 1
            if self._calm >= self.shrink_patience:
                self._calm = 0
                want = max(8, int(stats.max_tile * self.shrink_headroom))
                want = -(-want // 8) * 8
                if want < stats.capacity:
                    return want
        else:
            self._calm = 0
        return None
