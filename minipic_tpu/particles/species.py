"""Species loading: quiet-start lattice positions, profile weights, thermal
momenta.

The reference declares the per-particle contract (Particle struct,
Auxiliar_functions.h:16-21) and a per-tile particle container
(Tile.particles, :38-42) but never loads particles (SURVEY.md §0).  This
module is the loader its design implies, on device:

* Positions: a deterministic per-cell lattice ("quiet start") — ppc
  macroparticles at (i + (m+1/2)/ppc_x, j + (n+1/2)/ppc_y), which loads a
  noise-free uniform plasma (important for clean instability growth-rate
  benchmarks).
* Density profiles become *weights* by default: w = n(x,y) dxdy / ppc.
  Static shapes everywhere — vacuum regions carry w=0 slots rather than
  fewer particles.  SpeciesSpec(load_mode="count") flips this: constant
  weight, per-cell live counts thinned to the profile (the load-balance
  stress loader — per-tile work follows density).
* Momenta: drift + per-axis Gaussian thermal spread via jax.random,
  one independent key per species.

Normalization: with w = n dxdy / ppc, depositing rho = sum q w S / (dxdy)
over a uniform density-1 electron load gives rho = -1 per cell — matching
the field normalization (omega_p^2 = n0 = 1).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.config import SpeciesSpec
from ..core.geometry import Domain, Tiling
from ..core.state import ParticleState


def _lattice_factors(ppc: int) -> Tuple[int, int]:
    a = int(math.isqrt(ppc))
    while ppc % a != 0:
        a -= 1
    return a, ppc // a  # (per-x, per-y)


def _load_buckets(
    spec: SpeciesSpec,
    domain: Domain,
    tiling: Tiling,
    capacity: int,
    key: jax.Array,
    trow,
    tcol,
    x_abs_offset,
    dtype,
    row_keys=None,
) -> ParticleState:
    """Shared loader core: quiet-start lattice buckets for the tiles whose
    (row, col) coordinates are given ([B, 1] each).  The density profile
    and nothing else sees ABSOLUTE x (window frame + x_abs_offset), so
    the moving window's injected columns carry exactly the plasma a
    static run would have loaded there."""
    ppc_x, ppc_y = _lattice_factors(spec.ppc)
    nxt, nyt = tiling.tile_nx, tiling.tile_ny
    per_tile = spec.ppc * nxt * nyt
    if per_tile > capacity:
        raise ValueError(f"capacity {capacity} < ppc*tile cells = {per_tile}")
    nb = trow.shape[0]

    # Slot layout within a tile: slot = ((cy*nxt + cx)*ppc_y + m)*ppc_x + l
    slots = jnp.arange(per_tile)
    l = slots % ppc_x
    m = (slots // ppc_x) % ppc_y
    cell = slots // (ppc_x * ppc_y)
    cx = cell % nxt
    cy = cell // nxt
    # Tile-local lattice positions (cell units)
    xi = cx.astype(dtype) + (l.astype(dtype) + 0.5) / ppc_x
    eta = cy.astype(dtype) + (m.astype(dtype) + 0.5) / ppc_y

    x = tcol * nxt + xi[None, :]  # [B, per_tile], window-frame cells
    y = trow * nyt + eta[None, :]
    x_abs = x + jnp.asarray(x_abs_offset, dtype)

    # Weights from the density profile evaluated at physical coordinates.
    if spec.density is None:
        n = jnp.ones_like(x)
    else:
        n = jnp.asarray(spec.density(x_abs * domain.dx, y * domain.dy), dtype)
    if spec.load_mode == "count" and spec.density is not None:
        # Count-contrast loading: constant weight, thinned live counts.
        # Each cell keeps the first ~ppc * n/n_max of its ppc sub-lattice
        # particles (deterministic: sub-lattice rank (idx+1/2)/ppc <
        # n/n_max), so live counts follow the profile while every
        # survivor carries the same weight — per-tile work genuinely
        # contrasts (the load-balance stress axis).  The ceiling is the
        # DECLARED spec.n_max when given (mandatory for moving-window
        # decks, Deck.validate): a max over the evaluated domain would
        # make each injected column renormalize against its local max.
        n_max = (jnp.asarray(spec.n_max, dtype) if spec.n_max is not None
                 else jnp.max(n))
        sub_rank = ((m * ppc_x + l).astype(dtype) + 0.5) / spec.ppc
        keep = sub_rank[None, :] < (n / jnp.maximum(n_max, 1e-30))
        w = jnp.where(keep, n_max * (domain.dx * domain.dy / spec.ppc), 0.0)
    else:
        w = n * (domain.dx * domain.dy / spec.ppc)

    # Momenta: drift + thermal.
    kx, ky, kz = jax.random.split(key, 3)
    ux, uy, uz = spec.thermal_spread()
    shape = (nb, per_tile)

    def mom(k, uth, drift):
        if uth <= 0:
            return jnp.zeros(shape, dtype) + drift
        if row_keys is not None:
            # Per-GLOBAL-tile-row keyed draws: any decomposition of the
            # same rows (single device, or any mesh's row blocks) draws
            # bit-identical noise — the moving window's sharded and
            # single-device injections then agree exactly.
            def row(kr):
                return jax.random.normal(kr, (per_tile,), dtype) * uth

            keys = jax.vmap(lambda r: jax.random.fold_in(k, r))(row_keys)
            return jax.vmap(row)(keys) + drift
        return jax.random.normal(k, shape, dtype) * uth + drift

    px = mom(kx, ux, spec.ux)
    py = mom(ky, uy, spec.uy)
    pz = mom(kz, uz, spec.uz)

    if spec.load_mode == "count" and spec.density is not None:
        # Live-compact each bucket at load time: the thinned sub-lattice
        # leaves w==0 holes interleaved below the watermark, which the
        # occupancy-bounded kernels (dead-chunk gate, @pl.when occupancy
        # bound) cannot skip until the first re-bin compacts them — a
        # count-mode deck would otherwise pay full-capacity compute for
        # its first ~rebin-interval steps.  Stable partition (live slots
        # first, original order kept) so the load stays deterministic in
        # (key, absolute position); momenta were already drawn per
        # ORIGINAL slot, so thinning/compaction does not shift any
        # particle's noise.
        order = jnp.argsort(jnp.where(w > 0, 0, 1), axis=1, stable=True)
        x, y, px, py, pz, w = (
            jnp.take_along_axis(a, order, axis=1)
            for a in (x, y, px, py, pz, w))

    def pad(a):
        return jnp.pad(a.astype(dtype), ((0, 0), (0, capacity - per_tile)))

    return ParticleState(pad(x), pad(y), pad(px), pad(py), pad(pz), pad(w))


def load_species(
    spec: SpeciesSpec,
    domain: Domain,
    tiling: Tiling,
    capacity: int,
    key: jax.Array,
    dtype=jnp.float32,
) -> ParticleState:
    """Build a tile-bucketed ParticleState for one species."""
    t = jnp.arange(tiling.num_tiles)
    trow = (t // tiling.tile_cols).astype(dtype)[:, None]
    tcol = (t % tiling.tile_cols).astype(dtype)[:, None]
    return _load_buckets(spec, domain, tiling, capacity, key, trow, tcol,
                         0.0, dtype)


def counter_streaming_pair(
    spec: SpeciesSpec, drift: float, domain: Domain, tiling: Tiling, capacity: int, key: jax.Array, dtype=jnp.float32
):
    """Two half-density beams at ±drift — the two-stream fixture
    (BASELINE.json config 1)."""
    import dataclasses

    half = dataclasses.replace(spec, ux=drift)
    k1, k2 = jax.random.split(key)
    a = load_species(half, domain, tiling, capacity, k1, dtype)
    b = load_species(dataclasses.replace(spec, ux=-drift), domain, tiling, capacity, k2, dtype)
    # Halve the weights so the pair sums to the nominal density.
    return a._replace(w=a.w * 0.5), b._replace(w=b.w * 0.5)


def inject_column(
    spec: SpeciesSpec,
    domain: Domain,
    tiling: Tiling,
    capacity: int,
    key: jax.Array,
    x0_cells,
    dtype=jnp.float32,
    trow0=0,
    rows=None,
    row_ids=None,
):
    """Fresh plasma for the moving window's leading tile column.

    Returns bucket arrays [tile_rows, capacity] for the RIGHTMOST window
    tile column (window-frame positions), with the density profile
    evaluated at ABSOLUTE coordinates (x + x0_cells, traced), so a window
    that has advanced N columns injects exactly the plasma a static run
    would have loaded there — deterministic across checkpoints/restarts
    (key is folded with x0_cells by the caller).  trow0/rows select a
    GLOBAL tile-row block for sharded callers; `row_ids` (any global tile
    rows, traced OK — the striped/balanced placement) overrides both.
    Thermal noise is keyed per global row, so every decomposition injects
    identical plasma."""
    if row_ids is None:
        if rows is None:
            rows = tiling.tile_rows
        row_ids = trow0 + jnp.arange(rows)
    else:
        row_ids = jnp.asarray(row_ids)
        rows = row_ids.shape[0]
    trow = row_ids.astype(dtype)[:, None]
    tcol = jnp.full((rows, 1), tiling.tile_cols - 1, dtype)
    return _load_buckets(spec, domain, tiling, capacity, key, trow, tcol,
                         x0_cells, dtype, row_keys=row_ids)
