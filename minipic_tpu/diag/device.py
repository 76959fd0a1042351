"""On-device diagnostics: phase-space histograms, field spectra, current/
charge moments — computed inside jit on the accelerator, so a diagnostic
step ships a few KB to the host instead of the full particle state.

The reference's only scientific observability is offline post-processing
of field snapshots (File_reader.py); these are the particle-era
diagnostics the PIC completion needs (SURVEY.md §5 metrics/observability).
All functions are shard_map-compatible: they reduce with jnp sums, so
under a mesh the caller wraps them in psum (or runs them on gathered
state at diagnostic cadence).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.state import FieldState, ParticleState

_AXES = {"x": 0, "y": 1, "px": 2, "py": 3, "pz": 4}


def _component(p: ParticleState, name: str) -> jax.Array:
    return (p.x, p.y, p.px, p.py, p.pz)[_AXES[name]]


def phase_space_hist(
    p: ParticleState,
    ax0: str = "x",
    ax1: str = "px",
    bins: Tuple[int, int] = (64, 64),
    range0: Optional[Tuple[float, float]] = None,
    range1: Optional[Tuple[float, float]] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Weighted 2-D phase-space histogram, e.g. (x, px) for two-stream
    vortex plots.  Axis names: x, y (cell units), px, py, pz (m_e c).
    Returns (hist [bins0, bins1], edges0, edges1).  Ranges default to the
    live-particle extrema (computed on device).

    Implementation: flat bin index + scatter-add — one pass over slots,
    dead slots (w == 0) carry zero weight so they land harmlessly in bin 0.
    """
    a0 = _component(p, ax0).ravel()
    a1 = _component(p, ax1).ravel()
    w = p.w.ravel()
    live = w > 0

    def _range(a, rng):
        if rng is not None:
            return jnp.asarray(rng[0], a.dtype), jnp.asarray(rng[1], a.dtype)
        big = jnp.asarray(jnp.finfo(a.dtype).max, a.dtype)
        lo = jnp.min(jnp.where(live, a, big))
        hi = jnp.max(jnp.where(live, a, -big))
        pad = 1e-6 * (hi - lo) + jnp.asarray(1e-12, a.dtype)
        return lo - pad, hi + pad

    lo0, hi0 = _range(a0, range0)
    lo1, hi1 = _range(a1, range1)
    n0, n1 = bins
    i0 = jnp.clip(((a0 - lo0) / (hi0 - lo0) * n0).astype(jnp.int32), 0, n0 - 1)
    i1 = jnp.clip(((a1 - lo1) / (hi1 - lo1) * n1).astype(jnp.int32), 0, n1 - 1)
    flat = jnp.where(live, i0 * n1 + i1, 0)
    hist = jnp.zeros((n0 * n1,), w.dtype).at[flat].add(jnp.where(live, w, 0.0))
    edges0 = lo0 + (hi0 - lo0) * jnp.arange(n0 + 1) / n0
    edges1 = lo1 + (hi1 - lo1) * jnp.arange(n1 + 1) / n1
    return hist.reshape(n0, n1), edges0, edges1


def energy_spectrum(
    p: ParticleState, mass: float, bins: int = 64,
    emax: Optional[float] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Weighted kinetic-energy spectrum dN/dE over m(γ-1) ∈ [0, emax]."""
    u2 = p.px**2 + p.py**2 + p.pz**2
    ke = (mass * (jnp.sqrt(1.0 + u2) - 1.0)).ravel()
    w = p.w.ravel()
    live = w > 0
    if emax is None:
        top = jnp.max(jnp.where(live, ke, 0.0)) + jnp.asarray(1e-12, ke.dtype)
    else:
        top = jnp.asarray(emax, ke.dtype)
    idx = jnp.clip((ke / top * bins).astype(jnp.int32), 0, bins - 1)
    hist = jnp.zeros((bins,), w.dtype).at[jnp.where(live, idx, 0)].add(
        jnp.where(live, w, 0.0)
    )
    edges = top * jnp.arange(bins + 1) / bins
    return hist, edges


def field_spectrum_2d(comp: jax.Array) -> jax.Array:
    """|FFT2|² mode power of one field component (instability mode maps;
    the on-device version of diag.analysis.field_spectrum_x)."""
    f = jnp.fft.rfft2(comp)
    return jnp.abs(f) ** 2


def charge_density(
    p: ParticleState, q: float, ny: int, nx: int
) -> jax.Array:
    """Nearest-cell charge density ρ on the grid (diagnostic fidelity —
    the deposition stages own the physics-grade shapes)."""
    ix = jnp.clip(p.x.ravel().astype(jnp.int32), 0, nx - 1)
    iy = jnp.clip(p.y.ravel().astype(jnp.int32), 0, ny - 1)
    w = p.w.ravel()
    live = w > 0
    flat = jnp.where(live, iy * nx + ix, 0)
    rho = jnp.zeros((ny * nx,), w.dtype).at[flat].add(jnp.where(live, q * w, 0.0))
    return rho.reshape(ny, nx)


def current_moments(p: ParticleState, q: float) -> jax.Array:
    """Σ q w v per axis (bulk current) — with momentum/energy sums these
    complete the per-step conserved-quantity set."""
    gi = jax.lax.rsqrt(1.0 + p.px**2 + p.py**2 + p.pz**2)
    w = q * p.w
    return jnp.stack(
        [jnp.sum(w * p.px * gi), jnp.sum(w * p.py * gi), jnp.sum(w * p.pz * gi)]
    )


def shape_charge_density(state, deck) -> jax.Array:
    """Charge density on the Ez (integer) points with the deposit's own
    shapes, all species, folded onto the periodic grid — the ρ that
    Esirkepov deposition keeps consistent with div E."""
    from ..fields.halo import fold_block_periodic
    from ..fields.tiles import fold_tiles
    from ..particles.deposit import deposit_rho_chunk
    from ..simulation import _tile_origins, tile_local_coords

    tiling, g = deck.tiling, deck.guard
    origins = _tile_origins(tiling, deck.dtype)
    rho = jnp.zeros((deck.ny, deck.nx), deck.dtype)
    for spec, p in zip(deck.species, state.species):
        xi, eta = tile_local_coords(p.x, p.y, origins, tiling.tile_nx,
                                    tiling.tile_ny, (deck.nx, deck.ny))
        tiles = deposit_rho_chunk(xi, eta, spec.charge * p.w, tiling.tile_ny,
                                  tiling.tile_nx, g, spec.shape_order,
                                  deck.dx, deck.dy)
        t4 = tiles.reshape(tiling.tile_rows, tiling.tile_cols,
                           tiling.tile_ny + 2 * g, tiling.tile_nx + 2 * g)
        rho = rho + fold_block_periodic(
            fold_tiles(t4, tiling.tile_ny, tiling.tile_nx, g), g)
    return rho


def gauss_residual(state, deck) -> Tuple[jax.Array, jax.Array]:
    """(div E - ρ, ρ) on a periodic grid.  Charge-conserving deposition
    and the Yee update keep the residual a constant of motion."""
    f = state.fields
    div_e = ((f.ex - jnp.roll(f.ex, 1, 1)) / deck.dx
             + (f.ey - jnp.roll(f.ey, 1, 0)) / deck.dy)
    rho = shape_charge_density(state, deck)
    return div_e - rho, rho
