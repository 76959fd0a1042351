"""Esirkepov charge-conserving current deposition as batched matmuls.

Completes the "Current Deposition" stage of the reference's PIC loop
(Mini_PIC_2D_Report.pdf Fig. 1, unimplemented there; the J term is likewise
absent from its E update, Field_update.cpp:40-59 — see fields/yee.py).

Esirkepov's decomposition guarantees the *discrete* continuity equation

    (rho^{n+1} - rho^n)/dt + div_Yee J^{n+1/2} = 0        (exactly)

so Gauss's law, once true, stays true without divergence cleaning.  With
old/new 1-D shape vectors S0x, S1x (same index window) and DS = S1 - S0:

    Wx[i,j] = DSx[i] (S0y[j] + DSy[j]/2)
    Wy[i,j] = DSy[j] (S0x[i] + DSx[i]/2)
    Wz[i,j] = S0y[j](S0x + DSx/2)[i] + DSy[j](S0x/2 + DSx/3)[i]

    Jx[j,i] at (i+1/2, j):  Jx[i] = Jx[i-1] - (q w / (dt dy)) Wx[i,j]
    Jy[j,i] at (i, j+1/2):  analogous cumulative sum along y
    Jz[j,i] at (i, j):      (q w vz / (dx dy)) Wz[i,j]

Key move: every term above is an *outer product* of a per-particle
x-vector and y-vector, and the prefix sum commutes with the outer product
— cumsum(DSx) ⊗ (S0y + DSy/2) — so summing over a tile's particles is a
single [nyg, K] @ [K, nxg] product per component, with the cumulative sums
as cheap dense 1-D prefix ops.  No scatter, no atomics, no sorting
(SURVEY.md §7 hard part #1).

Validity window: each particle's full old+new support must lie inside its
padded tile axis.  CFL guarantees <1 cell of motion per step; binning
guarantees freshly-binned particles are in [0, tile_n); the guard width
check lives in Deck.validate.  Right of the support the dense cumsum is
sum(S1x) - sum(S0x) = 0 (partition of unity); in f32 that sum keeps one
rounding, which summed over a tile's ~1e4 particles is a spurious current
at ~5e-4 of max|J| running to the window edge, so the tail is zeroed
explicitly (`prefix_flux`).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

# Full f32 products: a reduced-precision default (TF32 on a GPU, bf16
# passes elsewhere) keeps ~3 decimal digits and breaks charge
# conservation (the Gauss-law check in chip_smoke.py catches it).
_PREC = jax.lax.Precision.HIGHEST

from .shapes import shape_matrix


def prefix_flux(ds, pos0, pos1, g: int, order: int):
    """cumsum(ds) along the window axis, exactly zero right of the
    support of both shapes (see the module docstring).  ds: [..., K, W]
    shape differences; pos0/pos1: [..., K] positions before/after."""
    coords = jnp.arange(ds.shape[-1], dtype=ds.dtype) - g
    reach = 1.0 if order == 1 else 1.5
    hi = jnp.maximum(pos0, pos1)[..., None]
    return jnp.where(coords - hi >= reach, 0.0, jnp.cumsum(ds, axis=-1))


def deposit_chunk(
    xi0,
    eta0,
    xi1,
    eta1,
    vz,
    qw,
    tile_ny: int,
    tile_nx: int,
    g: int,
    order: int,
    dt: float,
    dx: float,
    dy: float,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Per-tile current contribution of one slot chunk.

    xi0/eta0, xi1/eta1: [T, kc] tile-local positions before/after the move
    (cell units, *unwrapped* so xi1 - xi0 is the true displacement).
    vz: [T, kc] z velocity at n+1/2;  qw: [T, kc] charge * weight (0 = dead).
    Returns (jx, jy, jz) tiles, each [T, nyg, nxg].
    """
    s0x = shape_matrix(xi0, tile_nx, g, 0.0, order)  # [T, kc, nxg]
    s1x = shape_matrix(xi1, tile_nx, g, 0.0, order)
    s0y = shape_matrix(eta0, tile_ny, g, 0.0, order)  # [T, kc, nyg]
    s1y = shape_matrix(eta1, tile_ny, g, 0.0, order)
    dsx = s1x - s0x
    dsy = s1y - s0y

    # Jx: cumsum along x of Wx, folded into the x-vector.
    ax = prefix_flux(dsx, xi0, xi1, g, order)  # [T, kc, nxg]
    by1 = s0y + 0.5 * dsy  # [T, kc, nyg]
    coef_x = (-qw / (dt * dy))[..., None]
    jx = jnp.einsum("tkj,tki->tji", by1 * coef_x, ax, precision=_PREC)

    # Jy: cumsum along y.
    ay = prefix_flux(dsy, eta0, eta1, g, order)
    bx1 = s0x + 0.5 * dsx
    coef_y = (-qw / (dt * dx))[..., None]
    jy = jnp.einsum("tkj,tki->tji", ay * coef_y, bx1, precision=_PREC)

    # Jz: two outer-product terms.
    coef_z = (qw * vz / (dx * dy))[..., None]
    jz = jnp.einsum(
        "tkj,tki->tji", s0y * coef_z, s0x + 0.5 * dsx, precision=_PREC
    ) + jnp.einsum(
        "tkj,tki->tji", dsy * coef_z, 0.5 * s0x + (1.0 / 3.0) * dsx, precision=_PREC
    )
    return jx, jy, jz


def deposit_rho_chunk(xi, eta, qw, tile_ny: int, tile_nx: int, g: int, order: int, dx: float, dy: float):
    """Charge density tiles [T, nyg, nxg] at integer (Ez/Gauss) points —
    the diagnostic side of the continuity/Gauss checks."""
    sx = shape_matrix(xi, tile_nx, g, 0.0, order)
    sy = shape_matrix(eta, tile_ny, g, 0.0, order)
    coef = (qw / (dx * dy))[..., None]
    return jnp.einsum("tkj,tki->tji", sy * coef, sx, precision=_PREC)
