"""Field gather (interpolation to particle positions) as batched matmuls.

Completes the "Field Interpolation" stage of the reference's PIC loop
(Mini_PIC_2D_Report.pdf Fig. 1, unimplemented there).

Dense formulation: with separable shapes S(x,y) = Sx(x) Sy(y), the
interpolated value of field F for particle k is

    F_k = sum_{j,i} Sy_k[j] F[j,i] Sx_k[i]
        = rowsum( Sy_k * (Sx_k @ F^T) )

Batched over a tile's K-slot chunk this is one [kc, nxg] @ [nxg, nyg]
product per component plus a row reduction — no gather instructions, no
data-dependent addressing.  Components sharing the same x-stagger are
stacked so the six Yee components cost two batched products.

Yee stagger classes (geometry.STAGGER / Field_update.cpp:3-11):
  half-x   : Ex, By, Bz   (x at i+1/2)
  int-x    : Ey, Ez, Bx   (x at i)
  half-y   : Ey, Bx, Bz   (y at j+1/2)
  int-y    : Ex, Ez, By   (y at j)
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Full f32 products: a reduced-precision default (TF32 on a GPU, bf16
# passes elsewhere) keeps ~3 decimal digits, which breaks charge
# conservation and force accuracy.
_PREC = jax.lax.Precision.HIGHEST

from ..core.state import FieldState
from .shapes import shape_matrix


class GatheredFields(NamedTuple):
    ex: jax.Array
    ey: jax.Array
    ez: jax.Array
    bx: jax.Array
    by: jax.Array
    bz: jax.Array


def gather_chunk(ftiles: FieldState, xi, eta, tile_ny: int, tile_nx: int, g: int, order: int) -> GatheredFields:
    """Interpolate all six components for one slot chunk.

    ftiles: components [T, nyg, nxg] (halo-padded tile windows).
    xi, eta: [T, kc] tile-local positions in cell units.
    Returns six [T, kc] arrays.
    """
    sx_h = shape_matrix(xi, tile_nx, g, 0.5, order)  # [T, kc, nxg]
    sx_i = shape_matrix(xi, tile_nx, g, 0.0, order)
    sy_h = shape_matrix(eta, tile_ny, g, 0.5, order)  # [T, kc, nyg]
    sy_i = shape_matrix(eta, tile_ny, g, 0.0, order)

    # Stack components by x-stagger class: one batched matmul each.
    f_hx = jnp.stack([ftiles.ex, ftiles.by, ftiles.bz], axis=1)  # [T,3,nyg,nxg]
    f_ix = jnp.stack([ftiles.ey, ftiles.ez, ftiles.bx], axis=1)
    m_hx = jnp.einsum("tki,tcji->tckj", sx_h, f_hx, precision=_PREC)  # [T,3,kc,nyg]
    m_ix = jnp.einsum("tki,tcji->tckj", sx_i, f_ix, precision=_PREC)

    def red(m, sy):  # [T,kc,nyg] * [T,kc,nyg] -> [T,kc]
        return jnp.sum(m * sy, axis=-1)

    ex = red(m_hx[:, 0], sy_i)
    by = red(m_hx[:, 1], sy_i)
    bz = red(m_hx[:, 2], sy_h)
    ey = red(m_ix[:, 0], sy_h)
    ez = red(m_ix[:, 1], sy_i)
    bx = red(m_ix[:, 2], sy_h)
    return GatheredFields(ex, ey, ez, bx, by, bz)
