"""Particle shape functions as dense per-tile vectors.

Dense reformulation of PIC interpolation: instead of per-particle indexed
scatter/gather over a 2-4 point support, each particle's 1-D shape
function is evaluated *densely* over its tile's local grid axis (interior
+ guards).  Gather and deposition then become batched products of these
[K, n] shape matrices, with no scatter/gather, no atomics, and no
data-dependent indexing (SURVEY.md §7 hard part #1).

Separability S(x,y) = Sx(x) Sy(y) holds for all B-spline shapes, and the
Esirkepov current decomposition is likewise separable per term (see
deposit.py), so nothing is lost by the dense form.  It costs ~(n/4)^2
more arithmetic than the sparse support; in exchange every program of
the GPU kernel owns its tile's current windows outright (deterministic,
no atomics).

Local coordinates: a particle's tile-local position xi (cell units) lies in
[0, tile_n) when freshly binned and may drift up to `guard - support/2`
cells outside between re-binning passes.  The local grid axis has
`tile_n + 2 guard` points at coordinates (a - guard + offset) for array
index a, where offset is the Yee stagger (0 or 1/2).
"""
from __future__ import annotations

import jax.numpy as jnp


def shape_values(u, order: int):
    """B-spline shape S(u), u = particle-to-gridpoint distance in cells.

    order 1: linear / CIC   (support 2, the reference report's baseline)
    order 2: quadratic / TSC (support 3, BASELINE.json Landau config)
    """
    au = jnp.abs(u)
    if order == 1:
        return jnp.maximum(0.0, 1.0 - au)
    if order == 2:
        inner = 0.75 - au**2
        outer = 0.5 * (1.5 - au) ** 2
        return jnp.where(au <= 0.5, inner, jnp.where(au <= 1.5, outer, 0.0))
    raise ValueError(f"unsupported shape order {order}")


def shape_matrix(pos, n: int, guard: int, offset: float, order: int):
    """Dense shape matrix over a tile axis.

    pos:  [..., K] local positions in cell units (relative to tile interior
          origin).
    Returns [..., K, n + 2*guard] with entry (k, a) = S(pos_k - (a - guard +
    offset)).  Rows sum to 1 for particles whose full support lies inside
    the padded axis (partition of unity), 0 outside.
    """
    coords = jnp.arange(n + 2 * guard, dtype=pos.dtype) - guard + offset
    u = pos[..., None] - coords
    return shape_values(u, order)
