"""Tile window extraction and guard folding — the intra-device half of the
reference's halo machinery, done with reshapes and rolls only.

The reference packs per-tile guard strips into MPI messages
(``packSendBuffer``/``updateGuardRegion``, Auxiliar_functions.cpp:73-239 —
8 directions x 2 sides x 3 exchanges/step x 36 tiles ≈ 1,728 messages per
rank per step).  Here tiles that live on the same device share an address
space, so "halo exchange" between them is pure data layout:

* ``extract_tiles``: padded local block (ny+2g, nx+2g) -> overlapping tile
  windows [tr, tc, nyt+2g, nxt+2g].  Two reshapes + a slice + a concat per
  axis; the 2g-wide window overlap is materialized by reading each block
  twice at a shifted base — no gather ops.

* ``fold_tiles``: additive inverse of extract — per-tile deposition grids
  (with guard rings holding out-of-tile current) are summed back into a
  padded block, guard overlaps accumulating into neighbor interiors.  This
  is the deposition-side "guard reduction" the reference never needed
  (fields-only) but a PIC loop requires.

The *block-level* guard ring (cross-chip, or periodic wrap on one device)
is handled by parallel/halo.py.

Constraint: 2*guard <= tile_nx and 2*guard <= tile_ny (window construction
reads at most one neighbor tile deep), enforced by Deck.validate.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.state import FieldState


def _extract_axis(p, n_tiles: int, tile_n: int, g: int, axis: int):
    """Split an axis of length n_tiles*tile_n + 2g into n_tiles overlapping
    windows of length tile_n + 2g; the (n_tiles, window) axis pair replaces
    the original axis in place."""
    ax = axis if axis >= 0 else p.ndim + axis
    p = jnp.moveaxis(p, ax, -1)
    lead = p.shape[:-1]
    main = p[..., : n_tiles * tile_n].reshape(*lead, n_tiles, tile_n)
    # Window tail [tile_n, tile_n+2g) of block c = p[(c+1)*tile_n : ...+2g].
    # Shift by one block and re-blockify; zero-pad the tail so the reshape is
    # exact (the padding lands beyond the 2g columns we keep, since
    # tile_n >= 2g).
    shifted = p[..., tile_n:]
    pad = n_tiles * tile_n - shifted.shape[-1]
    shifted = jnp.pad(shifted, [(0, 0)] * (p.ndim - 1) + [(0, pad)])
    over = shifted.reshape(*lead, n_tiles, tile_n)[..., : 2 * g]
    win = jnp.concatenate([main, over], axis=-1)  # [..., n_tiles, tile_n+2g]
    return jnp.moveaxis(win, (-2, -1), (ax, ax + 1))


def extract_tiles(padded, tile_rows: int, tile_cols: int, tile_ny: int, tile_nx: int, g: int):
    """(ny+2g, nx+2g) -> [tile_rows, tile_cols, tile_ny+2g, tile_nx+2g]."""
    # x axis (last): -> (ny+2g, tc, nxt+2g)
    x = _extract_axis(padded, tile_cols, tile_nx, g, axis=-1)  # inserts tc before last
    # now shape (ny+2g, tc, nxt+2g); y axis is 0
    y = _extract_axis(x, tile_rows, tile_ny, g, axis=0)
    # y inserted tr at axis 0 -> (tr, nyt+2g, tc, nxt+2g)
    return jnp.moveaxis(y, 2, 1)  # -> (tr, tc, nyt+2g, nxt+2g)


def _fold_axis(t, tile_n: int, g: int, tile_axis: int, cell_axis: int):
    """Additive inverse of _extract_axis: merge (n_tiles, tile_n+2g) back to
    an axis of length n_tiles*tile_n + 2g, summing window overlaps."""
    t = jnp.moveaxis(t, (tile_axis, cell_axis), (-2, -1))
    lead = t.shape[:-2]
    n_tiles = t.shape[-2]
    main = t[..., :tile_n].reshape(*lead, n_tiles * tile_n)
    tail = t[..., tile_n:]  # [..., n_tiles, 2g]
    pad = jnp.zeros((*lead, n_tiles, tile_n - 2 * g), dtype=t.dtype)
    over = jnp.concatenate([tail, pad], axis=-1).reshape(*lead, n_tiles * tile_n)
    out = jnp.zeros((*lead, n_tiles * tile_n + 2 * g), dtype=t.dtype)
    out = out.at[..., : n_tiles * tile_n].add(main)
    # Mirror of the extract shift: block c's tail adds at (c+1)*tile_n; only
    # the first (n_tiles-1)*tile_n + 2g entries fit (the zero padding beyond
    # carries nothing, by construction above).
    valid = (n_tiles - 1) * tile_n + 2 * g
    out = out.at[..., tile_n:].add(over[..., :valid])
    return out


def fold_tiles(tiles, tile_ny: int, tile_nx: int, g: int):
    """[tr, tc, nyt+2g, nxt+2g] -> padded block (ny+2g, nx+2g), overlaps summed."""
    # fold x: (tr, tc, nyg, nxg) -> (tr, nyg, nx+2g)
    x = _fold_axis(tiles, tile_nx, g, tile_axis=1, cell_axis=3)
    # fold y: (tr, nyg, nx+2g) -> (nx+2g, ny+2g), then restore (y, x) order
    y = _fold_axis(x, tile_ny, g, tile_axis=0, cell_axis=1)
    return y.T


def extract_field_tiles(f: FieldState, tile_rows, tile_cols, tile_ny, tile_nx, g):
    """FieldState of padded blocks -> FieldState of flattened tile stacks
    [T, nyt+2g, nxt+2g] (T in global-ID row-major order)."""

    def ex(a):
        t = extract_tiles(a, tile_rows, tile_cols, tile_ny, tile_nx, g)
        return t.reshape(tile_rows * tile_cols, tile_ny + 2 * g, tile_nx + 2 * g)

    return FieldState(*(ex(c) for c in f))
