"""Cross-chip guard-cell exchange via lax.ppermute (inside shard_map).

The replacement for the reference's halo engine (PIC_2D.cpp:198-248:
per step 3 rounds x 8 directions x 2 sides x tiles of MPI_Irecv/Isend plus
6 barriers).  Two axis-shift passes replace the 8-direction enumeration:
exchanging x-edge strips first and then y-edge strips *of the x-padded
block* delivers corner data in two hops (the composition argument in
SURVEY.md §5) — 4 ppermutes per exchange, no tags, no barriers, no owner
lookup.

``fold_halo`` is the additive adjoint (y then x), used to reduce deposition
guard rings into neighbor interiors across chips.

All functions assume they run inside shard_map over mesh axes
('ry', 'rx'); with an axis of size 1 the permutation is the identity
(0 -> 0), which is exactly the periodic wrap — the single-chip degenerate
case needs no special path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _shift(x, axis_name: str, up: bool, n: int):
    """ppermute by one mesh step along axis_name; up=True sends toward
    lower indices (periodic)."""
    if n == 1:
        return x
    if up:
        perm = [(i, (i - 1) % n) for i in range(n)]
    else:
        perm = [(i, (i + 1) % n) for i in range(n)]
    return lax.ppermute(x, axis_name, perm)


def exchange_halo(block, g: int, rows: int, cols: int):
    """Local block [..., ny_l, nx_l] -> [..., ny_l+2g, nx_l+2g] with guard
    rings fetched from mesh neighbors (periodic).  Leading axes (e.g. a
    stacked component axis) ride along, amortizing collective launches."""
    # x: my right halo is my right neighbor's left edge.
    left_edge = block[..., :, :g]
    right_edge = block[..., :, -g:]
    right_halo = _shift(left_edge, "rx", up=True, n=cols)
    left_halo = _shift(right_edge, "rx", up=False, n=cols)
    xp = jnp.concatenate([left_halo, block, right_halo], axis=-1)
    # y: strips of the x-padded block -> corners arrive in two hops.
    top_edge = xp[..., :g, :]
    bot_edge = xp[..., -g:, :]
    bot_halo = _shift(top_edge, "ry", up=True, n=rows)
    top_halo = _shift(bot_edge, "ry", up=False, n=rows)
    return jnp.concatenate([top_halo, xp, bot_halo], axis=-2)


def fold_halo(padded, g: int, rows: int, cols: int):
    """Additive adjoint of exchange_halo: [..., ny_l+2g, nx_l+2g] ->
    [..., ny_l, nx_l]; guard-ring values are shipped to the neighbor that
    owns those cells and added into its interior edge."""
    # y first (adjoint order).  My bottom interior rows coincide with my
    # *lower* neighbor's top ring (its rows just above its block), so I
    # receive top rings from below (up=True: receive from index+1), and
    # symmetrically bottom rings from above.
    top_ring = padded[..., :g, :]
    bot_ring = padded[..., -g:, :]
    from_below = _shift(top_ring, "ry", up=True, n=rows)
    from_above = _shift(bot_ring, "ry", up=False, n=rows)
    mid = padded[..., g:-g, :]
    mid = mid.at[..., -g:, :].add(from_below)
    mid = mid.at[..., :g, :].add(from_above)
    # x: my right interior cols receive the right neighbor's left ring.
    left_ring = mid[..., :, :g]
    right_ring = mid[..., :, -g:]
    from_right = _shift(left_ring, "rx", up=True, n=cols)
    from_left = _shift(right_ring, "rx", up=False, n=cols)
    out = mid[..., :, g:-g]
    out = out.at[..., :, -g:].add(from_right)
    out = out.at[..., :, :g].add(from_left)
    return out
