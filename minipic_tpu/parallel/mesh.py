"""Device mesh and sharding layout.

The reference arranges MPI ranks in a near-square R x C grid, each owning a
rectangular block of the global tile grid (PIC_2D.cpp:29-52,
Auxiliar_functions.cpp:16-22).  Here the "rank grid" is a 2-D
``jax.sharding.Mesh`` with axes ('ry', 'rx'):

* field components (ny, nx) are sharded P('ry', 'rx') — each chip holds the
  contiguous cell block of its mesh coordinate;
* particle buffers are sharded on the tile axis in *shard-major* order:
  global shape (R*C*T_local, K), index = shard_id * T_local + local_tile,
  so each chip's tiles are exactly the tiles of its field block;
* halo traffic rides the device links via lax.ppermute (parallel/halo.py) — the
  replicated owner[] table + barriers of the reference (PIC_2D.cpp:54,148)
  have no equivalent: placement is static, order is SPMD program order.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import Deck

AXES = ("ry", "rx")


def make_mesh(deck: Deck, devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    r, c = deck.mesh_dims(len(devices))
    if r * c != len(devices):
        raise ValueError(f"mesh {r}x{c} != {len(devices)} devices")
    t = deck.tiling
    if t.tile_rows % r or t.tile_cols % c:
        raise ValueError(
            f"tile grid {t.tile_rows}x{t.tile_cols} not divisible by mesh {r}x{c}"
        )
    return Mesh(np.array(devices).reshape(r, c), AXES)


def field_spec() -> P:
    return P("ry", "rx")


def particle_spec() -> P:
    return P(("ry", "rx"), None)


def shard_shape(deck: Deck, mesh: Mesh) -> Tuple[int, int]:
    r, c = mesh.devices.shape
    return deck.ny // r, deck.nx // c


def local_tile_grid(deck: Deck, mesh: Mesh) -> Tuple[int, int]:
    r, c = mesh.devices.shape
    t = deck.tiling
    return t.tile_rows // r, t.tile_cols // c
