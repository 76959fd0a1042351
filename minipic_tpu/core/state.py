"""Simulation state pytrees.

The reference stores state as an array-of-structs ``vector<Grid>`` per tile
(``Auxiliar_functions.h:23-27``) plus a ``vector<Particle>`` per tile
(``Auxiliar_functions.h:16-21``).  Here state is struct-of-arrays:

* ``FieldState`` — six global ``(ny, nx)`` arrays (row ``j`` = y, col ``i`` =
  x), shardable over a 2-D device mesh.  Guard cells do not exist in the
  persistent state; halos are materialized transiently by the halo-exchange
  pass (they are communication buffers, not state).

* ``ParticleState`` — fixed-capacity ``(num_tiles, capacity)`` buffers per
  species.  Positions are stored in *global cell units* (x in [0, nx)), which
  keeps float32 precision uniform across the box and makes tile-local shape
  computation a cheap subtraction.  A slot is dead iff ``w == 0``.

Both are registered pytrees, so jit/shard_map/checkpointing treat them
natively.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

FIELD_NAMES = ("ex", "ey", "ez", "bx", "by", "bz")


class FieldState(NamedTuple):
    """E and B on the Yee grid at the same integer time level.

    The reference's leapfrog (PIC_2D.cpp phases A/C/E) advances B by two half
    steps around the full E step, so at every step boundary E and B are both
    synchronized at time n — that synchronized snapshot is what this pytree
    holds (and what the reference writes to HDF5).
    """

    ex: jax.Array
    ey: jax.Array
    ez: jax.Array
    bx: jax.Array
    by: jax.Array
    bz: jax.Array

    @classmethod
    def zeros(cls, ny: int, nx: int, dtype=jnp.float32) -> "FieldState":
        # Six distinct buffers: a state whose leaves share one buffer
        # cannot be donated to a jitted step.
        return cls(*(jnp.zeros((ny, nx), dtype) for _ in range(6)))


class CurrentState(NamedTuple):
    """Current density J at the half time step (Yee E-points staggering)."""

    jx: jax.Array
    jy: jax.Array
    jz: jax.Array

    @classmethod
    def zeros(cls, ny: int, nx: int, dtype=jnp.float32) -> "CurrentState":
        z = jnp.zeros((ny, nx), dtype)
        return cls(z, z, z)


class ParticleState(NamedTuple):
    """One species' particles in tile-bucketed, fixed-capacity layout.

    Shapes are all ``(num_tiles, capacity)``.  The tile axis is ordered by
    global tile ID (row-major over the tile grid, the reference's GID
    ordering, Auxiliar_functions.cpp:44-46).  ``x``/``y`` are global cell
    units; momenta are in m_e c; ``w`` is the macroparticle weight (physical
    charge contribution is q * w), with ``w == 0`` marking an empty slot.

    Between re-binning passes a particle may drift a little outside its
    nominal tile; the deposition/gather guard width bounds how far (see
    particles/binning.py).
    """

    x: jax.Array
    y: jax.Array
    px: jax.Array
    py: jax.Array
    pz: jax.Array
    w: jax.Array

    @property
    def num_tiles(self) -> int:
        return self.x.shape[0]

    @property
    def capacity(self) -> int:
        return self.x.shape[1]

    def alive_count(self) -> jax.Array:
        return jnp.sum((self.w > 0).astype(jnp.int32))

    @classmethod
    def empty(cls, num_tiles: int, capacity: int, dtype=jnp.float32):
        z = jnp.zeros((num_tiles, capacity), dtype)
        return cls(z, z, z, z, z, z)


class SimState(NamedTuple):
    """Full simulation state: fields + one ParticleState per species.

    ``step`` makes snapshots round-trippable (restart = load pytree), a
    capability the reference's write-only HDF5 snapshots lacked
    (SURVEY.md §5 checkpoint/resume).
    """

    fields: FieldState
    species: tuple  # tuple[ParticleState, ...]
    step: jax.Array  # scalar int32
    # Cells of particle drift accumulated since the last re-binning pass
    # (measured on device from the actual pushes, see simulation.max_step_
    # displacement).  Drives the drift-triggered re-bin; None on states
    # built by pre-drift code paths (treated as "re-bin immediately").
    drift: Optional[jax.Array] = None
    # Moving window: global cell coordinate of the window's left edge
    # (int32, advances in tile-column quanta).  None unless the deck sets
    # moving_window.  Window-frame positions + this offset = lab frame.
    window_x0: Optional[jax.Array] = None


def field_energy(f: FieldState, dx: float, dy: float):
    """Total EM energy  (1/2) ∫ (E² + B²) dA  in normalized units.

    Accumulated in float32 at minimum; promote to float64 where enabled for
    the <0.1%-drift diagnostics (SURVEY.md §5 observability).
    """
    acc = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32
    total = sum(jnp.sum(c.astype(acc) ** 2) for c in f)
    return 0.5 * total * dx * dy


def kinetic_energy(p: ParticleState, mass: float):
    """Total kinetic energy  Σ w m (γ - 1).

    The weight convention (particles/species.py) is w = n dx dy / ppc, i.e.
    w already carries the cell area, so Σ w m (γ-1) is directly comparable
    to the field energy ½ ∫ (E²+B²) dA.
    """
    acc = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32
    px, py, pz, w = (a.astype(acc) for a in (p.px, p.py, p.pz, p.w))
    p2 = px * px + py * py + pz * pz
    gamma = jnp.sqrt(1.0 + p2)
    # gamma - 1 via the cancellation-free identity p^2/(gamma+1): for
    # thermal decks (p ~ 0.05) the naive form loses ~3 digits to the
    # 1 + p^2 rounding before the subtraction.
    return jnp.sum(w * mass * (p2 / (gamma + 1.0)))


def momentum_sum(p: ParticleState, mass: float):
    """Total momentum  Σ w m u  per axis — with the field (Poynting)
    momentum this is the conservation diagnostic SURVEY.md §5 calls for."""
    acc = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32
    w = p.w.astype(acc) * mass
    return jnp.stack(
        [jnp.sum(w * p.px.astype(acc)), jnp.sum(w * p.py.astype(acc)), jnp.sum(w * p.pz.astype(acc))]
    )
