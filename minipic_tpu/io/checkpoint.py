"""Round-trippable checkpoints (restart capability).

The reference persists full field state every save step but has **no load
path** — snapshots are write-only (SURVEY.md §5).  Here the full SimState
is a pytree, so checkpoint/resume is save-arrays/load-arrays:

* ``save_checkpoint``/``load_checkpoint``: single-file .npz of every leaf
  (fields, all species buffers, step counter) — exact-restart fidelity,
  including f64 runs.
* Restarting from reference-schema HDF5 snapshots alone is also possible
  for field-only runs via ``fields_from_snapshot``.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..core.config import Deck
from ..core.state import FieldState, ParticleState, SimState


def save_checkpoint(path: str, state: SimState) -> None:
    arrays = {f"fields_{n}": np.asarray(getattr(state.fields, n)) for n in state.fields._fields}
    for i, sp in enumerate(state.species):
        for n in sp._fields:
            arrays[f"sp{i}_{n}"] = np.asarray(getattr(sp, n))
    arrays["step"] = np.asarray(state.step)
    arrays["n_species"] = np.asarray(len(state.species))
    if state.drift is not None:
        arrays["drift"] = np.asarray(state.drift)
    if state.window_x0 is not None:
        arrays["window_x0"] = np.asarray(state.window_x0)
    np.savez(path, **arrays)


def load_checkpoint(path: str, deck: "Deck" = None) -> SimState:
    z = np.load(path)
    fields = FieldState(*(jnp.asarray(z[f"fields_{n}"]) for n in FieldState._fields))
    species = tuple(
        ParticleState(*(jnp.asarray(z[f"sp{i}_{n}"]) for n in ParticleState._fields))
        for i in range(int(z["n_species"]))
    )
    if "drift" in z:
        drift = jnp.asarray(z["drift"])
    else:
        # Pre-drift checkpoints: re-bin on the first drift-triggered step
        # (harmless for freshly sorted buckets).
        drift = jnp.float32(1e9)
    w0 = jnp.asarray(z["window_x0"]) if "window_x0" in z else None
    if w0 is None and deck is not None and getattr(deck, "moving_window", False):
        w0 = jnp.zeros((), jnp.int32)
    return SimState(
        fields=fields, species=species, step=jnp.asarray(z["step"]),
        drift=drift, window_x0=w0,
    )


def particles_from_snapshot(step: int, folder: str, deck: Deck) -> Tuple[ParticleState, ...]:
    """Rebuild tile-bucketed ParticleStates from a particle snapshot
    (io/hdf5.save_particles / the native writer's submit_particles): pad the
    live-compacted arrays into a flat slot pool and re-bin into the deck's
    tile buckets.  Capacity = the deck's (grown if a tile would overflow, so
    the restart is lossless)."""
    from .hdf5 import load_particles
    from ..particles.binning import rebin_flat

    data = load_particles(step, folder)
    tiling = deck.tiling
    out = []
    for spec in deck.species:
        d = data[spec.name]
        n = len(d["x"])
        # capacity: at least the deck's nominal, grown to fit the densest tile
        col = np.floor(d["x"] / tiling.tile_nx).astype(np.int64)
        row = np.floor(d["y"] / tiling.tile_ny).astype(np.int64)
        tid = row * tiling.tile_cols + col
        dens = int(np.bincount(tid, minlength=tiling.num_tiles).max()) if n else 0
        cap = max(deck.capacity(), deck.round_capacity(dens))
        pool = tiling.num_tiles * cap
        flat = ParticleState(
            *(
                jnp.asarray(np.pad(d[k].astype(np.float64), (0, pool - n)), deck.dtype)
                for k in ("x", "y", "px", "py", "pz", "w")
            )
        )
        p, ovf = rebin_flat(
            flat,
            tile_rows=tiling.tile_rows,
            tile_cols=tiling.tile_cols,
            tile_nx=tiling.tile_nx,
            tile_ny=tiling.tile_ny,
            capacity=cap,
        )
        if int(ovf) != 0:
            raise ValueError(f"particle restart overflow for species {spec.name}")
        out.append(p)
    return tuple(out)


def fields_from_snapshot(step: int, folder: str, deck: Deck) -> FieldState:
    """Rebuild a FieldState from a reference-schema HDF5 snapshot (what the
    reference itself could never do — SURVEY.md §5 checkpoint/resume)."""
    from .hdf5 import load_field

    kw = dict(
        nx_global=deck.nx,
        ny_global=deck.ny,
        guard=deck.guard,
        interior_nx=deck.tile_nx,
        interior_ny=deck.tile_ny,
    )
    comps = {
        n: jnp.asarray(load_field(step, folder, q, **kw), deck.dtype)
        for n, q in (("ex", "Ex"), ("ey", "Ey"), ("ez", "Ez"), ("bx", "Bx"), ("by", "By"), ("bz", "Bz"))
    }
    return FieldState(**comps)
