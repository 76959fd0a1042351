"""Sharded PIC step: shard_map over the 2-D device mesh.

Per-device program (mirrors the single-device step in simulation.py, with
the reference's three MPI guard rounds, PIC_2D.cpp:198-396, becoming three
ppermute exchanges):

  1. one 6-component halo exchange (fields at t^n) -> padded block
  2. tile windows -> gather/Boris/move/Esirkepov (local work)
  3. fold J tiles -> fold_halo (cross-chip guard reduction, additive)
  4. B half (block stencil) -> exchange B -> E full (+J) -> exchange E
     -> B half
  5. wrap positions -> ship off-shard particles (exchange_particles)
     -> local re-binning sort

Diagnostics are psum-reduced so every chip returns identical replicated
scalars (the reference's rank-0 prints, minus the rank).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import Deck
from ..core.state import (
    CurrentState,
    FieldState,
    ParticleState,
    SimState,
    field_energy,
    kinetic_energy,
    momentum_sum,
)
from ..fields.boundary import local_damping_mask
from ..fields.tiles import extract_field_tiles, fold_tiles
from ..fields.yee import update_b_half_block, update_e_full_block
from ..particles.binning import rebin_flat, wrap_positions
from ..particles.species import load_species
from ..simulation import (StepDiag, advance_backend, advance_species_tiles,
                          rebin_flag, window_injection_key, window_shift_now)
from .exchange import exchange_particles
from .halo import exchange_halo, fold_halo
from .mesh import field_spec, local_tile_grid, make_mesh, particle_spec, shard_shape


def build_sharded_step(deck: Deck, mesh: Mesh):
    deck.validate()
    rows, cols = mesh.devices.shape
    g = deck.guard
    dt, dx, dy = deck.dt, deck.dx, deck.dy
    tiling = deck.tiling
    nyt, nxt = tiling.tile_ny, tiling.tile_nx
    ltr, ltc = local_tile_grid(deck, mesh)  # local tile grid per shard
    ny_l, nx_l = shard_shape(deck, mesh)
    periodic = deck.boundary == "periodic"
    t_local = ltr * ltc
    xcap = deck.exchange_cap(ny_l, nx_l)
    if deck.species and rows * cols > 1:
        # Cross-shard routing reaches mesh neighbors only (one hop per
        # re-bin); drift between re-bins must stay within one shard block.
        # Under the drift trigger the bound is the measured-drift force
        # line (<= guard cells, always < a shard block); the light-speed
        # interval bound applies only to the interval schedule.
        if deck.uses_drift_trigger():
            max_drift = deck.force_threshold() + deck.cfl_step_cells()
        else:
            max_drift = deck.rebin_interval * deck.dt / min(deck.dx, deck.dy)
        if max_drift > min(nx_l, ny_l):
            raise ValueError(
                f"re-bin schedule allows {max_drift:.1f} cells of drift "
                f"but the shard block is only {ny_l}x{nx_l} — particles "
                "could skip a shard"
            )
    backend = advance_backend(deck)
    trigger_drift = bool(deck.species) and deck.uses_drift_trigger()

    fspec = FieldState(*(field_spec(),) * 6)
    pspec = ParticleState(*(particle_spec(),) * 6)
    n_sp = len(deck.species)

    def local_step(f: FieldState, species, step, drift, window_x0):
        # Shard coordinates -> global offsets (traced scalars).
        myrow = lax.axis_index("ry")
        mycol = lax.axis_index("rx")
        y0 = myrow * ny_l  # cell offset of this shard's block
        x0 = mycol * nx_l
        trow0 = myrow * ltr  # tile offset
        tcol0 = mycol * ltc

        # --- 1. fields at t^n, one stacked halo exchange ---
        stacked = jnp.stack(tuple(f))  # [6, ny_l, nx_l]
        padded = exchange_halo(stacked, g, rows, cols)
        fpad = FieldState(*padded)
        ftiles = extract_field_tiles(fpad, ltr, ltc, nyt, nxt, g)

        # Global tile origins for local tile t (cell units).
        tl = jnp.arange(t_local)
        ox = ((tcol0 + tl % ltc) * nxt).astype(deck.dtype)[:, None]
        oy = ((trow0 + tl // ltc) * nyt).astype(deck.dtype)[:, None]

        # --- 2. particles ---
        new_species = []
        jx = jy = jz = None
        kes = []
        moms = []
        center_grid = (deck.nx, deck.ny) if periodic else None
        disps = []
        for spec, p in zip(deck.species, species):
            adv = advance_species_tiles(
                p,
                ftiles,
                qm=spec.charge / spec.mass,
                q=spec.charge,
                order=spec.shape_order,
                tile_ny=nyt,
                tile_nx=nxt,
                origins=(ox, oy),
                g=g,
                dt=dt,
                dx=dx,
                dy=dy,
                kchunk=deck.kchunk,
                vma_axes=("ry", "rx"),
                backend=backend,
                grid=center_grid,
                return_disp=trigger_drift,
            )
            if trigger_drift:
                pnew, (sjx, sjy, sjz), sdisp = adv
                disps.append(sdisp)
            else:
                pnew, (sjx, sjy, sjz) = adv
            jx = sjx if jx is None else jx + sjx
            jy = sjy if jy is None else jy + sjy
            jz = sjz if jz is None else jz + sjz
            new_species.append(pnew)
            kes.append(lax.psum(kinetic_energy(pnew, spec.mass), ("ry", "rx")))
            moms.append(lax.psum(momentum_sum(pnew, spec.mass), ("ry", "rx")))

        # --- 3. current: fold tiles locally, then guard rings across chips
        if jx is not None:
            jt = jnp.stack([jx, jy, jz]).reshape(3, ltr, ltc, nyt + 2 * g, nxt + 2 * g)
            jpad = jax.vmap(lambda t: fold_tiles(t, nyt, nxt, g))(jt)
            jblk = fold_halo(jpad, g, rows, cols)  # [3, ny_l, nx_l]
            j = CurrentState(jblk[0], jblk[1], jblk[2])
        else:
            j = None

        # --- 4. Yee updates with per-phase exchanges (reference phases A-F)
        fpad = update_b_half_block(fpad, g, dt, dx, dy)
        bpad = exchange_halo(jnp.stack([fpad.bx, fpad.by, fpad.bz])[..., g:-g, g:-g], g, rows, cols)
        fpad = FieldState(fpad.ex, fpad.ey, fpad.ez, *bpad)
        fpad = update_e_full_block(fpad, g, dt, dx, dy, j)
        epad = exchange_halo(jnp.stack([fpad.ex, fpad.ey, fpad.ez])[..., g:-g, g:-g], g, rows, cols)
        fpad = FieldState(*epad, fpad.bx, fpad.by, fpad.bz)
        fpad = update_b_half_block(fpad, g, dt, dx, dy)
        fnew = FieldState(*(c[g:-g, g:-g] for c in fpad))
        if not periodic:
            mask = local_damping_mask(
                y0, x0, ny_l, nx_l, deck.ny, deck.nx, deck.absorb_width, dtype=deck.dtype
            )
            fnew = FieldState(*(c * mask for c in fnew))

        fe = lax.psum(field_energy(fnew, dx, dy), ("ry", "rx"))

        # --- 5. wrap, route across shards, re-bin ---

        # Moving window: the shift rolls buckets (including a cross-shard
        # handoff), so buckets must be FRESH — fold the shift predicate
        # into the re-bin predicate (see simulation.build_step).
        # window_x0 is replicated, so the predicate is mesh-agreed.
        if deck.moving_window:
            shift_now = window_shift_now(step, window_x0, dt, nxt, dx)
        else:
            shift_now = None

        if trigger_drift:
            # Mesh-agreed measured drift so every shard takes the same
            # re-bin branch (the branches contain collectives).
            disp = lax.pmax(functools.reduce(jnp.maximum, disps), ("ry", "rx"))
            drift_now = drift + disp
            do_rebin_pred = drift_now > deck.drift_threshold()
            if shift_now is not None:
                do_rebin_pred = do_rebin_pred | shift_now
        else:
            drift_now = drift
            do_rebin_pred = (
                None if deck.rebin_interval == 1
                else step % deck.rebin_interval == 0
            )
            if shift_now is not None and do_rebin_pred is not None:
                do_rebin_pred = do_rebin_pred | shift_now

        overflow = jnp.zeros((), jnp.int32)
        binned = []
        for p in new_species:
            p = wrap_positions(p, deck.nx, deck.ny, periodic)

            def do_rebin(pp):
                merged, dropped = exchange_particles(
                    pp,
                    block_x0=x0,
                    block_y0=y0,
                    block_nx=nx_l,
                    block_ny=ny_l,
                    nx=deck.nx,
                    ny=deck.ny,
                    rows=rows,
                    cols=cols,
                    cap=xcap,
                )
                out, ov = rebin_flat(
                    merged,
                    tile_rows=ltr,
                    tile_cols=ltc,
                    tile_nx=nxt,
                    tile_ny=nyt,
                    capacity=pp.capacity,
                    row0=trow0,
                    col0=tcol0,
                )
                return out, (ov + dropped).astype(jnp.int32)

            if do_rebin_pred is None:
                p, ov = do_rebin(p)
            else:

                def skip_rebin(pp):
                    # Match the rebin branch's varying-axis typing (vma).
                    zero = lax.pcast(jnp.zeros((), jnp.int32), ("ry", "rx"), to="varying")
                    return pp, zero

                p, ov = lax.cond(do_rebin_pred, do_rebin, skip_rebin, p)
            overflow = overflow + lax.psum(ov, ("ry", "rx"))
            binned.append(p)

        if trigger_drift:
            drift_now = jnp.where(do_rebin_pred, 0.0, drift_now)

        # Diagnostics reflect the PRE-shift state, matching the
        # single-device driver's ordering (the window block runs after).
        live = jnp.zeros((), jnp.int32)
        for p in binned:
            live = live + jnp.sum((p.w > 0).astype(jnp.int32))

        window_new = window_x0
        if deck.moving_window:
            from ..particles.species import inject_column

            # CYCLIC permutation (0 <- 1 <- ... <- cols-1 <- 0), like
            # every other collective in this codebase: the XLA CPU
            # runtime aborted intermittently on partial (non-cyclic)
            # permutes once the process had run other meshes.  The
            # wrapped-around payload (shard 0's data arriving at the
            # rightmost shard) is discarded — fields mask it to the
            # incoming vacuum, buckets overwrite it with injection.
            # The COLLECTIVES run unconditionally every step (ppermute
            # inside a lax.cond branch also aborted the CPU runtime),
            # but they move only a [6, ny_l, nxt] field strip and one
            # bucket column per species; the expensive full-array roll/
            # inject/update work happens INSIDE the cond, so non-shift
            # steps pay only the small permutes plus the select.
            perm_left = [(i, (i - 1) % cols) for i in range(cols)]
            is_last_col = mycol == cols - 1
            st = jnp.stack(tuple(fnew))  # [6, ny_l, nx_l]
            recv_strip = lax.ppermute(st[:, :, :nxt], "rx", perm_left)
            recv_strip = jnp.where(is_last_col, 0.0, recv_strip)
            sp_cols = []
            for p in binned:
                col0 = [
                    getattr(p, nm).reshape(ltr, ltc, -1)[:, 0, :]
                    for nm in ParticleState._fields
                ]
                sp_cols.append([lax.ppermute(c, "rx", perm_left)
                                for c in col0])
            w0n = window_x0 + nxt

            def _shift(args):
                f_, sps = args
                stk = jnp.stack(tuple(f_))
                f2 = FieldState(
                    *jnp.concatenate([stk[:, :, nxt:], recv_strip], axis=2))
                out = []
                for i, (spec, p) in enumerate(zip(deck.species, sps)):
                    # Buckets roll one tile column left; each shard hands
                    # its LOCAL column 0 to the left neighbor (the
                    # leftmost shard's column outflows with the window);
                    # the rightmost shard's incoming column is fresh
                    # plasma (inject_column, keyed per GLOBAL tile row so
                    # every mesh decomposition injects bit-identically).
                    key = window_injection_key(i, w0n)
                    inj = inject_column(spec, deck.domain, tiling,
                                        p.capacity, key, w0n, deck.dtype,
                                        trow0=trow0, rows=ltr)
                    chans = []
                    for ci, nm in enumerate(ParticleState._fields):
                        a = getattr(p, nm).reshape(ltr, ltc, -1)
                        a = jnp.roll(a, -1, axis=1)
                        rc = sp_cols[i][ci]
                        if nm == "x":
                            a = a - nxt
                            rc = rc - nxt
                        last = jnp.where(is_last_col, getattr(inj, nm), rc)
                        a = a.at[:, -1, :].set(last)
                        chans.append(a.reshape(t_local, p.capacity))
                    out.append(ParticleState(*chans))
                return f2, tuple(out), w0n

            def _keep(args):
                f_, sps = args
                return f_, sps, window_x0

            fnew, binned, window_new = lax.cond(
                shift_now, _shift, _keep, (fnew, tuple(binned)))
            binned = list(binned)

        diag = StepDiag(
            field_energy=fe,
            kinetic_energy=jnp.stack(kes) if kes else jnp.zeros((0,), deck.dtype),
            overflow=overflow,
            momentum=jnp.stack(moms) if moms else jnp.zeros((0, 3), deck.dtype),
            # one element per shard: the cross-chip work-skew observable
            shard_live=live.reshape(1),
            rebinned=rebin_flag(do_rebin_pred),
        )
        return fnew, tuple(binned), diag, drift_now, window_new

    in_specs = (fspec, (pspec,) * n_sp, P(), P(), P())
    out_specs = (
        fspec, (pspec,) * n_sp,
        StepDiag(P(), P(), P(), P(), P(("ry", "rx")), P()), P(), P(),
    )
    smapped = jax.shard_map(
        local_step, mesh=mesh, in_specs=in_specs, out_specs=out_specs)

    def step(state: SimState):
        drift = state.drift
        if trigger_drift and drift is None:
            raise ValueError(
                "deck uses drift-triggered re-binning but SimState.drift "
                "is unset — initialize it to 0.0 (ShardedSimulation does)"
            )
        if drift is None:
            drift = jnp.zeros((), jnp.float32)
        w0 = state.window_x0
        if w0 is None:
            if deck.moving_window:
                raise ValueError(
                    "deck.moving_window but SimState.window_x0 is unset — "
                    "initialize it to 0 (ShardedSimulation does)")
            w0 = jnp.zeros((), jnp.int32)
        fnew, species, diag, drift_now, w0n = smapped(
            state.fields, state.species, state.step, drift, w0
        )
        return SimState(
            fields=fnew, species=species, step=state.step + 1,
            drift=drift_now,
            window_x0=(w0n if deck.moving_window else state.window_x0),
        ), diag

    return step


# ----------------------------------------------------------------------
# Shard-major particle ordering helpers.
# Global tile GID is row-major over the whole grid (reference
# Auxiliar_functions.cpp:44); sharded particle buffers use shard-major
# order (shard_id * t_local + local_tile) so P(('ry','rx'), None) puts each
# tile's bucket on the chip that owns its field block.


def shard_major_permutation(deck: Deck, mesh: Mesh) -> np.ndarray:
    """perm[shard_major_index] = gid; use to reorder [T, K] arrays."""
    rows, cols = mesh.devices.shape
    ltr, ltc = local_tile_grid(deck, mesh)
    t = deck.tiling
    out = np.empty(t.num_tiles, np.int64)
    i = 0
    for sr in range(rows):
        for sc in range(cols):
            for lr in range(ltr):
                for lc in range(ltc):
                    out[i] = (sr * ltr + lr) * t.tile_cols + (sc * ltc + lc)
                    i += 1
    return out


class ShardedSimulation:
    """Multi-chip driver mirroring simulation.Simulation."""

    def __init__(self, deck: Deck, fields: Optional[FieldState] = None, seed: int = 0, devices=None):
        deck.validate()
        self.deck = deck
        self.mesh = make_mesh(deck, devices)
        cap = deck.capacity()
        key = jax.random.PRNGKey(seed)
        perm = shard_major_permutation(deck, self.mesh)

        fsh = NamedSharding(self.mesh, field_spec())
        psh = NamedSharding(self.mesh, particle_spec())
        species = []
        for i, spec in enumerate(deck.species):
            p = load_species(spec, deck.domain, deck.tiling, cap, jax.random.fold_in(key, i), deck.dtype)
            p = ParticleState(*(jax.device_put(np.asarray(a)[perm], psh) for a in p))
            species.append(p)
        if fields is None:
            fields = FieldState.zeros(deck.ny, deck.nx, deck.dtype)
        fields = FieldState(*(jax.device_put(np.asarray(c), fsh) for c in fields))
        self.state = SimState(
            fields=fields, species=tuple(species), step=jnp.zeros((), jnp.int32),
            drift=jnp.zeros((), jnp.float32),
            window_x0=(jnp.zeros((), jnp.int32) if deck.moving_window
                       else None),
        )
        self._step = jax.jit(build_sharded_step(deck, self.mesh))
        self._capmgrs = None  # per-species CapacityManagers, lazily built

    def step(self, n: int = 1):
        diag = None
        for _ in range(n):
            self.state, diag = self._step(self.state)
        return diag

    def ensure_capacity(self, overflow: int = 0) -> bool:
        """Sharded counterpart of Simulation.ensure_capacity: grow bucket
        capacity on overflow/high occupancy so a sharded overflow grows
        instead of dropping.  The census reduction runs distributed (the
        scalars replicate); growth pads the unsharded slot axis under jit
        with the particle sharding pinned, so no shard ever materializes
        another shard's buckets.  Shrink is deferred in sharded mode: it
        needs a cross-shard positional re-bin at the new capacity, and
        capacity waste (unlike overflow) loses no physics — a transient
        hot spot costs only occupancy-bounded kernel time."""
        from .balance import CapacityManager, census

        if self._capmgrs is None:
            self._capmgrs = [CapacityManager() for _ in self.state.species]
        changed = False
        species = list(self.state.species)
        psh = NamedSharding(self.mesh, particle_spec())
        for i, (p, mgr) in enumerate(zip(species, self._capmgrs)):
            new_cap = mgr.plan(census(p), overflow)
            if new_cap is None:
                continue
            cap = self.deck.round_capacity(new_cap)
            if cap > p.capacity:
                grow = jax.jit(
                    functools.partial(_pad_capacity, extra=cap - p.capacity),
                    out_shardings=psh,
                )
                species[i] = ParticleState(*(grow(a) for a in p))
                changed = True
        if changed:
            self.state = self.state._replace(species=tuple(species))
        return changed

    def run(self, n_steps: Optional[int] = None, save_every: Optional[int] = None, saver=None):
        """Sharded mirror of Simulation.run (reference Phase H cadence)."""
        n_steps = n_steps if n_steps is not None else self.deck.total_steps
        save_every = save_every if save_every is not None else self.deck.save_frequency
        if saver is not None:
            saver(self.state, 0)
        diag = None
        check_every = 50  # CapacityManager cadence (census syncs the device)
        for i in range(1, n_steps + 1):
            self.state, diag = self._step(self.state)
            ovf = int(diag.overflow)
            if ovf > 0 or i % check_every == 0:
                self.ensure_capacity(ovf)
            if saver is not None and i % save_every == 0:
                saver(self.state, i)
        return diag


def _pad_capacity(a, *, extra: int):
    return jnp.pad(a, ((0, 0), (0, extra)))
