"""Balanced (striped) tile placement: load balance by construction.

The reference rebalances REACTIVELY: it migrates whole tiles off
overloaded ranks through blocking MPI sends and a replicated owner table
(Auxiliar_functions.cpp:242-272, PIC_2D.cpp:398-412) — this is the
"tiling load balance" in its name.  The block-sharded step
(parallel/step.py) has no such mechanism: tile->chip placement is static
and spatially contiguous, so a localized particle concentration (a blob,
a wakefield snowplow, two-stream bunching) makes one device the straggler
(StepDiag.shard_live measures the skew).

This module's answer is STRONGER than reactive migration: stripe the
tiles round-robin over the devices (shard s owns gids {j*S + s}), so any
spatial concentration — static or moving — is spread over all S devices
to per-tile granularity, every step, with no migration machinery, no
owner table, and no trigger policy at all.  The enabling observation is
PIC's scale split:

* the GRID is small (a 1024^2 x 6-component field block is ~25 MB) —
  cheap to hold and update REPLICATED on every chip;
* the PARTICLES are big (1e8 x 6 floats) — they stay fully sharded, and
  their per-chip share is balanced by the stripe.

Per-step program (shard_map over the 1-D mesh axis 'd'):

  1. fields replicated -> halo-pad locally (identical everywhere)
  2. slice THIS shard's striped tile windows; fused gather/push/deposit
     on the local buckets (same advance as block mode)
  3. scatter local J windows into a full-grid canvas -> psum over 'd'
     -> guard fold: J replicated
  4. Yee update computed redundantly on every device (microseconds of
     elementwise work for megabytes saved in halo choreography — the
     classic replicate-the-cheap-thing trade)
  5. re-bin: pack the slots that left this shard's stripe into a buffer,
     all_gather the buffers — with a striped layout a mover's destination
     is ANY shard, so the exchange is a collective, not a neighbor
     ppermute — then one filler-key sort of (stayers + arrivals
     addressed to this shard) into the local buckets (rebin_by_tid).

Trade-offs vs block placement (parallel/step.py): J reduction costs a
full-grid psum instead of a guard-ring exchange, and mover routing costs
an all_gather instead of four ppermutes — both scale with the GRID and
the MOVER COUNT respectively, not with total particles.  Block mode wins
for grid-dominated or quiet uniform runs; striped mode wins whenever
live-count skew would exceed ~1/S of a step.
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
from ..fields.boundary import apply_damping, damping_mask
from ..fields.halo import fold_block_periodic, pad_fields_periodic

from ..fields.yee import update_b_half_periodic, update_e_full_periodic
from ..particles.binning import rebin_by_tid, wrap_positions
from ..particles.species import load_species
from ..simulation import (StepDiag, advance_backend, advance_species_tiles,
                          rebin_flag, window_injection_key, window_shift_now)

BAXIS = "d"


def shard_of_tile(tile_rows: int, tile_cols: int, n_shards: int) -> np.ndarray:
    """[T] gid -> shard map: the skewed-diagonal interleave
    shard = (a*row + col) % S with a ~ S/2 coprime to S.

    Plain cyclic gid % S DEGENERATES to whole-column stripes whenever
    tile_cols % S == 0 (gid % S == col % S), which a centered blob skews
    almost as badly as block placement (measured max/mean 1.79 vs block's
    2.03 on the stress blob).  The skewed diagonal spreads S consecutive
    tiles of a row over S shards AND shifts the pattern by `a` each row,
    covering 2-D features: measured max/mean 1.02 (centered blob) / 1.03
    (off-center blob) on the 16x16 tile grid at S=8.  Falls back to
    round-robin over a row-major scan when the diagonal map cannot give
    exactly T/S tiles per shard (tile_cols % S != 0)."""
    gid = np.arange(tile_rows * tile_cols)
    row, col = gid // tile_cols, gid % tile_cols
    if tile_cols % n_shards == 0:
        a = max(1, n_shards // 2)
        while n_shards > 1 and np.gcd(a, n_shards) != 1:
            a += 1
        return ((a * row + col) % n_shards).astype(np.int64)
    return (gid % n_shards).astype(np.int64)


def stripe_gids(tile_rows: int, tile_cols: int, n_shards: int) -> np.ndarray:
    """[S, T_local]: the (sorted) global tile ids owned by each shard."""
    shard = shard_of_tile(tile_rows, tile_cols, n_shards)
    t_local = tile_rows * tile_cols // n_shards
    out = np.empty((n_shards, t_local), np.int64)
    for s in range(n_shards):
        mine = np.nonzero(shard == s)[0]
        assert len(mine) == t_local, "stripe map must partition evenly"
        out[s] = mine
    return out


def balanced_permutation(num_tiles: int, n_shards: int,
                         tile_rows: int = 0, tile_cols: int = 0) -> np.ndarray:
    """perm[storage_row] = gid for the striped layout: storage row
    s*T_local + j holds stripe_gids[s, j]."""
    if not tile_rows:
        # square-ish fallback for legacy callers
        tile_rows = int(np.sqrt(num_tiles))
        tile_cols = num_tiles // tile_rows
    return stripe_gids(tile_rows, tile_cols, n_shards).reshape(num_tiles)


def build_balanced_step(deck: Deck, mesh: Mesh):
    deck.validate()
    (n_shards,) = mesh.devices.shape
    tiling = deck.tiling
    if tiling.num_tiles % n_shards:
        raise ValueError(
            f"{tiling.num_tiles} tiles not divisible by {n_shards} shards"
        )
    t_local = tiling.num_tiles // n_shards
    g = deck.guard
    dt, dx, dy = deck.dt, deck.dx, deck.dy
    nyt, nxt = tiling.tile_ny, tiling.tile_nx
    nyg, nxg = nyt + 2 * g, nxt + 2 * g
    tr, tc = tiling.tile_rows, tiling.tile_cols
    periodic = deck.boundary == "periodic"
    backend = advance_backend(deck)
    trigger_drift = bool(deck.species) and deck.uses_drift_trigger()
    # Off-shard mover buffer per shard and species.  Between re-bins no
    # particle drifts further than `band` cells, so at most a
    # band*(1/tile_nx + 1/tile_ny) fraction of slots can have left its
    # tile: a hard bound, so the buffer never drops a mover.
    band = (deck.drift_threshold() + deck.cfl_step_cells() if trigger_drift
            else deck.rebin_interval * deck.cfl_step_cells())
    mover_frac = min(1.0, band * (1.0 / nxt + 1.0 / nyt))
    mask = (
        None
        if periodic
        else damping_mask(deck.ny, deck.nx, deck.absorb_width, dtype=deck.dtype)
    )
    n_sp = len(deck.species)
    pspec = ParticleState(*(P(BAXIS, None),) * 6)

    # Compile-time stripe tables (skewed-diagonal interleave; see
    # shard_of_tile): stripe[s] = gids of shard s; shard_of[gid] = owner;
    # local_of[gid] = bucket index within the owner's stripe.
    stripe_np = stripe_gids(tr, tc, n_shards)
    shard_of_np = shard_of_tile(tr, tc, n_shards)
    local_of_np = np.zeros(tr * tc, np.int64)
    for s in range(n_shards):
        local_of_np[stripe_np[s]] = np.arange(t_local)

    def local_step(f: FieldState, species, step, drift, window_x0):
        s_id = lax.axis_index(BAXIS)
        gids = jnp.take(
            jnp.asarray(stripe_np, jnp.int32), s_id, axis=0
        )  # [T_local], shard-varying
        grow = gids // tc
        gcol_st = gids % tc  # STORAGE column (fixed placement label)
        # Moving window, striped: instead of physically rolling buckets
        # one tile column left (which under striping would relocate
        # nearly EVERY bucket to a different shard — a full-payload
        # collective per shift), rotate the gid <-> storage map: after k
        # shifts, storage bucket (r, c_st) REPRESENTS window tile
        # (r, (c_st - k) mod tc).  Content never moves; a shift costs an
        # x -= tile_nx and one injected column (the buckets whose window
        # column wrapped from 0 to tc-1).  Placement balance is
        # unaffected: the stripe map spreads every column over all
        # shards, so the rotated ownership is exactly as balanced as the
        # static one.  All tile addressing below goes through gcol/gid
        # (the WINDOW coordinates); gcol_st only keys the rotation.
        if deck.moving_window:
            k_shift = window_x0 // nxt
            gcol = jnp.mod(gcol_st - k_shift, tc)
        else:
            k_shift = None
            gcol = gcol_st
        gids = grow * tc + gcol  # window gid of each storage bucket
        ox = (gcol * nxt).astype(deck.dtype)[:, None]
        oy = (grow * nyt).astype(deck.dtype)[:, None]

        # --- 1/2. replicated fields -> local striped windows ---
        # Slice ONLY this shard's gids' guard-padded windows from the
        # padded grid (vmapped dynamic_slice; gids is shard-varying, so
        # the windows are too).  Extracting all T windows and take-ing
        # T/S of them cost O(T*nyg*nxg*6) redundant HBM traffic per chip.
        fpad = pad_fields_periodic(f, g)
        r0 = (grow * nyt).astype(jnp.int32)
        c0 = (gcol * nxt).astype(jnp.int32)

        def slice_windows(comp):
            return jax.vmap(
                lambda a, b: lax.dynamic_slice(comp, (a, b), (nyg, nxg))
            )(r0, c0)

        ftiles = FieldState(*(slice_windows(c) for c in fpad))

        center_grid = (deck.nx, deck.ny) if periodic else None

        new_species = []
        jx = jy = jz = None
        kes, moms, disps = [], [], []
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
                vma_axes=(BAXIS,),
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
            kes.append(lax.psum(kinetic_energy(pnew, spec.mass), BAXIS))
            moms.append(lax.psum(momentum_sum(pnew, spec.mass), BAXIS))

        # --- 3. J windows -> full-grid canvas -> psum ---
        if jx is not None:
            def place(windows):
                canvas = jnp.zeros((deck.ny + 2 * g, deck.nx + 2 * g), deck.dtype)
                canvas = lax.pcast(canvas, (BAXIS,), to="varying")

                def body(i, cv):
                    r0 = grow[i] * nyt
                    c0 = gcol[i] * nxt
                    blk = lax.dynamic_slice(cv, (r0, c0), (nyg, nxg))
                    return lax.dynamic_update_slice(cv, blk + windows[i], (r0, c0))

                return lax.fori_loop(0, t_local, body, canvas)

            jpad = jnp.stack([place(jx), place(jy), place(jz)])
            jpad = lax.psum(jpad, BAXIS)
            jg = jax.vmap(lambda c: fold_block_periodic(c, g))(jpad)
            j = CurrentState(jg[0], jg[1], jg[2])
        else:
            j = None

        # --- 4. replicated Yee update ---
        f = update_b_half_periodic(f, dt, dx, dy)
        f = update_e_full_periodic(f, dt, dx, dy, j)
        f = update_b_half_periodic(f, dt, dx, dy)
        if mask is not None:
            f = apply_damping(f, mask)
        fe = field_energy(f, dx, dy)

        # --- 5. re-bin: split movers, all-gather, route to stripes ---
        # Moving window: the shift retires the trailing column's buckets
        # (their content outflows under the injection overwrite), so
        # buckets must be FRESH — fold the shift predicate into the
        # re-bin predicate, like the other two drivers.
        # window_x0 is replicated, so the predicate is mesh-agreed.
        if deck.moving_window:
            shift_now = window_shift_now(step, window_x0, dt, nxt, dx)
        else:
            shift_now = None
        if trigger_drift:
            disp = lax.pmax(functools.reduce(jnp.maximum, disps), BAXIS)
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

            def dest_tid(flat):
                """(local bucket index, belongs-to-this-shard) from global
                WINDOW positions under the striped gid map (rotated by the
                window shift count — see the k_shift comment above)."""
                col = jnp.clip(
                    jnp.floor(flat.x / nxt).astype(jnp.int32), 0, tc - 1
                )
                row = jnp.clip(
                    jnp.floor(flat.y / nyt).astype(jnp.int32), 0, tr - 1
                )
                if k_shift is not None:
                    col = jnp.mod(col + k_shift, tc)  # window -> storage
                gid = row * tc + col
                on_grid = (
                    (flat.x >= 0) & (flat.x < deck.nx)
                    & (flat.y >= 0) & (flat.y < deck.ny)
                )
                mine = (
                    jnp.take(jnp.asarray(shard_of_np, jnp.int32), gid) == s_id
                ) & on_grid
                return jnp.take(jnp.asarray(local_of_np, jnp.int32), gid), mine

            def do_rebin(pp):
                # Extract off-shard movers into a fixed buffer, all-gather,
                # then ONE filler-key sort over (local slots + arrivals).
                n_loc = pp.num_tiles * pp.capacity
                cap_b = max(1024, -(-int(mover_frac * n_loc) // 8) * 8)
                flat = jax.tree_util.tree_map(
                    lambda a: a.reshape(n_loc), pp
                )
                _tid, mine = dest_tid(flat)
                moving = (flat.w > 0) & ~mine
                rank = jnp.cumsum(moving.astype(jnp.int32)) - 1
                dropped_x = jnp.sum(
                    moving & (rank >= cap_b)
                ).astype(jnp.int32)
                dest = jnp.where(moving & (rank < cap_b), rank, cap_b)
                fields6 = jnp.stack(tuple(flat))
                buf = jnp.zeros((6, cap_b + 1), fields6.dtype)
                buf = buf.at[:, dest].set(
                    jnp.where(moving, fields6, 0.0), mode="drop"
                )[:, :cap_b]
                gathered = lax.all_gather(buf, BAXIS, axis=1).reshape(
                    6, n_shards * cap_b
                )
                stay = jax.tree_util.tree_map(
                    lambda a: jnp.where(moving, 0.0, a), flat
                )
                pool = ParticleState(
                    *(
                        jnp.concatenate([sa, ga])
                        for sa, ga in zip(tuple(stay), gathered)
                    )
                )
                tid, mine2 = dest_tid(pool)
                pool = pool._replace(w=jnp.where(mine2, pool.w, 0.0))
                out, ovf = rebin_by_tid(
                    pool, tid, jnp.ones_like(mine2), t_local, pp.capacity
                )
                return out, (ovf + dropped_x).astype(jnp.int32)

            if do_rebin_pred is None:
                p, ov = do_rebin(p)
            else:
                def skip_rebin(pp):
                    zero = lax.pcast(jnp.zeros((), jnp.int32), (BAXIS,), to="varying")
                    return pp, zero

                p, ov = lax.cond(do_rebin_pred, do_rebin, skip_rebin, p)
            overflow = overflow + lax.psum(ov, BAXIS)
            binned.append(p)

        if trigger_drift:
            drift_now = jnp.where(do_rebin_pred, 0.0, drift_now)

        live = jnp.zeros((), jnp.int32)
        for p in binned:
            live = live + jnp.sum((p.w > 0).astype(jnp.int32))
        diag = StepDiag(
            field_energy=fe,
            kinetic_energy=jnp.stack(kes) if kes else jnp.zeros((0,), deck.dtype),
            overflow=overflow,
            momentum=jnp.stack(moms) if moms else jnp.zeros((0, 3), deck.dtype),
            shard_live=live.reshape(1),
            rebinned=rebin_flag(do_rebin_pred),
        )

        window_new = window_x0
        if deck.moving_window:
            from ..particles.species import inject_column

            # The rotation (see k_shift above) makes the shift O(local):
            # no collectives, so the whole block lives inside the cond —
            # non-shift steps pay one select.  Diagnostics above reflect
            # the PRE-shift state, matching the other drivers' ordering.
            w0n = window_x0 + nxt
            col_mask = jax.lax.broadcasted_iota(
                jnp.int32, (deck.ny, deck.nx), 1) < (deck.nx - nxt)
            # Buckets whose window column wraps 0 -> tc-1 at this shift —
            # window col (gcol_st - (k+1)) mod tc == tc-1, i.e. storage
            # column k mod tc: the current TRAILING column, whose content
            # outflows under the injection overwrite.
            inj_mask = gcol_st == jnp.mod(k_shift, tc)

            def _shift(args):
                f_, sps = args
                f2 = FieldState(*(
                    jnp.where(col_mask, jnp.roll(c, -nxt, axis=1), 0.0)
                    for c in f_))
                out = []
                for i, (spec, p) in enumerate(zip(deck.species, sps)):
                    key = window_injection_key(i, w0n)
                    # Fresh plasma for every local bucket's ROW (keyed per
                    # global row, so all drivers inject bit-identically),
                    # masked to the wrapped buckets.  Generating t_local
                    # rows and keeping ~t_local/tc is redundant work, but
                    # it runs only on shift steps and keeps the injection
                    # a single static-shape call.
                    inj = inject_column(spec, deck.domain, tiling,
                                        p.capacity, key, w0n, deck.dtype,
                                        row_ids=grow)
                    chans = []
                    for name in ParticleState._fields:
                        a = getattr(p, name)
                        if name == "x":
                            a = a - nxt
                        chans.append(jnp.where(
                            inj_mask[:, None], getattr(inj, name), a))
                    out.append(ParticleState(*chans))
                return f2, tuple(out)

            f, binned = lax.cond(
                shift_now, _shift, lambda args: args, (f, tuple(binned)))
            binned = list(binned)
            window_new = jnp.where(shift_now, w0n, window_x0)

        return f, tuple(binned), diag, drift_now, window_new

    in_specs = (FieldState(*(P(),) * 6), (pspec,) * n_sp, P(), P(), P())
    out_specs = (
        FieldState(*(P(),) * 6),
        (pspec,) * n_sp,
        StepDiag(P(), P(), P(), P(), P(BAXIS), P()),
        P(),
        P(),
    )
    smapped = jax.shard_map(
        local_step, mesh=mesh, in_specs=in_specs, out_specs=out_specs)

    def step(state: SimState):
        drift = state.drift
        if drift is None:
            drift = jnp.zeros((), jnp.float32)
        w0 = state.window_x0
        if w0 is None:
            if deck.moving_window:
                raise ValueError(
                    "deck.moving_window but SimState.window_x0 is unset — "
                    "initialize it to 0 (BalancedSimulation does)")
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


class BalancedSimulation:
    """Striped-placement multi-chip driver (mirrors ShardedSimulation;
    same deck surface, different tile->chip map).  Use for decks whose
    particle distribution is, or becomes, spatially concentrated."""

    def __init__(self, deck: Deck, fields: Optional[FieldState] = None,
                 seed: int = 0, devices=None):
        deck.validate()
        self.deck = deck
        devices = list(devices if devices is not None else jax.devices())
        self.mesh = Mesh(np.array(devices), (BAXIS,))
        n_shards = len(devices)
        cap = deck.capacity()
        key = jax.random.PRNGKey(seed)
        t = deck.tiling
        perm = balanced_permutation(
            t.num_tiles, n_shards, t.tile_rows, t.tile_cols
        )

        fsh = NamedSharding(self.mesh, P())
        psh = NamedSharding(self.mesh, P(BAXIS, None))
        species = []
        for i, spec in enumerate(deck.species):
            p = load_species(
                spec, deck.domain, deck.tiling, cap,
                jax.random.fold_in(key, i), deck.dtype,
            )
            p = ParticleState(
                *(jax.device_put(np.asarray(a)[perm], psh) for a in p)
            )
            species.append(p)
        if fields is None:
            fields = FieldState.zeros(deck.ny, deck.nx, deck.dtype)
        fields = FieldState(*(jax.device_put(np.asarray(c), fsh) for c in fields))
        self.state = SimState(
            fields=fields, species=tuple(species),
            step=jnp.zeros((), jnp.int32), drift=jnp.zeros((), jnp.float32),
            window_x0=(jnp.zeros((), jnp.int32) if deck.moving_window
                       else None),
        )
        self._step = jax.jit(build_balanced_step(deck, self.mesh))
        self._capmgrs = None

    def step(self, n: int = 1):
        diag = None
        for _ in range(n):
            self.state, diag = self._step(self.state)
        return diag

    def ensure_capacity(self, overflow: int = 0) -> bool:
        """Grow-only adaptive capacity (see ShardedSimulation docstring)."""
        from .balance import CapacityManager, census

        if self._capmgrs is None:
            self._capmgrs = [CapacityManager() for _ in self.state.species]
        changed = False
        species = list(self.state.species)
        psh = NamedSharding(self.mesh, P(BAXIS, None))
        for i, (p, mgr) in enumerate(zip(species, self._capmgrs)):
            new_cap = mgr.plan(census(p), overflow)
            if new_cap is None:
                continue
            cap = self.deck.round_capacity(new_cap)
            if cap > p.capacity:
                grow = jax.jit(
                    functools.partial(_pad_cap, extra=cap - p.capacity),
                    out_shardings=psh,
                )
                species[i] = ParticleState(*(grow(a) for a in p))
                changed = True
        if changed:
            self.state = self.state._replace(species=tuple(species))
        return changed

    def run(self, n_steps: Optional[int] = None,
            save_every: Optional[int] = None, saver=None):
        n_steps = n_steps if n_steps is not None else self.deck.total_steps
        save_every = (
            save_every if save_every is not None else self.deck.save_frequency
        )
        if saver is not None:
            saver(self.state, 0)
        diag = None
        for i in range(1, n_steps + 1):
            self.state, diag = self._step(self.state)
            ovf = int(diag.overflow)
            if ovf > 0 or i % 50 == 0:
                self.ensure_capacity(ovf)
            if saver is not None and i % save_every == 0:
                saver(self.state, i)
        return diag


def _pad_cap(a, *, extra: int):
    return jnp.pad(a, ((0, 0), (0, extra)))
