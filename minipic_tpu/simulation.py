"""Single-device simulation driver: the full PIC step, jitted.

This is the on-device re-expression of the reference's main time loop
(PIC_2D.cpp:171-420, phases A-H) completed with the particle stages its
report designed for (Mini_PIC_2D_Report.pdf Fig. 1):

  reference phase                      here
  ---------------------------------   -----------------------------------
  (missing) field interpolation        gather_chunk (batched products)
  (missing) particle advance           boris_push + advance_positions
  (missing) current deposition         deposit_chunk (Esirkepov)
  A  updateBhalf                       update_b_half_periodic
  B  guard exchange (MPI)              pad_fields_periodic / extract_tiles
  C  updateEfull                       update_e_full_periodic (+J term)
  D/F guard exchanges                  implicit (roll stencils)
  G  tile migration (load balance)     rebin (sort into tile buckets)
  H  HDF5 save                         io.hdf5 (outside the jitted step)

Step ordering (leapfrog, E/B synchronized at integer steps — the
reference's two-half-B scheme):

  1. halo-pad fields at t^n, slice per-tile windows
  2. per species, scanned over capacity chunks:
       gather E^n,B^n -> Boris u^{n-1/2}->u^{n+1/2} -> move x^n->x^{n+1}
       -> Esirkepov J^{n+1/2} tile contributions
  3. fold J tiles -> global J
  4. B^n -> B^{n+1/2} -> E^{n+1} (with J) -> B^{n+1}
  5. boundary-wrap positions; re-bin every rebin_interval steps

Step 2 has two implementations of one contract (advance_backend picks):
on a GPU in f32 the fused Triton kernel (ops/pallas/advance.py) keeps
shapes and products in registers; elsewhere the XLA chunk scan bounds the
dense shape-matrix intermediates to [T, kchunk, tile+2g] (deck.kchunk).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .core.config import Deck
from .core.state import (
    CurrentState,
    FieldState,
    ParticleState,
    SimState,
    field_energy,
    kinetic_energy,
    momentum_sum,
)
from .fields import init as finit
from .fields.boundary import apply_damping, damping_mask
from .fields.halo import fold_block_periodic, pad_fields_periodic
from .fields.tiles import extract_field_tiles, fold_tiles
from .fields.yee import update_b_half_periodic, update_e_full_periodic
from .particles.binning import rebin, tile_counts, wrap_positions
from .particles.deposit import deposit_chunk
from .particles.gather import gather_chunk
from .particles.push import advance_positions, boris_push, velocities
from .particles.species import load_species


class StepDiag(NamedTuple):
    """Per-step on-device observables (SURVEY.md §5: the reference had no
    runtime metrics; these double as the energy/momentum-conservation
    diagnostics)."""

    field_energy: jax.Array
    kinetic_energy: jax.Array  # [n_species]
    overflow: jax.Array  # particles dropped at rebin
    momentum: jax.Array  # [n_species, 3] total w*u per species
    # Live particles per shard, all species — the per-chip WORK census
    # (occupancy-bounded kernels cost ~ live particles, so max/mean over
    # this array is the straggler skew; parallel/balance.py).  Shape
    # [rows*cols] sharded, [1] single-device.
    shard_live: jax.Array
    rebinned: jax.Array  # 1 if this step re-binned the buckets, else 0


def _tile_origins(tiling, dtype):
    t = jnp.arange(tiling.num_tiles)
    ox = (t % tiling.tile_cols).astype(dtype)[:, None] * tiling.tile_nx
    oy = (t // tiling.tile_cols).astype(dtype)[:, None] * tiling.tile_ny
    return ox, oy


def window_shift_now(step, window_x0, dt: float, tile_nx: int, dx: float):
    """Moving-window shift predicate, shared by ALL THREE drivers
    (single / block-sharded / striped — cross-driver parity is bit-level,
    so the f32 arithmetic must be ONE code path; never reimplement this
    comparison at a call site).  Shift when the light front has crossed
    the NEXT tile-column boundary beyond the shifts already taken.
    Anchoring on window_x0 (exact int32) instead of floor(step*dt) -
    floor((step-1)*dt) makes the schedule self-correcting: an f32
    rounding hiccup delays a shift by a step and the next step catches
    up, and nothing freezes at step ~2^24 where f32(step)+1 == f32(step)
    would kill an increment-based predicate for good.  Past ~2^24-scale
    step*dt products the f32 evaluation can jitter a shift by a step
    (still self-correcting, still driver-agreed); exact scheduling at
    that scale would need f64/rational arithmetic no current deck runs
    long enough to care about."""
    period = tile_nx * dx
    done = (window_x0 // tile_nx).astype(jnp.float32)
    t1 = (step.astype(jnp.float32) + 1.0) * jnp.float32(dt)
    return t1 >= (done + 1.0) * period


def window_injection_key(species_index: int, w0n):
    """Injection RNG key, shared by both drivers (and folded per GLOBAL
    tile row inside the loader): deterministic in (species, absolute
    window position) only, so restarts and any mesh decomposition inject
    identical plasma."""
    return jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(0x77), species_index), w0n)


def advance_species_tiles(
    p: ParticleState,
    ftiles: FieldState,
    *,
    qm: float,
    q: float,
    order: int,
    tile_ny: int,
    tile_nx: int,
    origins: Tuple[jax.Array, jax.Array],
    g: int,
    dt: float,
    dx: float,
    dy: float,
    kchunk: int,
    vma_axes: Tuple[str, ...] = (),
    backend: str = "xla",
    grid: Optional[Tuple[int, int]] = None,
    return_disp: bool = False,
) -> Tuple[ParticleState, Tuple[jax.Array, jax.Array, jax.Array]]:
    """Gather + push + move + deposit for one species over its tile
    buffers: the Triton kernel (backend="triton", ops/pallas/advance.py)
    or an XLA scan over `kchunk`-slot chunks.  Returns the pushed
    particles (positions unwrapped) and this species' J tile stack, plus
    the largest step displacement with return_disp.

    origins: ([T,1], [T,1]) global cell coordinates of each tile's interior
    origin (traced values in sharded runs, where they derive from the mesh
    coordinate).
    """
    t_total, cap = p.num_tiles, p.capacity
    nxt, nyt = tile_nx, tile_ny
    ox, oy = origins

    if backend == "triton":
        from .ops.pallas.advance import advance_tiles

        p_out, j, disp = advance_tiles(
            p, ftiles, origins, qm=qm, q=q, order=order, tile_ny=nyt,
            tile_nx=nxt, g=g, dt=dt, dx=dx, dy=dy, grid=grid,
            vma_axes=vma_axes)
        return (p_out, j, disp) if return_disp else (p_out, j)

    kc = min(kchunk, cap)
    if cap % kc:
        raise ValueError(
            f"bucket capacity {cap} is not a multiple of kchunk {kchunk} "
            "(Deck.round_capacity rounds it)")
    nc = cap // kc

    def chunked(a):  # [T, cap] -> [nc, T, kc]
        return a.reshape(t_total, nc, kc).transpose(1, 0, 2)

    xs = jax.tree_util.tree_map(chunked, p)
    nyg, nxg = nyt + 2 * g, nxt + 2 * g
    j0 = tuple(jnp.zeros((t_total, nyg, nxg), p.x.dtype) for _ in range(3))
    if vma_axes:
        # Inside shard_map the scan carry must carry the same varying-axis
        # type as the body outputs (jax>=0.9 vma typing).
        j0 = tuple(jax.lax.pcast(z, vma_axes, to="varying") for z in j0)

    def body(carry, chunk: ParticleState):
        jx, jy, jz = carry
        # Nearest-image centering (see tile_local_coords): box-wrapped
        # particles in stale boundary buckets fold back into the tile's
        # guard band instead of sitting +-nx off-window.
        xi0, eta0 = tile_local_coords(chunk.x, chunk.y, (ox, oy), nxt, nyt, grid)
        ef = gather_chunk(ftiles, xi0, eta0, nyt, nxt, g, order)
        px, py, pz = boris_push(
            chunk.px, chunk.py, chunk.pz, ef.ex, ef.ey, ef.ez, ef.bx, ef.by, ef.bz, qm, dt
        )
        x1, y1 = advance_positions(chunk.x, chunk.y, px, py, pz, dt, dx, dy)
        _, _, vz = velocities(px, py, pz)
        djx, djy, djz = deposit_chunk(
            xi0, eta0, xi0 + (x1 - chunk.x), eta0 + (y1 - chunk.y), vz,
            q * chunk.w, nyt, nxt, g, order, dt, dx, dy
        )
        out = ParticleState(x1, y1, px, py, pz, chunk.w)
        return (jx + djx, jy + djy, jz + djz), out

    (jx, jy, jz), ys = jax.lax.scan(body, j0, xs)

    def unchunk(a):  # [nc, T, kc] -> [T, cap]
        return a.transpose(1, 0, 2).reshape(t_total, cap)

    p_out = jax.tree_util.tree_map(unchunk, ys)
    if return_disp:
        return p_out, (jx, jy, jz), max_step_displacement([p_out], dt, dx, dy)
    return p_out, (jx, jy, jz)


def tile_local_coords(x, y, origins, tile_nx: int, tile_ny: int,
                      grid: Optional[Tuple[int, int]] = None):
    """Bucket-tile-local coordinates with nearest-image centering.

    Between re-binning passes a particle may sit in a stale bucket; if it
    wrapped the periodic box its raw offset to the bucket's tile is ~+-nx.
    Centering folds it back into the tile's guard band so shape windows
    stay valid.  grid=(nx, ny) for periodic domains; None = raw offsets."""
    ox, oy = origins
    xi = x - ox
    eta = y - oy
    if grid is not None:
        gnx, gny = grid
        # Reciprocal multiply, NOT division: bit-identical to the GPU
        # kernel's fold (ops/pallas/advance.py), so diagnostics (rho for
        # continuity/Gauss) evaluate shapes at the same f32 coordinates
        # the deposit used.
        xi = xi - gnx * jnp.floor((xi + (gnx - tile_nx) * 0.5) * (1.0 / gnx))
        eta = eta - gny * jnp.floor((eta + (gny - tile_ny) * 0.5) * (1.0 / gny))
    return xi, eta


def max_step_displacement(species_states, dt: float, dx: float, dy: float):
    """Largest per-axis displacement (in cells) any alive particle made
    this step, from the pushed momenta — the on-device observable behind
    drift-triggered re-binning (Deck.rebin_trigger)."""
    disp = jnp.zeros((), jnp.float32)
    for p in species_states:
        inv_g = jax.lax.rsqrt(1.0 + p.px * p.px + p.py * p.py + p.pz * p.pz)
        m = jnp.maximum(jnp.abs(p.px) * (dt / dx), jnp.abs(p.py) * (dt / dy))
        m = jnp.where(p.w > 0, m * inv_g, 0.0)
        disp = jnp.maximum(disp, jnp.max(m).astype(jnp.float32))
    return disp


def advance_backend(deck: Deck) -> str:
    """The particle advance that runs: the fused Triton kernel when the
    default device (``jax.default_device`` if set) is a GPU and the deck
    is f32, the XLA chunk scan everywhere else."""
    dev = jax.config.jax_default_device
    if dev is None:
        platform = jax.default_backend()
    else:
        platform = dev if isinstance(dev, str) else dev.platform
    if platform == "gpu" and deck.dtype == jnp.float32:
        return "triton"
    return "xla"


def rebin_flag(do_rebin_pred) -> jax.Array:
    """StepDiag.rebinned from the step's re-bin predicate (None = every
    step)."""
    if do_rebin_pred is None:
        return jnp.ones((), jnp.int32)
    return jnp.asarray(do_rebin_pred).astype(jnp.int32)


def build_step(deck: Deck):
    """Compile-ready step function SimState -> (SimState, StepDiag)."""
    deck.validate()
    tiling = deck.tiling
    g = deck.guard
    dt, dx, dy = deck.dt, deck.dx, deck.dy
    backend = advance_backend(deck)
    periodic = deck.boundary == "periodic"
    mask = (
        None
        if periodic
        else damping_mask(deck.ny, deck.nx, deck.absorb_width, dtype=deck.dtype)
    )

    def step(state: SimState) -> Tuple[SimState, StepDiag]:
        f = state.fields
        fpad = pad_fields_periodic(f, g)
        ftiles = extract_field_tiles(
            fpad, tiling.tile_rows, tiling.tile_cols, tiling.tile_ny, tiling.tile_nx, g
        )

        new_species = []
        jx = jy = jz = None
        kes = []
        moms = []
        center_grid = (deck.nx, deck.ny) if periodic else None
        trigger_drift = bool(deck.species) and deck.uses_drift_trigger()
        disps = []
        for spec, p in zip(deck.species, state.species):
            adv = advance_species_tiles(
                p,
                ftiles,
                qm=spec.charge / spec.mass,
                q=spec.charge,
                order=spec.shape_order,
                tile_ny=tiling.tile_ny,
                tile_nx=tiling.tile_nx,
                origins=_tile_origins(tiling, deck.dtype),
                g=g,
                dt=dt,
                dx=dx,
                dy=dy,
                kchunk=deck.kchunk,
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
            kes.append(kinetic_energy(pnew, spec.mass))
            moms.append(momentum_sum(pnew, spec.mass))

        if jx is not None:
            def to_global(t):
                tr = t.reshape(
                    tiling.tile_rows, tiling.tile_cols, tiling.tile_ny + 2 * g, tiling.tile_nx + 2 * g
                )
                return fold_block_periodic(fold_tiles(tr, tiling.tile_ny, tiling.tile_nx, g), g)

            j = CurrentState(to_global(jx), to_global(jy), to_global(jz))
        else:
            j = None

        f = update_b_half_periodic(f, dt, dx, dy)
        f = update_e_full_periodic(f, dt, dx, dy, j)
        f = update_b_half_periodic(f, dt, dx, dy)
        if mask is not None:
            f = apply_damping(f, mask)

        # Moving window: a shift rolls BUCKETS, so any particle that left
        # its trailing-column tile since the last re-bin would be dropped
        # with its stale bucket despite being in-window — force the
        # buckets fresh on shift steps (computed here so the re-bin
        # predicate below can fold it in; the shift itself happens after
        # re-binning).
        if deck.moving_window:
            if state.window_x0 is None:
                raise ValueError(
                    "deck.moving_window but SimState.window_x0 is unset — "
                    "initialize it to 0 (Simulation does)")
            shift_now = window_shift_now(state.step, state.window_x0, dt,
                                         tiling.tile_nx, dx)
        else:
            shift_now = None

        if trigger_drift:
            if state.drift is None:
                raise ValueError(
                    "deck uses drift-triggered re-binning but SimState.drift "
                    "is unset — initialize it to 0.0 (Simulation does)"
                )
            disp = functools.reduce(jnp.maximum, disps)
            drift_now = state.drift + disp
            do_rebin_pred = drift_now > deck.drift_threshold()
            if shift_now is not None:
                do_rebin_pred = do_rebin_pred | shift_now
        else:
            drift_now = state.drift
            do_rebin_pred = (
                None if deck.rebin_interval == 1
                else state.step % deck.rebin_interval == 0
            )
            if shift_now is not None and do_rebin_pred is not None:
                do_rebin_pred = do_rebin_pred | shift_now

        overflow = jnp.zeros((), jnp.int32)
        binned = []
        for p in new_species:
            p = wrap_positions(p, deck.nx, deck.ny, periodic)

            def do(pp):
                return rebin(pp, tiling)

            if do_rebin_pred is None:
                p, ov = do(p)
            else:
                def skip(pp):
                    return pp, jnp.zeros((), jnp.int32)

                p, ov = jax.lax.cond(do_rebin_pred, do, skip, p)
            overflow = overflow + ov
            binned.append(p)

        if trigger_drift:
            # The budget restarts after every re-bin.
            drift_now = jnp.where(do_rebin_pred, 0.0, drift_now)

        live = jnp.zeros((), jnp.int32)
        for p in binned:
            live = live + jnp.sum((p.w > 0).astype(jnp.int32))
        diag = StepDiag(
            field_energy=field_energy(f, dx, dy),
            kinetic_energy=jnp.stack(kes) if kes else jnp.zeros((0,), deck.dtype),
            overflow=overflow,
            momentum=jnp.stack(moms) if moms else jnp.zeros((0, 3), deck.dtype),
            shard_live=live.reshape(1),
            rebinned=rebin_flag(do_rebin_pred),
        )
        window_x0 = state.window_x0
        if deck.moving_window:
            # Tile-quantum window advance: the frame follows the pulse at
            # c = 1, shifting one TILE COLUMN whenever the lab-frame light
            # front crosses another tile_nx cells.  Shifting by tile
            # quanta makes the particle side a pure bucket roll: tile-
            # local coordinates (and hence the drift watermark, shape
            # windows, and re-bin budget) are untouched; only the stored
            # window-frame x picks up a -tile_nx.  Trailing-column
            # particles outflow (physical, not counted as overflow); the
            # leading column is loaded fresh at its ABSOLUTE position
            # (inject_column), RNG keyed by the absolute column so a
            # restarted run injects identical plasma.
            from .particles.species import inject_column

            shift_c = tiling.tile_nx

            col_mask = jax.lax.broadcasted_iota(
                jnp.int32, (deck.ny, deck.nx), 1) < (deck.nx - shift_c)

            def _shift(args):
                f_, sps, w0 = args
                w0n = w0 + shift_c
                f_ = FieldState(*(
                    jnp.where(col_mask, jnp.roll(c, -shift_c, axis=1), 0.0)
                    for c in f_))
                out = []
                for i, (spec, p) in enumerate(zip(deck.species, sps)):
                    key = window_injection_key(i, w0n)
                    inj = inject_column(spec, deck.domain, tiling,
                                        p.capacity, key, w0n, deck.dtype)
                    chans = []
                    for name in ParticleState._fields:
                        a = getattr(p, name).reshape(
                            tiling.tile_rows, tiling.tile_cols, -1)
                        a = jnp.roll(a, -1, axis=1)
                        if name == "x":
                            a = a - shift_c
                        a = a.at[:, -1, :].set(getattr(inj, name))
                        chans.append(a.reshape(p.num_tiles, p.capacity))
                    out.append(ParticleState(*chans))
                return f_, tuple(out), w0n

            def _keep(args):
                return args

            f, binned, window_x0 = jax.lax.cond(
                shift_now, _shift, _keep, (f, tuple(binned), window_x0))
            binned = list(binned)

        new_state = SimState(
            fields=f, species=tuple(binned), step=state.step + 1,
            drift=drift_now, window_x0=window_x0,
        )
        return new_state, diag

    return step


# ----------------------------------------------------------------------


class Simulation:
    """User-facing driver (the reference's `main` PIC_2D.cpp:22-463, minus
    the MPI boilerplate).  Holds a deck, builds initial state, owns the
    jitted step.  IO/diagnostics live outside the jit boundary."""

    def __init__(self, deck: Deck, fields: Optional[FieldState] = None, seed: int = 0):
        deck.validate()
        self.deck = deck
        tiling = deck.tiling
        cap = deck.capacity()
        key = jax.random.PRNGKey(seed)
        species = []
        for i, spec in enumerate(deck.species):
            species.append(
                load_species(
                    spec, deck.domain, tiling, cap, jax.random.fold_in(key, i), deck.dtype
                )
            )
        if fields is None:
            fields = FieldState.zeros(deck.ny, deck.nx, deck.dtype)
        self.state = SimState(
            fields=fields, species=tuple(species), step=jnp.zeros((), jnp.int32),
            drift=jnp.zeros((), jnp.float32),
            window_x0=(jnp.zeros((), jnp.int32) if deck.moving_window
                       else None),
        )
        self._step = jax.jit(build_step(deck))
        self._capmgrs = None  # per-species CapacityManagers, lazily built

    def step(self, n: int = 1) -> StepDiag:
        diag = None
        for _ in range(n):
            self.state, diag = self._step(self.state)
        return diag

    def ensure_capacity(self, overflow: int = 0) -> bool:
        """Adapt particle bucket capacity to the load (the adaptive-capacity
        half of the load-balance story, parallel/balance): grow on overflow
        or high occupancy, shrink back after a sustained calm spell so a
        transient hot spot does not inflate every tile's dense compute for
        the rest of the run.  Returns True if capacity changed (the jitted
        step retraces on the new shapes; geometric growth + shrink
        hysteresis bound the number of recompiles over a run)."""
        from .parallel.balance import CapacityManager, census, with_capacity

        if self._capmgrs is None:
            self._capmgrs = [CapacityManager() for _ in self.state.species]
        changed = False
        species = list(self.state.species)
        for i, (p, mgr) in enumerate(zip(species, self._capmgrs)):
            new_cap = mgr.plan(census(p), overflow)
            if new_cap is None:
                continue
            cap = self.deck.round_capacity(new_cap)
            if cap > p.capacity:
                species[i] = with_capacity(p, cap)
                changed = True
            elif cap < p.capacity:
                try:
                    species[i] = with_capacity(p, cap, self.deck.tiling)
                    changed = True
                except ValueError:
                    # The positional census (drifted particles in stale
                    # buckets) does not fit the smaller buckets yet —
                    # defer the shrink to a later calm check.
                    pass
        if changed:
            self.state = self.state._replace(species=tuple(species))
        return changed

    def run(self, n_steps: Optional[int] = None, save_every: Optional[int] = None, saver=None):
        """Run the deck; call `saver(state, step)` on the save cadence
        (reference Phase H, PIC_2D.cpp:414-419)."""
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
