"""Declarative input deck.

The reference configures runs by editing compile-time constants in ``main``
(``PIC_2D.cpp:36,57-74``) and re-compiling; the only machine-readable config
artifact is the exported ``params.txt`` (``PIC_2D.cpp:425-438``).  Here the
deck is a frozen dataclass tree: hashable (usable as a jit static argument),
serializable to/from the same ``params.txt`` keys plus species sections, and
the single source of truth for every derived quantity (dx, dt, tile grid,
mesh shape).

Units are the reference's normalized set: lengths in c/omega_p, time in
1/omega_p, fields in m_e c omega_p / e, charge/mass in e / m_e, density in
the reference density n0 (File_reader.py:140-142, report §4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import jax.numpy as jnp

from .geometry import Domain, Tiling, find_best_grid


@dataclasses.dataclass(frozen=True)
class SpeciesSpec:
    """One particle species.

    The reference's ``Particle`` struct (``Auxiliar_functions.h:16-21``)
    fixes the per-particle state contract {charge, x, y, px, py, pz}; the
    species-level fields here (ppc, density/drift profiles, shape order) are
    the loading parameters the reference left unimplemented.
    """

    name: str
    charge: float = -1.0  # units of e
    mass: float = 1.0  # units of m_e
    ppc: int = 16  # macroparticles per cell
    # density(x, y) -> n/n0; None means uniform density 1.
    density: Optional[Callable] = None
    # Drift momentum (m_e c) and isotropic thermal momentum spread.
    ux: float = 0.0
    uy: float = 0.0
    uz: float = 0.0
    uth: float = 0.0
    # Per-axis thermal spread overrides (anisotropic loads, e.g. Weibel).
    uth_x: Optional[float] = None
    uth_y: Optional[float] = None
    uth_z: Optional[float] = None
    # Particle shape order: 1 = linear (CIC), 2 = quadratic (TSC).
    shape_order: int = 1
    # How the density profile maps to macroparticles:
    #   "weight": uniform ppc everywhere, w = n dxdy/ppc (quiet, the
    #             default — noise-free gradients, uniform per-tile counts);
    #   "count":  uniform weight w = n_max dxdy/ppc, per-cell LIVE COUNT
    #             thinned to ~ppc * n/n_max (deterministic sub-lattice
    #             culling).  Counts now follow the profile — the loader for
    #             load-balance stress decks where per-chip work (~ live
    #             particles) must actually contrast.
    load_mode: str = "weight"
    # Profile ceiling for load_mode="count" (the thinning denominator and
    # the survivors' uniform weight): None derives max(n) over whatever
    # domain the loader evaluates — fine for a static box, WRONG for a
    # moving window (each injected column would renormalize against its
    # own local max).  Declare it for windowed count-mode decks;
    # Deck.validate enforces.
    n_max: Optional[float] = None

    def thermal_spread(self) -> Tuple[float, float, float]:
        return (
            self.uth if self.uth_x is None else self.uth_x,
            self.uth if self.uth_y is None else self.uth_y,
            self.uth if self.uth_z is None else self.uth_z,
        )


@dataclasses.dataclass(frozen=True)
class Deck:
    """Full run description."""

    # --- domain & grid (reference PIC_2D.cpp:58-65) ---
    box_x: float = 10.0
    box_y: float = 10.0
    nx: int = 450
    ny: int = 450
    guard: int = 2  # halo width for comm + deposition support

    # --- tiling (reference: 36 tiles/rank of 25x25 cells, PIC_2D.cpp:36-38) ---
    tile_nx: int = 25
    tile_ny: int = 25

    # --- time stepping (reference PIC_2D.cpp:70-74) ---
    dt_factor: float = 0.5  # dt = dt_factor * dt_CFL
    sim_time: float = 500.0
    save_frequency: int = 25

    # --- physics ---
    species: Tuple[SpeciesSpec, ...] = ()
    boundary: str = "periodic"  # or "absorbing" (masked damping layer)
    absorb_width: int = 16  # damping layer width in cells (absorbing only)
    # Moving window (laser-plasma staging): the simulation frame follows
    # the pulse at c, advancing in TILE-COLUMN quanta — a window shift is
    # then a pure bucket roll (tile-local coordinates, and hence the
    # drift watermark and all shape windows, are untouched), the trailing
    # tile column outflows, and a freshly-loaded column enters at the
    # leading edge (particles/species.inject_column, keyed by the
    # absolute column so restarts are deterministic).  The reference has
    # no analogue; this is the capability its laser test case (report
    # §4) points toward.  Requires boundary="absorbing".  Supported by
    # all three drivers: Simulation, the block-sharded step
    # (parallel/step.py — shift predicates mesh-agreed, equivalence
    # tested in tests/test_moving_window.py), and the striped/balanced
    # driver (parallel/balanced.py).
    moving_window: bool = False

    # --- numerics / machine mapping ---
    precision: str = "f32"  # "f32" | "f64" (f64 needs jax_enable_x64)
    # Device mesh (rows, cols); None -> near-square over available devices.
    mesh_shape: Optional[Tuple[int, int]] = None
    # Particle buffer capacity per tile; None -> auto from ppc with headroom.
    tile_capacity: Optional[int] = None
    capacity_headroom: float = 1.5
    # Re-bin particles into tiles every this many steps (guard cells bound
    # the allowed drift in between; see particles/binning.py).
    rebin_interval: int = 1
    # When to re-bin: "drift" re-bins only when the *measured* accumulated
    # particle drift (tracked on device each step) approaches the guard
    # slack — typically 5-20x less often than the light-speed-bound
    # interval schedule for thermal plasmas, at identical correctness
    # (the guard invariant is enforced against actual motion, not the
    # worst case).  "interval" is the fixed every-rebin_interval-steps
    # schedule; "auto" = drift.
    rebin_trigger: str = "auto"
    # Particle slots per chunk of the XLA advance's scan: bounds its dense
    # [T, kchunk, tile+2g] shape matrices.  Bucket capacity is rounded up
    # to a multiple of it (or is one smaller chunk).  The named decks
    # carry the value measured fastest on the H100 at the headline deck
    # (decks/standard.py).
    kchunk: int = 256

    def shape_reach(self) -> float:
        """Half-width of the widest species' deposition support in cells
        (+<=1 cell of motion is accounted separately)."""
        max_order = max((s.shape_order for s in self.species), default=1)
        return 1.0 if max_order == 1 else 1.5

    def cfl_step_cells(self) -> float:
        """Worst-case per-step displacement in cells (light-speed bound)."""
        return self.dt / min(self.dx, self.dy)

    def drift_threshold(self) -> float:
        """Drift-triggered re-bin threshold (cells): re-bin once measured
        accumulated drift exceeds this.  Two CFL steps below the guard
        slack: one for the step after the trigger and one of margin."""
        return self.guard - self.shape_reach() - 2.0 * self.cfl_step_cells()

    def force_threshold(self) -> float:
        """Accumulated drift beyond which one more light-speed step would
        push a particle's shape support outside the guard band."""
        return self.guard - self.shape_reach() - self.cfl_step_cells()

    def uses_drift_trigger(self) -> bool:
        if self.rebin_trigger == "drift":
            return True
        if self.rebin_trigger == "auto":
            # Fall back to the interval schedule when the guard leaves no
            # measured-drift budget (e.g. minimal guard + wide shapes).
            return self.drift_threshold() > 0
        return False

    # Per-direction cross-shard particle exchange buffer capacity (slots);
    # None -> auto from tile capacity.  Only the shard-boundary tiles feed
    # these, so a fraction of one tile's capacity suffices.
    exchange_capacity: Optional[int] = None

    def exchange_cap(self, block_ny: int, block_nx: int) -> int:
        """Per-direction routing buffer size.  Worst case is bursty: a quiet-
        start lattice sends a whole boundary column/row of a shard across in
        one step — edge_cells * ppc particles simultaneously — so the buffer
        scales with the shard edge length, with 2x headroom."""
        if self.exchange_capacity is not None:
            return self.exchange_capacity
        ppc = max((s.ppc for s in self.species), default=1)
        burst = max(block_ny, block_nx) * ppc * 2
        return max(64, -(-burst // 8) * 8)

    # ------------------------------------------------------------------
    @property
    def dtype(self):
        return jnp.float64 if self.precision == "f64" else jnp.float32

    @property
    def domain(self) -> Domain:
        return Domain(self.box_x, self.box_y, self.nx, self.ny)

    @property
    def tiling(self) -> Tiling:
        return Tiling.for_domain(self.domain, self.tile_nx, self.tile_ny)

    @property
    def dx(self) -> float:
        return self.domain.dx

    @property
    def dy(self) -> float:
        return self.domain.dy

    @property
    def dt(self) -> float:
        return self.dt_factor * self.domain.dt_courant()

    @property
    def total_steps(self) -> int:
        return int(self.sim_time / self.dt)

    def capacity(self) -> int:
        """Particle slots per tile (static shape), a kchunk multiple."""
        if self.tile_capacity is not None:
            return self.round_capacity(self.tile_capacity)
        ppc = max((s.ppc for s in self.species), default=0)
        nominal = ppc * self.tile_nx * self.tile_ny
        return self.round_capacity(
            max(8, int(math.ceil(nominal * self.capacity_headroom))))

    def round_capacity(self, cap: int) -> int:
        """`cap` rounded up to whole chunks of the XLA advance's scan (a
        bucket smaller than one chunk is one chunk of its own size)."""
        if cap > self.kchunk:
            return -(-cap // self.kchunk) * self.kchunk
        return min(self.kchunk, -(-cap // 8) * 8)

    def mesh_dims(self, n_devices: int) -> Tuple[int, int]:
        """(rows, cols) device grid; near-square like the reference's rank
        grid (Auxiliar_functions.cpp:16-22)."""
        if self.mesh_shape is not None:
            return self.mesh_shape
        return find_best_grid(n_devices)

    def validate(self) -> None:
        t = self.tiling  # raises on divisibility violation
        if 2 * self.guard > min(self.tile_nx, self.tile_ny):
            # fields/tiles.py window extract/fold requires guard strips from
            # adjacent tiles only (2*guard <= tile edge).
            raise ValueError(
                f"guard={self.guard} too large for tile "
                f"{self.tile_ny}x{self.tile_nx}: need 2*guard <= tile edge"
            )
        for s in self.species:
            support = s.shape_order + 2  # shape width + <=1 cell of motion
            if self.guard * 2 < support:
                raise ValueError(
                    f"guard={self.guard} too small for shape_order="
                    f"{s.shape_order} (deposition support {support})"
                )
        if self.dt_factor >= 1.0:
            raise ValueError("dt_factor must be < 1 (CFL)")
        if self.kchunk < 1:
            raise ValueError(f"kchunk must be >= 1, got {self.kchunk}")
        if self.rebin_trigger not in ("auto", "drift", "interval"):
            raise ValueError(f"unknown rebin_trigger {self.rebin_trigger!r}")
        if self.moving_window and self.boundary != "absorbing":
            raise ValueError(
                "moving_window requires boundary='absorbing' (the window "
                "outflows at the trailing edge; periodic wrap would "
                "re-inject stale plasma)"
            )
        if self.moving_window:
            for s in self.species:
                if s.load_mode == "count" and s.density is not None                         and s.n_max is None:
                    raise ValueError(
                        f"species {s.name!r}: load_mode='count' under a "
                        "moving window needs an explicit n_max (each "
                        "injected column would otherwise renormalize "
                        "against its own local profile max)"
                    )
        if self.species and self.rebin_trigger == "drift":
            # Drift-triggered re-binning enforces the guard invariant
            # against *measured* motion; the deck only needs room for one
            # worst-case step beyond the threshold.  ("auto" falls back to
            # the interval schedule instead of erroring.)
            if self.drift_threshold() <= 0:
                raise ValueError(
                    f"guard={self.guard} leaves no drift budget for "
                    f"shape reach {self.shape_reach()} + one CFL step — "
                    "increase guard or use rebin_trigger='interval' with "
                    "rebin_interval=1"
                )
        elif self.species and not self.uses_drift_trigger() and self.rebin_interval > 1:
            # The interval bound applies only when the interval schedule is
            # actually in effect — an "auto" deck with drift budget runs the
            # drift trigger, where rebin_interval is ignored.
            # Between re-binning passes a particle may drift from its stale
            # tile; its full shape support must stay inside the guard band.
            max_drift = self.rebin_interval * self.dt / min(self.dx, self.dy)
            slack = self.guard - self.shape_reach()
            if max_drift > slack:
                raise ValueError(
                    f"rebin_interval={self.rebin_interval} allows {max_drift:.2f} "
                    f"cells of drift but guard={self.guard} only tolerates {slack}"
                )

    # ------------------------------------------------------------------
    # params.txt round trip — key set from reference PIC_2D.cpp:425-438,
    # consumed by the reference's File_reader.read_params (File_reader.py:15).
    def params_txt(self, mesh_cols: int = 1, mesh_rows: int = 1) -> str:
        lines = [
            f"box_x={self.box_x}",
            f"box_y={self.box_y}",
            f"nx_global={self.nx}",
            f"ny_global={self.ny}",
            f"guard={self.guard}",
            f"interior_nx={self.tile_nx}",
            f"interior_ny={self.tile_ny}",
            f"sim_time={self.sim_time}",
            f"dt={self.dt}",
            f"total_steps={self.total_steps}",
        ]
        return "\n".join(lines) + "\n"


def deck_replace(deck: Deck, **kw) -> Deck:
    return dataclasses.replace(deck, **kw)
