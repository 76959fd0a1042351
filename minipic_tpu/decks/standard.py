"""Named run decks.

``reference_pulse`` reproduces the reference's shipped configuration
(PIC_2D.cpp:57-74 + the active Test-3 init) — fields-only, HDF5 output
compatible with its File_reader.  ``headline`` is the throughput deck
(1e8 particles on 512^2).  The others are the BASELINE.json benchmark
configs the reference never reached, plus load-balance and moving-window
variants.

Particle decks use 8x8 tiles with guard 4: the guard funds the
drift-triggered re-bin budget (Deck.drift_threshold), so a thermal
plasma re-bins every few tens of steps.  ``KCHUNK`` is the XLA advance's
scan chunk measured fastest on the H100 at the headline deck.

Each case bundles a Deck with optional initial fields and a state "seeder"
(perturbations applied after loading, e.g. the two-stream velocity seed).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import jax.numpy as jnp

from ..core.config import Deck, SpeciesSpec
from ..fields import init as finit


@dataclasses.dataclass
class Case:
    name: str
    deck: Deck
    init_fields: Optional[Callable] = None  # (deck) -> FieldState
    seed_state: Optional[Callable] = None  # (state, deck) -> state
    notes: str = ""


# XLA advance scan chunk (Deck.kchunk), measured on the H100 at the
# headline deck: see PERF.md.
KCHUNK = 1024


def _fit_tile(n: int, target: int = 25) -> int:
    """Largest divisor of n that is <= target (tile sizes must divide the
    grid, 'Read me.pdf' p.1 WARNING)."""
    for t in range(min(target, n), 0, -1):
        if n % t == 0:
            return t
    return 1


def reference_pulse(nx: int = 450, ny: int = 450) -> Case:
    """The reference's canonical run: 10x10 box, 450^2 cells, cos^2 pulse,
    dt = 0.5 dt_CFL, save every 25 (PIC_2D.cpp:57-74, params.txt)."""
    deck = Deck(box_x=10.0, box_y=10.0, nx=nx, ny=ny,
                tile_nx=_fit_tile(nx), tile_ny=_fit_tile(ny),
                sim_time=500.0, save_frequency=25)
    return Case(
        "reference_pulse",
        deck,
        init_fields=lambda d: finit.pulse_x(d.domain, dtype=d.dtype),
        notes="fields-only parity run; File_reader-compatible output",
    )


def two_stream(nx: int = 64, ny: int = 64, ppc: int = 16, u0: float = 0.2) -> Case:
    """BASELINE config 1: two-stream instability, TSC shapes (the
    10k-step energy-acceptance config, scripts/energy_probe.py)."""
    lx = 2 * math.pi * u0 / 0.45  # mode 1 near peak growth
    deck = Deck(
        box_x=lx, box_y=lx * ny / nx, nx=nx, ny=ny, tile_nx=8, tile_ny=8,
        guard=4, kchunk=KCHUNK,
        species=(
            SpeciesSpec("right", charge=-1.0, mass=1.0, ppc=ppc, ux=u0,
                        shape_order=2),
            SpeciesSpec("left", charge=-1.0, mass=1.0, ppc=ppc, ux=-u0,
                        shape_order=2),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc,
                        shape_order=2),
        ),
        sim_time=80.0,
    )

    def seed(state, d):
        k1 = 2 * math.pi / d.box_x
        sp = list(state.species)
        for i in (0, 1):
            p = sp[i]
            sp[i] = p._replace(w=p.w * 0.5, px=p.px + 1e-3 * jnp.sin(k1 * p.x * d.dx))
        return state._replace(species=tuple(sp))

    return Case("two_stream", deck, seed_state=seed,
                notes="growth then saturation; energy drift < 0.1% over 10k steps")


def weibel(nx: int = 128, ny: int = 128, ppc: int = 16, uz: float = 0.6) -> Case:
    """BASELINE config 2: Weibel instability — counter-streaming along z,
    anisotropy drives in-plane magnetic filaments; check B-energy growth."""
    deck = Deck(
        box_x=12.8, box_y=12.8, nx=nx, ny=ny, tile_nx=8, tile_ny=8,
        guard=4, kchunk=KCHUNK,
        species=(
            SpeciesSpec("up", charge=-1.0, mass=1.0, ppc=ppc, uz=uz,
                        uth=0.01, shape_order=2),
            SpeciesSpec("down", charge=-1.0, mass=1.0, ppc=ppc, uz=-uz,
                        uth=0.01, shape_order=2),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc,
                        shape_order=2),
        ),
        sim_time=60.0,
    )

    def seed(state, d):
        sp = list(state.species)
        for i in (0, 1):
            sp[i] = sp[i]._replace(w=sp[i].w * 0.5)
        return state._replace(species=tuple(sp))

    return Case("weibel", deck, seed_state=seed,
                notes="magnetic energy growth-rate check (diag.growth_rate)")


def landau(nx: int = 256, ny: int = 256, ppc: int = 16) -> Case:
    """BASELINE config 3: Landau damping with TSC (quadratic) shapes.
    k lambda_D = 0.35: Langmuir wave damps at the kinetic rate while total
    energy stays conserved (the scheme-quality diagnostic)."""
    uth = 0.05
    klam = 0.35
    k = klam / uth  # k lambda_D = k uth / wp
    lx = 2 * math.pi / k
    deck = Deck(
        box_x=lx, box_y=lx, nx=nx, ny=ny, tile_nx=8, tile_ny=8, guard=4,
        kchunk=KCHUNK,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=uth, shape_order=2),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc, uth=0.0, shape_order=2),
        ),
        sim_time=40.0,
    )

    def seed(state, d):
        k1 = 2 * math.pi / d.box_x
        sp = list(state.species)
        p = sp[0]
        sp[0] = p._replace(px=p.px + 0.1 * uth * jnp.sin(k1 * p.x * d.dx))
        return state._replace(species=tuple(sp))

    return Case("landau", deck, seed_state=seed,
                notes="energy-conservation diagnostic with quadratic shapes")


def laser_plasma(nx: int = 512, ny: int = 512, ppc: int = 4) -> Case:
    """BASELINE config 4: laser into underdense plasma, absorbing
    boundaries, particles streaming across tiles."""
    box = 51.2

    def slab(x, y):
        # Underdense slab with a soft ramp starting at x = 15.
        return 0.05 * 0.5 * (1.0 + jnp.tanh((x - 15.0) / 2.0))

    deck = Deck(
        # 16x16 tiles at the default guard 2: CIC shapes leave no drift
        # budget there, so this deck re-bins on the interval schedule.
        box_x=box, box_y=box, nx=nx, ny=ny, tile_nx=16, tile_ny=16,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.01, density=slab),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc, density=slab),
        ),
        boundary="absorbing", absorb_width=24, sim_time=60.0,
    )
    return Case(
        "laser_plasma",
        deck,
        init_fields=lambda d: finit.gaussian_laser_x(
            d.domain, a0=2.0, k0=10.0, x_center=6.0, length=3.0, waist=8.0, dtype=d.dtype
        ),
        notes="absorbing boundaries; wakefield; cross-tile particle flux",
    )


def headline(nx: int = 512, ny: int = 512, ppc: int = 381) -> Case:
    """The throughput deck: 1e8 thermal electrons (381 ppc, uth = 0.05,
    TSC) on a 512^2 periodic grid with an implied immobile neutralizing
    background, 8x8 tiles at guard 4 and the drift-triggered re-bin.
    1.1x bucket headroom: 4,096 tiles of ~27k slots, ~2.7 GB of particle
    state."""
    deck = Deck(
        box_x=nx / 10.0, box_y=ny / 10.0, nx=nx, ny=ny, tile_nx=8, tile_ny=8,
        guard=4, kchunk=KCHUNK, capacity_headroom=1.1,
        species=(SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.05,
                             shape_order=2),),
    )
    return Case("headline", deck,
                notes="1e8 particles, 512^2, TSC: the pushes/s deck")


def load_balance_stress(nx: int = 1024, ny: int = 1024, n_particles: float = None) -> Case:
    """BASELINE config 5: nonuniform density blob on a 1024^2 grid,
    ~2e8 particles (95 ppc x 2 species), sharded over the available
    cards.  The blob concentrates
    *weight* in the center while particle COUNTS stay uniform per tile
    (weighted loading) — so per-chip work (~ live particles, the
    occupancy-bounded kernels skip dead slots) starts balanced.  This deck
    stresses the capacity/weight axis; ``load_balance_stress_counts``
    stresses the work-skew axis with a real count contrast."""
    if n_particles is None:
        n_particles = 95.0 * nx * ny  # 1e8 at the nominal 1024^2
    ppc = max(1, round(n_particles / (nx * ny)))

    def blob(x, y):
        r2 = ((x - 51.2) ** 2 + (y - 51.2) ** 2) / (12.0**2)
        return 0.1 + 4.0 * jnp.exp(-r2)

    deck = Deck(
        # Weighted loading (graded per-particle w) is this deck's stress
        # axis; the count-mode variant below stresses work skew.
        box_x=102.4, box_y=102.4, nx=nx, ny=ny, tile_nx=8, tile_ny=8, guard=4,
        kchunk=KCHUNK,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.05, density=blob),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc, density=blob),
        ),
        sim_time=10.0,
    )
    return Case("load_balance_stress", deck,
                notes="sharded; uniform slot load under nonuniform density")


def load_balance_stress_counts(nx: int = 1024, ny: int = 1024, ppc: int = 95) -> Case:
    """Count-contrast variant of load_balance_stress: the same blob loaded
    with load_mode='count' — constant-weight particles, per-cell LIVE
    COUNTS following the 0.1..4.1 profile (a ~41x count contrast between
    blob center and edge).  Per-chip work (~ live particles under the
    occupancy-bounded kernels) now genuinely contrasts: on a block mesh
    the blob-center shards are the stragglers.  StepDiag.shard_live /
    RunHistory.live_skew is the observable; balanced (striped) placement
    is the fix (parallel/balanced.py)."""

    def blob(x, y):
        r2 = ((x - 51.2) ** 2 + (y - 51.2) ** 2) / (12.0**2)
        return 0.1 + 4.0 * jnp.exp(-r2)

    deck = Deck(
        # Count-mode loading keeps every survivor at the same weight
        # (n_max*dxdy/ppc); n_max is declared (blob peak 0.1 + 4.0) so
        # the weight is global, not shard-local.
        box_x=102.4, box_y=102.4, nx=nx, ny=ny, tile_nx=8, tile_ny=8, guard=4,
        kchunk=KCHUNK,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.05,
                        density=blob, load_mode="count", n_max=4.1),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc,
                        density=blob, load_mode="count", n_max=4.1),
        ),
        sim_time=10.0,
    )
    return Case("load_balance_stress_counts", deck,
                notes="sharded; REAL count contrast -> work skew")


def load_balance_bunching(nx: int = 512, ny: int = 512, ppc: int = 64) -> Case:
    """Dynamic-bunching stress: a drifting count-loaded blob sweeps across
    every shard boundary — the localized particle concentration (and with
    it the straggler) MOVES from chip to chip, the scenario static block
    placement cannot rebalance (the reference migrates tiles off hot ranks
    for exactly this, PIC_2D.cpp:398-412).  Run sharded and watch
    RunHistory.live_skew: block placement holds max/mean ~ n_shards x
    blob concentration; striped placement holds ~1."""

    def blob(x, y):
        r2 = ((x - 12.8) ** 2 + (y - 25.6) ** 2) / (8.0**2)
        return 0.05 + 4.0 * jnp.exp(-r2)

    deck = Deck(
        # Count-mode (uniform weights, declared n_max = blob peak
        # 0.05 + 4.0).  See load_balance_stress_counts.
        box_x=51.2, box_y=51.2, nx=nx, ny=ny, tile_nx=8, tile_ny=8, guard=4,
        kchunk=KCHUNK,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, ux=0.5,
                        uth=0.02, density=blob, load_mode="count",
                        n_max=4.05),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc, ux=0.5,
                        uth=0.02, density=blob, load_mode="count",
                        n_max=4.05),
        ),
        sim_time=120.0,
    )
    return Case("load_balance_bunching", deck,
                notes="sharded; drifting bunch crosses every shard")


def laser_wakefield_window(nx: int = 512, ny: int = 256, ppc: int = 4) -> Case:
    """Moving-window laser wakefield: the laser_plasma scenario in a frame
    that follows the pulse at c (deck.moving_window), so the interaction
    can run for arbitrary propagation distances on a fixed grid.  Fresh
    plasma enters at the leading edge at its ABSOLUTE density-profile
    position (a long upramp into a uniform underdense slab); depleted
    plasma outflows behind.  Beyond the reference's scope — the staging
    capability its laser test case points toward."""
    box_x, box_y = 51.2, 25.6

    def profile(x, y):
        # upramp between x = 30 and 50 (absolute/lab coords), then a flat
        # n = 0.3 plateau: lambda_p = 2 pi/sqrt(0.3) ~ 11.5 c/wp, so the
        # length-4 pulse sits near half-plasma-wavelength resonance and
        # drives a visible wake (scripts/wakefield_artifact.py --fig).
        return 0.3 * 0.5 * (1.0 + jnp.tanh((x - 40.0) / 4.0))

    deck = Deck(
        box_x=box_x, box_y=box_y, nx=nx, ny=ny, tile_nx=8, tile_ny=8,
        guard=4, kchunk=KCHUNK,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=ppc, uth=0.01,
                        density=profile, shape_order=2),
            SpeciesSpec("ion", charge=+1.0, mass=1836.0, ppc=ppc,
                        density=profile, shape_order=2),
        ),
        boundary="absorbing", absorb_width=16, moving_window=True,
        sim_time=200.0,
    )
    return Case(
        "laser_wakefield_window",
        deck,
        init_fields=lambda d: finit.gaussian_laser_x(
            # k0 = 5 -> 12.6 cells/laser wavelength at the native 512-cell
            # grid: comfortably resolved, so the pulse survives hundreds
            # of c/wp of windowed propagation (k0 = 10 dispersed within
            # one box length — FDTD at ~6 cells/wavelength).
            d.domain, a0=2.0, k0=5.0, x_center=40.0, length=4.0,
            waist=10.0, dtype=d.dtype
        ),
        notes="moving window follows the pulse at c; plasma streams through",
    )


CASES: Dict[str, Callable[..., Case]] = {
    "reference_pulse": reference_pulse,
    "headline": headline,
    "two_stream": two_stream,
    "weibel": weibel,
    "landau": landau,
    "laser_plasma": laser_plasma,
    "laser_wakefield_window": laser_wakefield_window,
    "load_balance_stress": load_balance_stress,
    "load_balance_stress_counts": load_balance_stress_counts,
    "load_balance_bunching": load_balance_bunching,
}


def make(name: str, **overrides) -> Case:
    if name not in CASES:
        raise KeyError(f"unknown deck '{name}'; available: {sorted(CASES)}")
    return CASES[name](**overrides)
