"""Smoke test of the PIC engine on NVIDIA GPUs: the quickest proof that the
system still starts and computes correctly on the card.

    python chip_smoke.py               # one GPU: phases 1-4
    python chip_smoke.py --four-cards  # four GPUs: the sharded phase only

Everything runs in this one process (a second JAX process on the card
would fail for want of memory).  Phases of the one-card run:

  1. device     JAX must run on a GPU; prints the card, JAX, XLA_FLAGS and
                the compile-cache directory.
  2. headline   ``python -m minipic_tpu.cli --deck headline`` (1e8
                particles, 512^2, TSC) through ``cli.main``: live count
                conserved, no overflow, finite energies, |dE/E| < 1e-3,
                at least two re-bins; prints ms/step and peak memory.
  3. reference  two_stream for 20 steps on the GPU and on the CPU backend:
                energies within 1e-4 relative, fields within 1e-3 of the
                largest field magnitude (see phase_reference for why).
                Then the Gauss-law residual on the GPU in f32: its change
                over 25 steps stays <= 1e-5 max|rho|, which a TF32 product
                would break.
  4. advance    the Triton advance kernel against the XLA advance on the
                card, on one full headline bucket stack (and, printed only,
                both against an f64 advance on the CPU for 64 tiles).

``--four-cards`` runs only: load_balance_stress at its deck size through
ShardedSimulation (2x2 mesh) and BalancedSimulation (4 cards), 10 steps
each, against a one-card Simulation of the same deck and seed.

Any failed check exits non-zero.  The last line of a passing run is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    print(f"  {'ok  ' if cond else 'FAIL'} {what}", flush=True)
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    """Name and power limit of each card, as nvidia-smi reports them."""
    from minipic_tpu.card import cards

    return "card: " + ("; ".join(cards()) or "nvidia-smi unavailable")


def phase_device(cache_dir: str, count: int) -> None:
    import jax

    print(f"== phase 1: device", flush=True)
    print(f"  jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
          f"compile cache {cache_dir}", flush=True)
    devs = jax.devices()
    print(f"  devices: {devs}", flush=True)
    check(devs[0].platform == "gpu", f"JAX runs on a GPU (found {devs[0].platform})")
    check(len(devs) >= count, f"at least {count} GPU(s) (found {len(devs)})")
    print("  " + card_line(), flush=True)


def phase_headline(steps: int = 100):
    import jax
    import numpy as np

    from minipic_tpu import cli
    from minipic_tpu.decks.standard import make
    from minipic_tpu.simulation import Simulation

    print(f"== phase 2: headline deck through the CLI, {steps} steps", flush=True)
    deck = make("headline").deck
    out = os.path.join(HERE, ".smoke_out")
    shutil.rmtree(out, ignore_errors=True)
    try:
        rc = cli.main(["--deck", "headline", "--steps", str(steps), "--no-save",
                       "--diag-every", "1", "--out", out])
        check(rc == 0, "cli.main returned 0")
        with open(os.path.join(out, "history.json")) as f:
            hist = json.load(f)
        z = np.load(os.path.join(out, "checkpoint.npz"))
        live = int(np.count_nonzero(z["sp0_w"] > 0))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    n0 = sum(s.ppc for s in deck.species) * deck.nx * deck.ny
    check(live == n0, f"live particles conserved: {live} == {n0}")
    check(max(hist["overflow"]) == 0, "overflow 0 on every step")
    tot = [fe + sum(k) for fe, k in zip(hist["field_energy"], hist["kinetic_energy"])]
    check(bool(np.all(np.isfinite(tot))), "energies finite")
    drift = max(abs(t - tot[0]) for t in tot) / abs(tot[0])
    check(drift < 1e-3, f"|dE/E| = {drift:.3e} < 1e-3")
    n_rebin = sum(hist["rebinned"])
    check(n_rebin >= 2, f"{n_rebin} re-bins fired (>= 2)")
    wall = hist["wall"]
    k0 = 10  # skip the compile and warm-up steps
    ms = (wall[-1] - wall[k0]) / (len(wall) - 1 - k0) * 1e3
    print(f"  {ms:.2f} ms/step over steps {k0 + 2}..{steps} (one host sync per "
          f"step; informational) on {card_line()[6:]}", flush=True)
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    print(f"  peak_bytes_in_use {peak} ({peak / 2**30:.2f} GiB)", flush=True)
    sim = Simulation(deck)
    ma = sim._step.lower(sim.state).compile().memory_analysis()
    print(f"  step memory_analysis: {ma}", flush=True)


def _fields_close(a, b, rtol: float, label: str) -> None:
    """Each component of FieldState `a` within `rtol` of the largest
    magnitude of any component of `b`.  One scale for all six: components
    that vanish in exact arithmetic (Ey, Bz of a 1-D two-stream run) hold
    only round-off, which has no scale of its own."""
    import numpy as np

    scale = max(max(float(np.abs(np.asarray(c)).max()) for c in b), 1e-30)
    for name in a._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        err = float(np.abs(x - y).max()) / scale
        check(err <= rtol, f"{label} {name}: max|diff| = {err:.2e} of max|field|"
                           f" <= {rtol:g}")


def phase_reference():
    import jax
    import numpy as np

    from minipic_tpu.core.config import Deck, SpeciesSpec
    from minipic_tpu.decks.standard import make
    from minipic_tpu.diag.device import gauss_residual
    from minipic_tpu.simulation import Simulation

    print("== phase 3: GPU against the CPU reference", flush=True)
    # Both runs are f32 with sums in different orders.  two_stream's Ex is
    # the residue of two opposed beam currents that cancel to ~1/200, so
    # ~1e-6 relative differences in each beam's current reach ~1e-4 of
    # max|Ex| in 20 steps: measured on an H100, the XLA path on the GPU
    # differs from the same path on the CPU by 9.8e-5, the Triton path by
    # 1.6e-4.  Energies do not cancel and keep 1e-4.
    case = make("two_stream")
    deck = case.deck
    runs = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev):
            sim = Simulation(deck, seed=0)
            sim.state = case.seed_state(sim.state, deck)
            diag = sim.step(20)
            runs.append((jax.device_get(sim.state.fields),
                         float(diag.field_energy),
                         np.asarray(diag.kinetic_energy)))
    (fg, eg, kg), (fc, ec, kc) = runs
    _fields_close(fg, fc, 1e-3, "two_stream GPU vs CPU")
    check(abs(eg - ec) <= 1e-4 * abs(ec),
          f"field energy {eg:.6e} vs {ec:.6e} within 1e-4")
    kerr = float(np.max(np.abs(kg - kc) / np.abs(kc)))
    check(kerr <= 1e-4, f"per-species kinetic energy within {kerr:.2e} <= 1e-4")

    gdeck = Deck(
        box_x=8.0, box_y=8.0, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=3,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=4, ux=0.3, uy=0.15, uth=0.05),
            SpeciesSpec("ion", charge=+1.0, mass=10.0, ppc=4, ux=-0.1, uth=0.02),
        ),
        precision="f32",
    )
    sim = Simulation(gdeck, seed=6)
    r0 = np.asarray(gauss_residual(sim.state, gdeck)[0])
    sim.step(25)
    r1, rho = (np.asarray(a) for a in gauss_residual(sim.state, gdeck))
    change = float(np.abs(r1 - r0).max()) / float(np.abs(rho).max())
    check(change <= 1e-5, f"Gauss residual change over 25 f32 steps "
                          f"{change:.2e} of max|rho| <= 1e-5")


def phase_advance():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from minipic_tpu.decks.standard import make
    from minipic_tpu.fields import init as finit
    from minipic_tpu.fields.halo import pad_fields_periodic
    from minipic_tpu.fields.tiles import extract_field_tiles
    from minipic_tpu.ops.pallas.advance import advance_tiles
    from minipic_tpu.simulation import (Simulation, _tile_origins,
                                        advance_species_tiles)

    print("== phase 4: Triton advance kernel against the XLA advance", flush=True)
    deck = make("headline").deck
    t = deck.tiling
    sim = Simulation(deck, fields=finit.oblique_wave(deck.domain, amplitude=0.05))
    p = sim.state.species[0]
    ft = extract_field_tiles(pad_fields_periodic(sim.state.fields, deck.guard),
                             t.tile_rows, t.tile_cols, t.tile_ny, t.tile_nx, deck.guard)
    del sim
    print(f"  bucket stack {p.x.shape}", flush=True)
    kw = dict(qm=-1.0, q=-1.0, order=2, tile_ny=t.tile_ny, tile_nx=t.tile_nx,
              g=deck.guard, dt=deck.dt, dx=deck.dx, dy=deck.dy,
              grid=(deck.nx, deck.ny))
    origins = _tile_origins(t, jnp.float32)
    xla = jax.jit(lambda p, ft: advance_species_tiles(
        p, ft, origins=origins, kchunk=deck.kchunk, return_disp=True, **kw))
    tri = jax.jit(lambda p, ft: advance_tiles(p, ft, origins, **kw))

    def timed(f):
        out = jax.block_until_ready(f(p, ft))
        t0 = time.perf_counter()
        for _ in range(5):
            out = f(p, ft)
        jax.block_until_ready(out)
        return out, (time.perf_counter() - t0) / 5 * 1e3

    (px, jx, dx_), ms_x = timed(xla)
    (pk, jk, dk), ms_k = timed(tri)
    print(f"  advance of 1 species: XLA {ms_x:.2f} ms, Triton kernel {ms_k:.2f} ms "
          f"(informational) on {card_line()[6:]}", flush=True)
    # A tile's J window sums ~27k particle terms whose thermal currents
    # cancel; one-ulp differences in the shape values between the two
    # compilers leave ~3e-5 of max|J| (measured on an H100).  Momenta do
    # not cancel and keep 1e-6.
    for name, a, b in zip(("jx", "jy", "jz"), jk, jx):
        err = float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
        check(err <= 1e-4, f"{name}: max|diff| = {err:.2e} of max|J| <= 1e-4")
    for name in ("px", "py", "pz"):
        a, b = getattr(pk, name), getattr(px, name)
        err = float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))
        check(err <= 1e-6, f"{name}: max|diff| = {err:.2e} of max|{name}| <= 1e-6")
    # The kernel computes 1/gamma by division, XLA by rsqrt: one ulp.
    derr = abs(float(dk) - float(dx_)) / float(dx_)
    check(derr <= 1e-6, f"step displacement {float(dk):.6f} vs {float(dx_):.6f}"
                        f" within {derr:.1e} <= 1e-6")
    # Informational: both f32 paths against an f64 advance.  Positions are
    # stored as f32 global cell coordinates (one ulp is 6e-5 cells at
    # x ~ 512, against ~0.02-cell steps), so the f64 end points differ and
    # both paths sit ~5e-4 of max|Jx| from it alike: that measures the
    # state's precision, not either advance.
    for name, ek, ex in _f64_errors(p, ft, origins, kw, deck.kchunk, jk, jx):
        print(f"  {name} against an f64 advance on 64 tiles: kernel {ek:.2e}, "
              f"XLA {ex:.2e} of max|J| (informational)", flush=True)


def _f64_errors(p, ft, origins, kw, kchunk, jk, jx, n_tiles: int = 64):
    """[(name, kernel error, XLA error)]: both f32 advances' J against an
    f64 XLA advance on the CPU, on the first `n_tiles` tiles, as
    fractions of max|J|."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from minipic_tpu.simulation import advance_species_tiles

    def sub(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a[:n_tiles]), tree)

    ps, fs, os_, jks, jxs = (sub(a) for a in (p, ft, origins, jk, jx))
    jax.config.update("jax_enable_x64", True)
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            c64 = lambda tr: jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), tr)
            _, jr = advance_species_tiles(c64(ps), c64(fs), origins=c64(os_),
                                          kchunk=kchunk, **kw)
        out = []
        for name, a, b, r in zip(("jx", "jy", "jz"), jks, jxs, jr):
            r = np.asarray(r)
            s = np.abs(r).max()
            out.append((name, float(np.abs(a - r).max() / s),
                        float(np.abs(b - r).max() / s)))
        return out
    finally:
        jax.config.update("jax_enable_x64", False)


def phase_four_cards():
    import jax
    import numpy as np

    from minipic_tpu.decks.standard import make
    from minipic_tpu.parallel.balanced import BalancedSimulation
    from minipic_tpu.parallel.step import ShardedSimulation
    from minipic_tpu.simulation import Simulation

    print("== phase: four cards, load_balance_stress", flush=True)
    case = make("load_balance_stress")
    deck = case.deck
    steps = 10
    devs = jax.devices()[:4]

    def run(make_sim, label):
        t0 = time.perf_counter()
        sim = make_sim()
        diag = sim.step(steps)
        fields = jax.device_get(sim.state.fields)
        fe = float(diag.field_energy)
        print(f"  {label}: {time.perf_counter() - t0:.1f} s incl. setup and "
              f"compile; field energy {fe:.8e}", flush=True)
        check(int(diag.overflow) == 0, f"{label}: overflow 0")
        return fields, fe

    ref_f, ref_e = run(lambda: Simulation(deck, seed=0), "one card")
    for label, make_sim in (
        ("sharded 2x2", lambda: ShardedSimulation(deck, seed=0, devices=devs)),
        ("balanced x4", lambda: BalancedSimulation(deck, seed=0, devices=devs)),
    ):
        f, e = run(make_sim, label)
        check(abs(e - ref_e) <= 1e-5 * abs(ref_e),
              f"{label}: field energy {e:.8e} within 1e-5 of {ref_e:.8e}")
        _fields_close(f, ref_f, 1e-4, label)


def phases(four_cards: bool):
    """The phases a run executes, in order, after the device check."""
    if four_cards:
        return [phase_four_cards]
    return [phase_headline, phase_reference, phase_advance]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the four-card sharded phase and nothing else")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    try:
        sys.path.insert(0, HERE)
        try:
            from minipic_tpu.compile_cache import enable_compile_cache
        except ImportError as e:
            raise SmokeFailure(f"the minipic_tpu package is not beside "
                               f"chip_smoke.py ({e})")
        cache_dir = enable_compile_cache()
        phase_device(cache_dir, count)
        for phase in phases(args.four_cards):
            phase()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", flush=True)
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    import jax

    d = jax.devices()[0]
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
