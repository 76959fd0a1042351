"""On-device energy-conservation probe (BASELINE.md acceptance: <0.1% total
energy drift over 10k two-stream steps).

Runs the two_stream deck fully on-device (jit scan, one energy sample per
chunk) under a numerics configuration given on the command line, and
prints the drift history + the headline max drift.  ``{card}`` in
--json-out becomes the card's name and power limit (minipic_tpu.card.tag).

Usage:
  PYTHONPATH=. python scripts/energy_probe.py --steps 10000 \
      [--precision f32|f64] [--order 1|2] [--uth 0.05] [--ppc 16]
      [--nx 64] [--chunk 200] [--json-out docs/energy_{card}_10k_o2.json]
"""
import argparse
import json
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--chunk", type=int, default=200)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ppc", type=int, default=16)
    ap.add_argument("--uth", type=float, default=0.0)
    ap.add_argument("--order", type=int, default=1)
    ap.add_argument("--precision", default="f32")
    ap.add_argument("--u0", type=float, default=0.2)
    ap.add_argument("--dt-factor", type=float, default=None)
    ap.add_argument("--guard", type=int, default=None)
    ap.add_argument("--headroom", type=float, default=3.0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--platform", default=None,
                    help="force a jax backend, e.g. cpu")
    args = ap.parse_args()

    import jax

    from minipic_tpu.card import cards, tag
    from minipic_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.precision == "f64":
        jax.config.update("jax_enable_x64", True)
    # f32 runs keep x64 off (enabling it leaks i64 indices into the jitted
    # program and trips an XLA lowering bug); XLA's pairwise f32 reductions
    # carry ~1e-7 relative error, far below the 1e-3 acceptance threshold.

    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from minipic_tpu.decks.standard import two_stream
    from minipic_tpu.core.state import field_energy, kinetic_energy
    from minipic_tpu.simulation import Simulation, build_step

    case = two_stream(nx=args.nx, ny=args.nx, ppc=args.ppc, u0=args.u0)
    deck = case.deck
    # Warm only the beams: a thermal spread on the 1836x-mass ion background
    # would dominate E_total and mask electron-scale drift in the relative
    # measure.
    sp = tuple(
        dataclasses.replace(
            s, uth=(args.uth if s.mass <= 1.0 else 0.0), shape_order=args.order
        )
        for s in deck.species
    )
    over = dict(species=sp, precision=args.precision,
                capacity_headroom=args.headroom)
    if args.guard is not None:
        over["guard"] = args.guard
    if args.dt_factor is not None:
        over["dt_factor"] = args.dt_factor
    deck = dataclasses.replace(deck, **over)
    sim = Simulation(deck)
    if case.seed_state:
        sim.state = case.seed_state(sim.state, deck)
    masses = [s.mass for s in deck.species]

    step = build_step(deck)

    def energies(s):
        fe = field_energy(s.fields, deck.dx, deck.dy)
        ke = sum(kinetic_energy(p, m) for p, m in zip(s.species, masses))
        return jnp.float64(fe), jnp.float64(ke)

    def chunked(state, _):
        def body(s, ov):
            s2, d = step(s)
            return s2, ov + d.overflow

        state, ovs = jax.lax.scan(
            body, state, jnp.zeros((args.chunk,), jnp.int32), length=args.chunk
        )
        fe, ke = energies(state)
        return state, (fe, ke, ovs.sum())

    @jax.jit
    def run(state):
        return jax.lax.scan(chunked, state, None, length=args.steps // args.chunk)

    fe0, ke0 = (float(x) for x in energies(sim.state))
    t0 = time.time()
    state, (fes, kes, ovfs) = run(sim.state)
    total_overflow = int(np.asarray(ovfs).sum())
    tot = np.asarray(fes, np.float64) + np.asarray(kes, np.float64)
    wall = time.time() - t0

    tot0 = fe0 + ke0
    drift = np.abs(tot - tot0) / tot0
    steps_axis = (np.arange(len(tot)) + 1) * args.chunk
    stride = 1 if len(tot) <= 80 else len(tot) // 10
    for i in range(0, len(tot), stride):
        print(f"step {steps_axis[i]:6d}  E_tot={tot[i]:.8e}  drift={drift[i]:.3e}"
              f"  field_frac={float(fes[i] / tot[i]):.3e}")
    dev = jax.devices()[0]
    out = {
        "config": {k: v for k, v in vars(args).items() if k != "json_out"},
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "card": "; ".join(cards()),
        "E0": tot0,
        "max_drift": float(drift.max()),
        "max_drift_step": int(steps_axis[int(drift.argmax())]),
        "end_drift": float(drift[-1]),
        "field_frac_end": float(fes[-1] / tot[-1]),
        "wall_s": round(wall, 1),
        "overflow": total_overflow,
        "pass": bool(drift.max() < 1e-3),
    }
    print(json.dumps(out))
    if args.json_out:
        with open(args.json_out.format(card=tag()), "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
