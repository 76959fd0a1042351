"""Reference-parity validation run, at the reference's FULL span.

Reproduces the reference's canonical configuration (box 10x10, nx=ny=450,
dt = 0.5 dt_CFL, cos^2 pulse — PIC_2D.cpp:57-74,130,140) for the full
t = 500/wp (63,639 steps, Simulation/Fields/params.txt:10) and regenerates
its report's §4 diagnostics:

* pulse propagation speed from the leading-peak linear fit
  (report Fig. 10: measured 0.99977 c, theory Eq. 4: 0.99982 c)
* first/second peak amplitude drift over the full span
  (report Fig. 8 at nx=450: ~0.076 -> ~0.084 / ~0.076 -> ~0.068;
   Fig. 9 at nx=720: -> ~0.079 / -> ~0.073)

The whole run is ONE device program: an outer lax.scan over samples, each
iteration scanning `sample_every` Yee steps and emitting the mid-y Bz
lineout — no host round-trips until the stacked [n_samples, nx] lineout
array returns.  ``{card}`` in --npz/--json becomes the card's name and
power limit (minipic_tpu.card.tag).

Usage:
  PYTHONPATH=. python scripts/validate_reference.py            # nx=450, full span
  PYTHONPATH=. python scripts/validate_reference.py --nx 720
  ... --npz docs/validation_{card}_450.npz --json docs/validation_{card}_450.json
"""
import argparse
import json
import math
import os
import sys
import time

import numpy as np


def run_lineout_history(deck, fields, n_steps: int, sample_every: int):
    """(times [S], lineouts [S, nx]) from one jitted scan-of-scans."""
    import jax
    import jax.numpy as jnp

    from minipic_tpu.simulation import build_step
    from minipic_tpu.core.state import SimState

    step = build_step(deck)
    n_samples = n_steps // sample_every
    mid = deck.ny // 2

    def sample(state, _):
        def inner(s, _):
            s2, _diag = step(s)
            return s2, ()

        state, _ = jax.lax.scan(inner, state, None, length=sample_every)
        return state, state.fields.bz[mid, :]

    @jax.jit
    def run(state):
        return jax.lax.scan(sample, state, None, length=n_samples)

    state0 = SimState(fields=fields, species=(), step=jnp.zeros((), jnp.int32))
    _, lines = run(state0)
    lines = np.asarray(lines)
    times = (np.arange(1, n_samples + 1) * sample_every) * deck.dt
    return times, lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=450)
    ap.add_argument("--steps", type=int, default=None,
                    help="default: the deck's full total_steps (t=500/wp)")
    ap.add_argument("--sample-every", type=int, default=None,
                    help="default: ~260 samples over the span")
    ap.add_argument("--precision", default="f32")
    ap.add_argument("--npz", default=None, help="save raw lineout history")
    ap.add_argument("--json", default=None, help="save summary metrics")
    args = ap.parse_args()

    import dataclasses

    import jax

    from minipic_tpu.card import cards, tag
    from minipic_tpu.compile_cache import enable_compile_cache
    from minipic_tpu.decks.standard import reference_pulse
    from minipic_tpu.diag.analysis import (
        fdtd_dispersion_velocity,
        peak_amplitudes,
        track_peak_speed,
    )

    enable_compile_cache()
    case = reference_pulse(nx=args.nx, ny=args.nx)
    deck = case.deck
    if args.precision != deck.precision:
        deck = dataclasses.replace(deck, precision=args.precision)
        if args.precision == "f64":
            jax.config.update("jax_enable_x64", True)
    fields = case.init_fields(deck)

    n_steps = args.steps or deck.total_steps
    sample_every = args.sample_every or max(1, n_steps // 260)

    t0 = time.time()
    times, lines = run_lineout_history(deck, fields, n_steps, sample_every)
    wall = time.time() - t0

    p1_hist, p2_hist = [], []
    for line in lines:
        p1, p2 = peak_amplitudes(line, distance=10)
        p1_hist.append(p1)
        p2_hist.append(p2)

    # Speed fit over the first ~3 box transits (the report fits early-time
    # positions, Fig. 10; at full span the periodic unwrap across ~50
    # transits adds no information and more hop risk).
    n_fit = max(8, int(3.0 * deck.box_x / deck.dt / sample_every))
    speed = track_peak_speed(times[:n_fit], lines[:n_fit], deck.dx, distance=10)
    k = 5 * 2 * math.pi / deck.box_x
    v_theory = fdtd_dispersion_velocity(k, deck.dt, deck.dx)

    summary = {
        "nx": args.nx,
        "steps": n_steps,
        "t_end": n_steps * deck.dt,
        "dt": deck.dt,
        "precision": args.precision,
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "card": "; ".join(cards()),
        "wall_s": round(wall, 2),
        "speed_c": round(speed, 6),
        "speed_theory_c": round(v_theory, 6),
        "peak1_t0": round(p1_hist[0], 5),
        "peak1_end": round(p1_hist[-1], 5),
        "peak2_t0": round(p2_hist[0], 5),
        "peak2_end": round(p2_hist[-1], 5),
    }
    print(json.dumps(summary, indent=1))

    if args.npz:
        args.npz = args.npz.format(card=tag())
        os.makedirs(os.path.dirname(args.npz) or ".", exist_ok=True)
        np.savez_compressed(
            args.npz, times=times, lines=lines.astype(np.float32),
            peak1=np.asarray(p1_hist), peak2=np.asarray(p2_hist),
            **{k: v for k, v in summary.items() if isinstance(v, (int, float))},
        )
    if args.json:
        args.json = args.json.format(card=tag())
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)

    ok = abs(speed - 0.99977) < 5e-4
    print("PASS" if ok else "FAIL", f"(|{speed:.5f} - 0.99977| < 5e-4)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
