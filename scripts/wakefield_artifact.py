"""Moving-window wakefield artifact + timing (docs/wakefield_window.json).

Runs the `laser_wakefield_window` deck (the beyond-reference capability:
the reference's laser test case, PIC_2D.cpp:57-74 Test 3, on a frame that
follows the pulse at c) and records BOTH physics observables and the
window machinery's cost: ms/step split into base steps vs shift steps by
least squares over timed chunks (shift steps pay the injected column +
forced re-bin).

    python scripts/wakefield_artifact.py [--steps 1500] [--fig]

Writes docs/wakefield_window.json with the device and card recorded.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--fig", action="store_true")
    ap.add_argument("--json-out", default="docs/wakefield_window.json")
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--ny", type=int, default=None)
    ap.add_argument("--platform", default=None,
                    help="force a jax backend, e.g. 'cpu'")
    args = ap.parse_args()
    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from minipic_tpu.card import cards
    from minipic_tpu.compile_cache import enable_compile_cache
    from minipic_tpu.decks.standard import make
    from minipic_tpu.simulation import Simulation

    enable_compile_cache()

    kw = {}
    if args.nx:
        kw["nx"] = args.nx
    if args.ny:
        kw["ny"] = args.ny
    case = make("laser_wakefield_window", **kw)
    deck = case.deck
    sim = Simulation(deck, fields=case.init_fields(deck))

    def sync():
        return jax.block_until_ready(sim.state)

    # Warm up: run one chunk (compiles step; shift steps compile lazily on
    # the first shift, so include enough steps to hit one if possible).
    t_compile0 = time.perf_counter()
    for _ in range(args.chunk):
        diag = sim.step()
    retraced = sim.ensure_capacity(int(diag.overflow))
    seen_shift = int(sim.state.window_x0) > 0
    sync()
    compile_s = time.perf_counter() - t_compile0

    chunks = []  # (steps, n_shifts, wall_s, tainted)
    done = args.chunk
    t_all0 = time.perf_counter()
    while done < args.steps:
        n = min(args.chunk, args.steps - done)
        w0 = int(sim.state.window_x0)
        t0 = time.perf_counter()
        for _ in range(n):
            diag = sim.step()
        sync()
        dt_wall = time.perf_counter() - t0
        w1 = int(sim.state.window_x0)
        n_shifts = (w1 - w0) // deck.tiling.tile_nx
        # A chunk right after a capacity growth pays a full step retrace,
        # and the first chunk containing a shift pays the shift-step
        # compile: both are one-time compile costs, not per-step physics —
        # taint them out of the fit.
        tainted = retraced or (n_shifts > 0 and not seen_shift)
        seen_shift = seen_shift or n_shifts > 0
        chunks.append((n, n_shifts, dt_wall, tainted))
        retraced = sim.ensure_capacity(int(diag.overflow))
        done += n
    wall_run = time.perf_counter() - t_all0

    # Least-squares split over clean chunks: wall = base*steps + shift*shifts.
    clean = [c for c in chunks if not c[3]]
    A = np.array([[c[0], c[1]] for c in clean], dtype=np.float64)
    b = np.array([c[2] for c in clean]) * 1e3
    if len(clean) >= 2 and A[:, 1].max() > 0:
        (base_ms, shift_ms), *_ = np.linalg.lstsq(A, b, rcond=None)
    elif len(clean) >= 1:
        base_ms, shift_ms = (b.sum() / max(1, A[:, 0].sum()), float("nan"))
    else:
        base_ms, shift_ms = float("nan"), float("nan")
    retrace_wall_s = sum(c[2] for c in chunks if c[3])

    f = sim.state.fields
    ex = np.asarray(f.ex)
    live = sum(int(np.sum(np.asarray(p.w) > 0)) for p in sim.state.species)
    w0c = int(sim.state.window_x0)
    from minipic_tpu.core.state import field_energy

    out = {
        "platform": jax.devices()[0].platform,
        "device": str(jax.devices()[0]),
        "device_kind": jax.devices()[0].device_kind,
        "card": "; ".join(cards()),
        "steps": args.steps,
        "window_x0_cells": w0c,
        "propagation_distance": args.steps * deck.dt,
        "lab_distance": round(deck.box_x / deck.nx * w0c + 0, 2),
        "box_x": deck.box_x,
        "wall_s": round(wall_run, 1),
        "first_chunk_incl_compile_s": round(compile_s, 1),
        "ms_per_step_base": round(float(base_ms), 2),
        "ms_per_shift_step_extra": round(float(shift_ms), 2),
        "n_shift_steps": int(sum(c[1] for c in chunks)),
        "retrace_chunks": int(sum(1 for c in chunks if c[3])),
        "retrace_wall_s": round(retrace_wall_s, 1),
        "live": live,
        "ex_wake_max": float(np.abs(ex).max()),
        "field_energy": float(field_energy(f, deck.dx, deck.dy)),
    }
    print(json.dumps(out))
    with open(args.json_out, "w") as fh:
        json.dump(out, fh, indent=1)

    if args.fig:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axs = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
        dx = deck.box_x / deck.nx
        x = (np.arange(deck.nx) + w0c) * dx
        y = np.arange(deck.ny) * deck.box_y / deck.ny
        ez = np.asarray(f.ez)
        axs[0].imshow(ez, origin="lower", aspect="auto",
                      extent=[x[0], x[-1], y[0], y[-1]], cmap="RdBu")
        axs[0].set_ylabel("y [c/w0]")
        axs[0].set_title(f"Ez (laser) after {args.steps} steps, window at "
                         f"x0={w0c} cells [{out['platform']}]")
        axs[1].plot(x, ex[deck.ny // 2, :])
        axs[1].set_ylabel("Ex(y=mid) [wake]")
        axs[1].set_xlabel("lab x [c/w0]")
        fig.tight_layout()
        fig.savefig("docs/figs/wakefield_window.png", dpi=110)
        print("figure written to docs/figs/wakefield_window.png")


if __name__ == "__main__":
    main()
