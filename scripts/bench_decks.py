"""Steps/sec for every BASELINE deck on one device, plus the
load_balance_stress census demonstration.

Writes docs/BENCH_DECKS.json (incrementally) and prints a markdown
table, with the device and card recorded.  Run on a GPU:
    PYTHONPATH=. python scripts/bench_decks.py [--steps 30]

The sharded correctness of load_balance_stress is covered by the
virtual-CPU tests, __graft_entry__.dryrun_multichip and
``chip_smoke.py --four-cards``; here the deck runs on one device at
~8e7 particles for the throughput/census numbers.
"""
import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def sync(state):
    return jax.block_until_ready(state)


def _bench_one(name, kw, args):
    from minipic_tpu.decks.standard import make
    from minipic_tpu.simulation import Simulation, build_step

    case = make(name, **kw)
    deck = case.deck
    fields = case.init_fields(deck) if case.init_fields else None
    sim = Simulation(deck, fields=fields)
    if case.seed_state:
        sim.state = case.seed_state(sim.state, deck)
    step = jax.jit(build_step(deck))
    state = sim.state
    sim.state = None

    def multi(s, n):
        def body(ss, _):
            s2, _d = step(ss)
            return s2, ()
        out, _ = jax.lax.scan(body, s, None, length=n)
        return out

    m = jax.jit(multi, static_argnums=1)
    state = m(state, args.steps)
    sync(state)  # warm + compile
    t0 = time.perf_counter()
    state = m(state, args.steps)
    sync(state)
    dt_step = (time.perf_counter() - t0) / args.steps
    n_parts = sum(int(p.alive_count()) for p in state.species)
    row = {
        "deck": name,
        "device_kind": jax.devices()[0].device_kind,
        "grid": f"{deck.nx}x{deck.ny}",
        "particles": n_parts,
        "ms_per_step": round(dt_step * 1e3, 2),
        "steps_per_s": round(1.0 / dt_step, 1),
        "pushes_per_s": round(n_parts / dt_step, 0),
    }

    if name == "load_balance_stress":
        from minipic_tpu.parallel.balance import census
        for i, p in enumerate(state.species):
            c = census(p)
            row[f"census_sp{i}"] = {
                "max_tile": c.max_tile, "mean_tile": c.mean_tile,
                "capacity": c.capacity, "occupancy": c.occupancy,
                "imbalance": c.imbalance,
            }
        # Per-chip work is slot-uniform by construction; report the
        # *weight* (density) imbalance the reference's tile migration
        # existed to fix vs our slot imbalance.
        p = state.species[0]
        w_per_tile = np.asarray(jnp.sum(p.w, axis=1))
        n_per_tile = np.asarray(jnp.sum((p.w > 0).astype(jnp.int32), axis=1))
        row["weight_imbalance_max_over_mean"] = float(
            w_per_tile.max() / max(w_per_tile.mean(), 1e-30))
        row["slot_imbalance_max_over_mean"] = float(
            n_per_tile.max() / max(n_per_tile.mean(), 1e-30))
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--decks", default="two_stream,weibel,landau,laser_plasma,"
                    "load_balance_stress,reference_pulse,"
                    "laser_wakefield_window")
    ap.add_argument("--json-out", default="docs/BENCH_DECKS.json")
    args = ap.parse_args()

    from minipic_tpu.card import cards
    from minipic_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    rows = []
    for name in args.decks.split(","):
        kw = {}
        if name == "load_balance_stress":
            kw["n_particles"] = 4e7  # ~8e7 total over 2 species, 1-chip fit
        try:
            rows.append(_bench_one(name, kw, args))
        except Exception as e:
            rows.append({"deck": name, "error": str(e)[:300]})
            print(f"{name}: FAILED {str(e)[:300]}", flush=True)
        with open(args.json_out, "w") as f:
            json.dump({"steps_window": args.steps, "card": "; ".join(cards()),
                       "rows": rows}, f, indent=1)

    print("\n| deck | grid | particles | ms/step | steps/s | pushes/s |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        if "error" in r:
            print(f"| {r['deck']} | (failed: {r['error'][:60]}) | | | | |")
            continue
        print(f"| {r['deck']} | {r['grid']} | {r['particles']:.2e} | "
              f"{r['ms_per_step']} | {r['steps_per_s']} | {r['pushes_per_s']:.2e} |")


if __name__ == "__main__":
    main()
