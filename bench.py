"""Headline throughput: particle pushes per second on one device.

Runs the ``headline`` deck (1e8 particles on 512^2, TSC shapes,
drift-triggered re-bin; decks/standard.py) for a window of steps inside
one jitted scan, and prints one JSON line naming the device it ran on.
A run that does not fit fails; nothing is retried at a smaller size.

    python bench.py          # BENCH_STEPS steps per window (default 100)
"""
import json
import os
import time

import jax


def main():
    from minipic_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    from minipic_tpu.card import cards
    from minipic_tpu.decks.standard import make
    from minipic_tpu.simulation import Simulation, build_step

    # ~3.7 drift-triggered re-bins per 100-step window, so the window's
    # share of re-bin cost varies little with where the window starts.
    inner = int(os.environ.get("BENCH_STEPS", 100))
    deck = make("headline").deck
    sim = Simulation(deck)
    step = build_step(deck)

    def multi(state, n):
        def body(s, _):
            return step(s)[0], ()

        return jax.lax.scan(body, state, None, length=n)[0]

    run = jax.jit(multi, static_argnums=1, donate_argnums=0)
    n_live = sum(int(s.alive_count()) for s in sim.state.species)
    state, sim.state = sim.state, None
    state = jax.block_until_ready(run(state, inner))  # compile + warm up
    t0 = time.perf_counter()
    state = jax.block_until_ready(run(state, inner))
    wall = time.perf_counter() - t0
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "particle-pushes/sec/device (%.4g particles, %dx%d grid, "
                  "TSC order-2)" % (n_live, deck.nx, deck.ny),
        "value": n_live * inner / wall,
        "unit": "pushes/s",
        "ms_per_step": wall / inner * 1e3,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": "; ".join(cards()),
    }))


if __name__ == "__main__":
    main()
