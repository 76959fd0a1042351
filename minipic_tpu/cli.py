"""Command-line runner.

The reference has no CLI — configuration is edit-and-recompile
(PIC_2D.cpp:57-74) and execution is `mpirun -np N PIC_2D.o`
(Books/commands.txt).  Here:

    python -m minipic_tpu.cli --deck reference_pulse --out Simulation/Fields
    python -m minipic_tpu.cli --deck two_stream --steps 500 --save-every 100
    python -m minipic_tpu.cli --deck load_balance_stress --sharded
    python -m minipic_tpu.cli plot all --folder Simulation/Fields

Writes reference-schema HDF5 snapshots + params.txt (readable by the
reference's File_reader.py), a history.json of per-step energies, and a
final checkpoint.  The ``plot`` subcommand renders the reference's four
post-processing artifact types from a run folder (diag/plots.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def wipe_run_artifacts(out: str) -> int:
    """Remove a previous run's artifacts from `out` (snapshots, params,
    history, checkpoint).  The reference deletes and recreates the whole
    Simulation/Fields/ folder at start (Auxiliar_functions.cpp:275-295,
    PIC_2D.cpp:150-164); we remove only the known artifact patterns so a
    mistyped --out can never destroy unrelated files.  Returns #removed."""
    import glob

    n = 0
    for pattern in ("fields_rank_*.h5", "params.txt", "history.json",
                    "checkpoint.npz", "particles_rank_*.h5"):
        for path in glob.glob(os.path.join(out, pattern)):
            try:
                os.remove(path)
                n += 1
            except OSError:
                pass
    return n


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    if argv and argv[0] == "plot":
        # post-processing subcommand (reference File_reader.py __main__ flow)
        from .diag.plots import cli_main as plot_main

        return plot_main(argv[1:])
    ap = argparse.ArgumentParser(prog="minipic_tpu", description=__doc__)
    ap.add_argument("--deck", default="reference_pulse", help="named deck (decks/standard.py)")
    ap.add_argument("--out", default="Simulation/Fields", help="output folder")
    ap.add_argument("--steps", type=int, default=None, help="override total steps")
    ap.add_argument("--save-every", type=int, default=None)
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--ny", type=int, default=None)
    ap.add_argument("--sharded", action="store_true", help="run on all devices via the 2-D mesh")
    ap.add_argument(
        "--balanced", action="store_true",
        help="run on all devices with STRIPED tile placement "
        "(parallel/balanced.py) — load-balanced by construction; use for "
        "decks whose particles concentrate (blobs, wakefields, bunching)",
    )
    ap.add_argument("--ranks", type=int, default=1, help="fan snapshot files over N virtual ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--diag-every", type=int, default=1,
        help="record energies every N steps (each record syncs the device; "
        "N>1 removes the per-step host round-trip on small problems)",
    )
    ap.add_argument("--precision", choices=["f32", "f64"], default=None)
    ap.add_argument("--list", action="store_true", help="list available decks")
    ap.add_argument("--no-save", action="store_true", help="skip HDF5 snapshots")
    ap.add_argument(
        "--save-particles", action="store_true",
        help="also snapshot particles (live-compacted x/y/p/w per species) "
        "on the save cadence — restartable via io.checkpoint.particles_from_snapshot",
    )
    ap.add_argument(
        "--resume", nargs="?", const="auto", default=None, metavar="CKPT",
        help="resume from a checkpoint.npz (default: <out>/checkpoint.npz). "
        "Restores fields, particles, and the step counter bit-exact and "
        "continues to --steps/total_steps.  The run mode (--sharded and "
        "mesh shape) must match the saving run: sharded checkpoints store "
        "buckets in shard-major order.  Implies --keep-existing.",
    )
    ap.add_argument(
        "--keep-existing", action="store_true",
        help="do NOT wipe stale run artifacts from --out first (the default "
        "mirrors the reference's delete-and-recreate folder lifecycle, "
        "Auxiliar_functions.cpp:275-295, so old snapshots never mix into a "
        "new run's available_steps)",
    )
    ap.add_argument(
        "--platform",
        default=None,
        help="force a jax backend (e.g. 'cpu')",
    )
    ap.add_argument(
        "--profile", metavar="DIR", default=None,
        help="write a jax.profiler trace of the first ~20 steps to DIR "
        "(TensorBoard/XProf format)",
    )
    args = ap.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    if args.precision == "f64":
        import jax

        jax.config.update("jax_enable_x64", True)

    from .decks.standard import CASES, make

    if args.list:
        for name in sorted(CASES):
            print(name)
        return 0

    kw = {}
    if args.nx:
        kw["nx"] = args.nx
    if args.ny:
        kw["ny"] = args.ny
    case = make(args.deck, **kw)
    deck = case.deck
    if args.precision:
        deck = dataclasses.replace(deck, precision=args.precision)

    from .diag.history import RunHistory
    from .io.hdf5 import save_fields
    from .io.params import write_params
    from .io.checkpoint import load_checkpoint, save_checkpoint

    fields = case.init_fields(deck) if case.init_fields else None

    if args.sharded and args.balanced:
        raise SystemExit("--sharded and --balanced are mutually exclusive")
    if args.sharded:
        from .parallel.step import ShardedSimulation

        sim = ShardedSimulation(deck, fields=fields, seed=args.seed)
    elif args.balanced:
        from .parallel.balanced import BalancedSimulation

        sim = BalancedSimulation(deck, fields=fields, seed=args.seed)
    else:
        from .simulation import Simulation

        sim = Simulation(deck, fields=fields, seed=args.seed)
    if case.seed_state:
        sim.state = case.seed_state(sim.state, deck)

    start_step = 0
    if args.resume is not None:
        ckpt = (
            os.path.join(args.out, "checkpoint.npz")
            if args.resume == "auto" else args.resume
        )
        loaded = load_checkpoint(ckpt, deck)
        if len(loaded.species) != len(deck.species):
            raise SystemExit(
                f"--resume: checkpoint has {len(loaded.species)} species, "
                f"deck has {len(deck.species)}"
            )
        if args.sharded or args.balanced:
            # Restore the saved layout onto the mesh (shard-major bucket
            # order for --sharded, striped storage order for --balanced —
            # either way the run mode and device count must match the
            # saving run, as documented on --resume).
            import jax
            from jax.sharding import NamedSharding, PartitionSpec

            from .core.state import FieldState, ParticleState, SimState

            if args.balanced:
                from .parallel.balanced import BAXIS

                fsh = NamedSharding(sim.mesh, PartitionSpec())
                psh = NamedSharding(sim.mesh, PartitionSpec(BAXIS, None))
            else:
                from .parallel.mesh import field_spec, particle_spec

                fsh = NamedSharding(sim.mesh, field_spec())
                psh = NamedSharding(sim.mesh, particle_spec())
            loaded = SimState(
                fields=FieldState(*(jax.device_put(c, fsh) for c in loaded.fields)),
                species=tuple(
                    ParticleState(*(jax.device_put(a, psh) for a in sp))
                    for sp in loaded.species
                ),
                step=loaded.step,
                drift=loaded.drift,
                # window_x0 rides replicated like step/drift — dropping it
                # here made a sharded moving-window resume raise
                # "window_x0 is unset" on the first step.
                window_x0=loaded.window_x0,
            )
        sim.state = loaded
        start_step = int(loaded.step)
        print(f"resumed from {ckpt} at step {start_step}", flush=True)

    n_steps = args.steps if args.steps is not None else deck.total_steps
    save_every = args.save_every if args.save_every is not None else deck.save_frequency
    os.makedirs(args.out, exist_ok=True)
    if not args.keep_existing and args.resume is None:
        wipe_run_artifacts(args.out)
    write_params(deck, args.out)
    hist = RunHistory()

    # Prefer the native async writer (C++ thread pool overlaps HDF5
    # serialization with device compute); identical file schema either way.
    writer = None
    if not args.no_save:
        try:
            from .io.native import AsyncSnapshotWriter, available

            if available():
                writer = AsyncSnapshotWriter(deck.tiling, deck.guard, args.out, ranks=args.ranks)
        except Exception:
            writer = None

    species_names = [s.name for s in deck.species]

    window_log = {}
    if args.resume is not None:
        # Resume implies keep-existing: pre-resume snapshots stay in --out,
        # so their lab-frame offsets must survive into the rewritten ledger.
        prev_ledger = os.path.join(args.out, "window_offsets.json")
        if os.path.exists(prev_ledger):
            with open(prev_ledger) as f:
                window_log.update(
                    {int(k): int(v)
                     for k, v in json.load(f)["offsets_cells"].items()}
                )

    def save(step):
        if args.no_save:
            return
        if getattr(sim.state, "window_x0", None) is not None:
            # Lab-frame placement of window-frame snapshots: snapshot
            # files keep the reference schema (window coordinates);
            # the offset ledger lets post-processing reconstruct
            # lab x = window x + offset*dx.
            window_log[int(step)] = int(sim.state.window_x0)
        if writer is not None:
            writer.submit(sim.state.fields, step)
        else:
            save_fields(sim.state.fields, deck.tiling, deck.guard, step, args.out, ranks=args.ranks)
        if args.save_particles and species_names:
            if writer is not None:
                writer.submit_particles(sim.state.species, species_names, step)
            else:
                from .io.hdf5 import save_particles

                save_particles(sim.state.species, species_names, step, args.out)

    if start_step == 0:
        save(0)
    print(f"deck={args.deck} grid={deck.ny}x{deck.nx} dt={deck.dt:.6g} steps={n_steps}", flush=True)
    prof_until = 0
    prof_active = False
    if args.profile:
        import jax

        prof_until = min(start_step + 20, n_steps)
        if prof_until > start_step:
            jax.profiler.start_trace(args.profile)
            prof_active = True
    ovf_acc = 0  # device-side running sum — no per-step host sync
    try:
        for i in range(start_step + 1, n_steps + 1):
            diag = sim.step()
            # Accumulate overflow EVERY step (an async device add, not a
            # sync): with --diag-every N, drops on the other N-1 steps
            # must still reach ensure_capacity, or growth lags repeated
            # drops by many steps.
            ovf_acc = ovf_acc + diag.overflow
            if i == prof_until and prof_active:
                import jax

                jax.profiler.stop_trace()
                prof_active = False
                print(f"profiler trace (steps ..{i}) written to {args.profile}", flush=True)
            # Adaptive capacity (grow on overflow, shrink after calm) and
            # history both materialize device scalars — keep them on the
            # diag cadence so the hot loop stays async-dispatch only.
            # Save steps join the cadence: the save-print below reads the
            # last history row, which must exist even when save_every is
            # not a multiple of diag_every (saving already syncs anyway).
            on_cadence = (
                i % args.diag_every == 0 or i == n_steps
                or i % save_every == 0
            )
            if on_cadence:
                hist.record(i, deck.dt, diag)
                ovf = int(ovf_acc)
                if hasattr(sim, "ensure_capacity") and (ovf > 0 or i % 50 < args.diag_every):
                    sim.ensure_capacity(ovf)
                    ovf_acc = 0
            if i % save_every == 0:
                save(i)
                sps = hist.steps_per_sec()
                print(
                    f"step {i}/{n_steps}  E_field={hist.field_energy[-1]:.4e}  "
                    f"E_total={hist.total_energy()[-1]:.6e}  drift={hist.energy_drift():.2e}  "
                    f"ovf={hist.overflow[-1]}  {sps and f'{sps:.1f} steps/s' or ''}",
                    flush=True,
                )
    finally:
        if prof_active:
            import jax

            jax.profiler.stop_trace()

    if writer is not None:
        errs = writer.flush()
        if errs:
            print(f"WARNING: {errs} snapshot files failed to write", flush=True)
    hist.save(os.path.join(args.out, "history.json"))
    if window_log:
        import json as _json

        with open(os.path.join(args.out, "window_offsets.json"), "w") as f:
            _json.dump({"cells_per_unit": 1.0 / deck.dx,
                        "offsets_cells": window_log}, f, indent=1)
    save_checkpoint(os.path.join(args.out, "checkpoint.npz"), sim.state)
    print(f"done: energy drift {hist.energy_drift():.3e}; outputs in {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
