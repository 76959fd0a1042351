"""Named decks + CLI smoke tests."""
import json
import os

import numpy as np
import pytest

from minipic_tpu.cli import main as cli_main
from minipic_tpu.decks.standard import CASES, make


def test_all_decks_validate():
    for name in CASES:
        case = make(name)
        case.deck.validate()
        assert case.deck.capacity() > 0


def test_cli_list(capsys):
    assert cli_main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in ("reference_pulse", "two_stream", "weibel", "landau",
                 "laser_plasma", "load_balance_stress"):
        assert name in out


def test_cli_reference_pulse_small(tmp_path):
    out = str(tmp_path / "Fields")
    rc = cli_main([
        "--deck", "reference_pulse", "--nx", "48", "--ny", "48",
        "--steps", "50", "--save-every", "25", "--out", out, "--ranks", "4",
    ])
    assert rc == 0
    files = sorted(os.listdir(out))
    assert "params.txt" in files and "history.json" in files and "checkpoint.npz" in files
    assert sum(f.startswith("fields_rank_") for f in files) == 3 * 4  # steps 0,25,50 x 4 ranks
    hist = json.loads(open(os.path.join(out, "history.json")).read())
    fe = np.asarray(hist["field_energy"])
    assert np.all(np.isfinite(fe)) and fe[0] > 0
    # vacuum propagation: energy conserved to f32 tolerance
    assert abs(fe[-1] - fe[0]) / fe[0] < 1e-4


def test_cli_two_stream_smoke(tmp_path):
    out = str(tmp_path / "ts")
    rc = cli_main([
        "--deck", "two_stream", "--steps", "20", "--save-every", "20",
        "--out", out, "--precision", "f64", "--no-save",
    ])
    assert rc == 0
    hist = json.loads(open(os.path.join(out, "history.json")).read())
    tot = [f + sum(k) for f, k in zip(hist["field_energy"], hist["kinetic_energy"])]
    assert abs(tot[-1] - tot[0]) / tot[0] < 1e-6


@pytest.mark.slow
def test_cli_sharded_stress_smoke(tmp_path):
    out = str(tmp_path / "lb")
    rc = cli_main([
        "--deck", "load_balance_stress", "--nx", "128", "--ny", "128",
        "--steps", "8", "--save-every", "8", "--sharded", "--out", out, "--no-save",
    ])
    assert rc == 0
    hist = json.loads(open(os.path.join(out, "history.json")).read())
    assert all(o == 0 for o in hist["overflow"])


@pytest.mark.slow
def test_cli_resume_bit_exact(tmp_path):
    """Kill-and-restart at the driver level: a run interrupted at step 10
    and resumed via --resume must land bit-exact on the uninterrupted run
    (the CLI half of the checkpoint/resume story)."""
    out_a = str(tmp_path / "full")
    out_b = str(tmp_path / "split")
    args = ["--deck", "two_stream", "--save-every", "50", "--precision",
            "f64", "--no-save"]
    assert cli_main(args + ["--steps", "20", "--out", out_a]) == 0
    assert cli_main(args + ["--steps", "10", "--out", out_b]) == 0
    assert cli_main(args + ["--steps", "20", "--out", out_b, "--resume"]) == 0

    from minipic_tpu.io.checkpoint import load_checkpoint

    a = load_checkpoint(os.path.join(out_a, "checkpoint.npz"))
    b = load_checkpoint(os.path.join(out_b, "checkpoint.npz"))
    assert int(a.step) == int(b.step) == 20
    for ca, cb in zip(a.fields, b.fields):
        np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))
    for sa, sb in zip(a.species, b.species):
        for name in ("x", "y", "px", "py", "pz", "w"):
            np.testing.assert_array_equal(
                np.asarray(getattr(sa, name)), np.asarray(getattr(sb, name)), err_msg=name
            )


@pytest.mark.slow
def test_cli_balanced_window_resume_bit_exact(tmp_path):
    """--balanced on a moving-window deck, interrupted and resumed: must
    land bit-exact on the uninterrupted balanced run (covers the striped
    driver in the CLI, the gid-rotation window under resume, and the
    window_x0 restore the round-3 advisor flagged for --sharded)."""
    out_a = str(tmp_path / "full")
    out_b = str(tmp_path / "split")
    args = ["--deck", "laser_wakefield_window", "--nx", "64", "--ny", "32",
            "--save-every", "50", "--precision", "f64", "--no-save",
            "--balanced"]
    assert cli_main(args + ["--steps", "30", "--out", out_a]) == 0
    assert cli_main(args + ["--steps", "15", "--out", out_b]) == 0
    assert cli_main(args + ["--steps", "30", "--out", out_b, "--resume"]) == 0

    from minipic_tpu.io.checkpoint import load_checkpoint

    a = load_checkpoint(os.path.join(out_a, "checkpoint.npz"))
    b = load_checkpoint(os.path.join(out_b, "checkpoint.npz"))
    assert int(a.step) == int(b.step) == 30
    assert int(a.window_x0) == int(b.window_x0) > 0
    for ca, cb in zip(a.fields, b.fields):
        np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))
    for sa, sb in zip(a.species, b.species):
        for name in ("x", "y", "px", "py", "pz", "w"):
            np.testing.assert_array_equal(
                np.asarray(getattr(sa, name)), np.asarray(getattr(sb, name)),
                err_msg=name,
            )


@pytest.mark.parametrize("name", sorted(CASES))
def test_deck_builds_four_device_mesh(name):
    """Every named deck, cut to 64^2, lays out on four devices: the mesh
    comes from the device count (no deck fixes its shape), and the tile
    grid divides over it."""
    import jax

    from minipic_tpu.parallel.mesh import local_tile_grid, make_mesh, shard_shape

    deck = make(name, nx=64, ny=64).deck
    assert deck.mesh_shape is None
    mesh = make_mesh(deck, jax.devices()[:4])
    assert mesh.devices.shape == (2, 2)
    ltr, ltc = local_tile_grid(deck, mesh)
    ny_l, nx_l = shard_shape(deck, mesh)
    assert (ltr * deck.tile_ny, ltc * deck.tile_nx) == (ny_l, nx_l) == (32, 32)


@pytest.mark.parametrize("kchunk,cap,expect", [
    (1024, 26823, 27648),  # the headline deck's buckets: whole chunks
    (1024, 1001, 1008),    # below one chunk: one chunk of its own size
    (1020, 1019, 1020),    # never past kchunk when rounding to 8
    (64, 65, 128),
])
def test_round_capacity_tiles_the_advance_scan(kchunk, cap, expect):
    import dataclasses

    deck = dataclasses.replace(make("two_stream").deck, kchunk=kchunk)
    got = deck.round_capacity(cap)
    assert got == expect
    assert got % min(kchunk, got) == 0
