"""Striped (balanced) placement correctness + the load-balance story.

Two claims under test (dynamic load balance):

1. Placement invariance: BalancedSimulation reproduces the single-device
   run exactly — same invariant as ShardedSimulation, different
   tile->chip map (the reference's migration-transparency check,
   Auxiliar_functions.cpp:242-272, restated for static striping).
2. Balance by construction: under a REAL count contrast (the blob loaded
   with load_mode='count'), the striped placement bounds per-shard live
   skew near 1, where the contiguous block placement is badly skewed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from minipic_tpu.core.config import Deck, SpeciesSpec
from minipic_tpu.parallel.balanced import (
    BalancedSimulation,
    balanced_permutation,
    shard_of_tile,
    stripe_gids,
)
from minipic_tpu.parallel.step import ShardedSimulation
from minipic_tpu.simulation import Simulation

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def _deck(**kw):
    base = dict(
        box_x=8.0,
        box_y=8.0,
        nx=64,
        ny=64,
        tile_nx=8,
        tile_ny=8,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=4, ux=0.3, uy=0.2, uth=0.05),
            SpeciesSpec("ion", charge=+1.0, mass=5.0, ppc=4, ux=-0.1, uth=0.02),
        ),
        precision="f64",
        rebin_interval=1,
    )
    base.update(kw)
    return Deck(**base)


def test_stripe_map_partitions_evenly():
    for tr, tc, s in ((8, 8, 8), (16, 16, 8), (8, 8, 4), (6, 10, 4)):
        shard = shard_of_tile(tr, tc, s)
        counts = np.bincount(shard, minlength=s)
        assert (counts == tr * tc // s).all()
        gids = stripe_gids(tr, tc, s)
        assert sorted(gids.reshape(-1).tolist()) == list(range(tr * tc))


@pytest.mark.parametrize("n_dev", [
    pytest.param(8, marks=pytest.mark.slow),
    4,  # the fast-gate representative of the equivalence family
])
def test_balanced_matches_single_device(n_dev):
    """Same deck, same seed: the striped run must reproduce the
    single-device run (fields to round-off; particles as multisets)."""
    deck = _deck()
    ref = Simulation(deck, seed=7)
    ba = BalancedSimulation(deck, seed=7, devices=jax.devices()[:n_dev])

    n_steps = 12
    dref = ref.step(n_steps)
    dba = ba.step(n_steps)

    assert int(dref.overflow) == 0 and int(dba.overflow) == 0
    for a, b in zip(ref.state.fields, ba.state.fields):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(
        float(dba.field_energy), float(dref.field_energy), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(dba.kinetic_energy), np.asarray(dref.kinetic_energy), rtol=1e-10
    )

    # Particle multisets per tile (storage row s*T_local+j holds gid
    # stripe[s, j]; scatter back to gid order before comparing).
    t = deck.tiling
    perm = balanced_permutation(t.num_tiles, n_dev, t.tile_rows, t.tile_cols)
    for pref, pba in zip(ref.state.species, ba.state.species):
        wa = np.asarray(pref.w) > 0
        wb = np.asarray(pba.w) > 0
        for name in ("x", "y", "px", "py", "pz", "w"):
            a = np.sort(np.where(wa, np.asarray(getattr(pref, name)), 0.0), axis=1)
            b = np.where(wb, np.asarray(getattr(pba, name)), 0.0)
            b_gid = np.empty_like(b)
            b_gid[perm] = b
            b_gid = np.sort(b_gid, axis=1)
            np.testing.assert_allclose(b_gid, a, rtol=1e-10, atol=1e-12, err_msg=name)


def test_balanced_beam_sweep_no_losses():
    """A fast beam crosses many stripe boundaries; count exactly conserved
    (every mover's destination is an arbitrary shard here, so this drives
    the all_gather routing path hard)."""
    deck = _deck(
        species=(SpeciesSpec("beam", charge=-1.0, mass=1e12, ppc=2, ux=0.9, uy=0.45),),
    )
    ba = BalancedSimulation(deck, seed=1)
    n0 = sum(int(s.alive_count()) for s in ba.state.species)
    for _ in range(4):
        d = ba.step(10)
        assert int(d.overflow) == 0
    n1 = sum(int(s.alive_count()) for s in ba.state.species)
    assert n0 == n1


def _blob_deck(load_mode):
    # 16x16 tiles: striping needs the feature to span several tiles per
    # stripe period; an 8x8 grid with a 1-tile blob core caps what ANY
    # placement can do (measured stripe skew 1.24 there vs 1.00 here).
    def blob(x, y):
        r2 = (x - 8.0) ** 2 + (y - 8.0) ** 2
        return 0.1 + 4.0 * np.exp(-r2 / (2.0 * 1.6**2))

    return _deck(
        box_x=16.0,
        box_y=16.0,
        nx=128,
        ny=128,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=8, uth=0.05,
                        density=blob, load_mode=load_mode),
        ),
        precision="f32",
    )


@pytest.mark.slow
def test_striped_placement_bounds_count_skew():
    """The measured load-balance claim: under a ~41x count-contrast blob,
    per-shard live counts (== per-chip work under the occupancy-bounded
    kernels) stay within a few percent of uniform for the striped
    placement, while the contiguous block placement is >1.5x skewed."""
    deck = _blob_deck("count")
    sh = ShardedSimulation(deck, seed=3, devices=jax.devices()[:8])
    ba = BalancedSimulation(deck, seed=3, devices=jax.devices()[:8])
    dsh = sh.step(2)
    dba = ba.step(2)

    def skew(d):
        live = np.asarray(d.shard_live, dtype=np.float64)
        assert live.shape == (8,) and live.sum() > 0
        return float(live.max() / live.mean())

    s_block, s_stripe = skew(dsh), skew(dba)
    # Block placement: the blob concentrates on the center shards.
    assert s_block > 1.5, s_block
    # Striped: balanced to per-tile granularity by construction.
    assert s_stripe < 1.10, s_stripe
    # Same physics either way.
    np.testing.assert_allclose(
        float(dba.field_energy), float(dsh.field_energy), rtol=1e-4
    )
