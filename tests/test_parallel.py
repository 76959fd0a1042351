"""Multi-chip (shard_map) correctness on the 8-device virtual CPU mesh.

The decisive test is sharded == single-device on the same deck (the
reference's correctness story for migration was 'physics is placement-
independent'; here the same invariant is asserted across mesh layouts).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from minipic_tpu.core.config import Deck, SpeciesSpec
from minipic_tpu.parallel.halo import exchange_halo, fold_halo
from minipic_tpu.parallel.step import ShardedSimulation, shard_major_permutation
from minipic_tpu.simulation import Simulation

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


def _mesh(r, c):
    return Mesh(np.array(jax.devices()[: r * c]).reshape(r, c), ("ry", "rx"))


def test_halo_exchange_sentinels():
    """Every guard region must hold the (periodic) mesh neighbor's shard id
    — the reference's communication test (C15), asserted across chips."""
    r, c, g = 2, 4, 2
    mesh = _mesh(r, c)
    ny_l = nx_l = 8

    def local(x):
        ry = jax.lax.axis_index("ry")
        rx = jax.lax.axis_index("rx")
        sid = (ry * c + rx).astype(jnp.float64)
        block = jnp.full((ny_l, nx_l), sid)
        return exchange_halo(block, g, r, c)

    x = jnp.zeros((r * ny_l, c * nx_l))
    out = jax.jit(
        jax.shard_map(local, mesh=mesh, in_specs=P("ry", "rx"), out_specs=P("ry", "rx"))
    )(x)
    # out is the concatenation of per-shard padded blocks: [r*(ny_l+2g), ...]
    blocks = np.asarray(out).reshape(r, ny_l + 2 * g, c, nx_l + 2 * g).transpose(0, 2, 1, 3)
    sid = lambda rr, cc: (rr % r) * c + (cc % c)
    for rr in range(r):
        for cc in range(c):
            b = blocks[rr, cc]
            assert (b[g:-g, :g] == sid(rr, cc - 1)).all()
            assert (b[g:-g, -g:] == sid(rr, cc + 1)).all()
            assert (b[:g, g:-g] == sid(rr - 1, cc)).all()
            assert (b[-g:, g:-g] == sid(rr + 1, cc)).all()
            assert (b[:g, :g] == sid(rr - 1, cc - 1)).all()
            assert (b[:g, -g:] == sid(rr - 1, cc + 1)).all()
            assert (b[-g:, :g] == sid(rr + 1, cc - 1)).all()
            assert (b[-g:, -g:] == sid(rr + 1, cc + 1)).all()


def test_fold_halo_is_adjoint_of_exchange():
    r, c, g = 2, 4, 2
    mesh = _mesh(r, c)
    ny_l = nx_l = 8
    rng = np.random.default_rng(2)
    blocks = jnp.asarray(rng.standard_normal((r * ny_l, c * nx_l)))
    padded_rand = jnp.asarray(rng.standard_normal((r * (ny_l + 2 * g), c * (nx_l + 2 * g))))

    ex = jax.jit(
        jax.shard_map(
            lambda b: exchange_halo(b, g, r, c), mesh=mesh, in_specs=P("ry", "rx"), out_specs=P("ry", "rx")
        )
    )
    fo = jax.jit(
        jax.shard_map(
            lambda p: fold_halo(p, g, r, c), mesh=mesh, in_specs=P("ry", "rx"), out_specs=P("ry", "rx")
        )
    )
    lhs = float(jnp.vdot(ex(blocks), padded_rand))
    rhs = float(jnp.vdot(blocks, fo(padded_rand)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


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


@pytest.mark.parametrize("mesh_shape", [
    pytest.param((2, 4), marks=pytest.mark.slow),
    pytest.param((1, 8), marks=pytest.mark.slow),
    (2, 2),  # the fast-gate representative of the equivalence family
])
def test_sharded_matches_single_device(mesh_shape):
    """Same deck, same seed: the sharded run must reproduce the
    single-device run (fields to round-off; particles as multisets)."""
    deck = _deck(mesh_shape=mesh_shape)
    n_dev = mesh_shape[0] * mesh_shape[1]

    ref = Simulation(deck, seed=7)
    sh = ShardedSimulation(deck, seed=7, devices=jax.devices()[:n_dev])

    n_steps = 12
    dref = ref.step(n_steps)
    dsh = sh.step(n_steps)

    assert int(dref.overflow) == 0 and int(dsh.overflow) == 0
    for a, b in zip(ref.state.fields, sh.state.fields):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(
        float(dsh.field_energy), float(dref.field_energy), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(dsh.kinetic_energy), np.asarray(dref.kinetic_energy), rtol=1e-10
    )

    # Particle multisets per tile must agree (slot order is arbitrary, and
    # dead slots carry stale values — mask them out before comparing).
    perm = shard_major_permutation(deck, sh.mesh)
    for pref, psh in zip(ref.state.species, sh.state.species):
        wa = np.asarray(pref.w) > 0
        wb = np.asarray(psh.w) > 0
        for name in ("x", "y", "px", "py", "pz", "w"):
            a = np.sort(np.where(wa, np.asarray(getattr(pref, name)), 0.0), axis=1)
            b = np.where(wb, np.asarray(getattr(psh, name)), 0.0)
            b_gid = np.empty_like(b)
            b_gid[perm] = b  # shard-major -> gid order
            b_gid = np.sort(b_gid, axis=1)
            np.testing.assert_allclose(b_gid, a, rtol=1e-10, atol=1e-12, err_msg=name)


def test_cross_shard_migration_no_losses():
    """A fast beam sweeps across every shard boundary; particle count must
    be exactly conserved (the reference's migration-transparency check)."""
    deck = _deck(
        mesh_shape=(2, 4),
        species=(SpeciesSpec("beam", charge=-1.0, mass=1e12, ppc=2, ux=0.9, uy=0.45),),
    )
    sh = ShardedSimulation(deck, seed=1)
    n0 = sum(int(s.alive_count()) for s in sh.state.species)
    for _ in range(4):
        d = sh.step(10)
        assert int(d.overflow) == 0
    n1 = sum(int(s.alive_count()) for s in sh.state.species)
    assert n0 == n1


def test_exchange_kills_multi_hop_particles():
    """A live slot >1 shard-hop away (only possible via corrupted
    positions — Deck.validate bounds physical drift to one hop) must be
    zero-weighted AND counted as dropped, never shipped a clipped hop with
    live weight (parallel/exchange.py multi-hop guard)."""
    from minipic_tpu.core.state import ParticleState
    from minipic_tpu.parallel.exchange import exchange_particles

    r, c = 2, 4
    mesh = _mesh(r, c)
    nx = ny = 64
    nx_l, ny_l = nx // c, ny // r  # 16 x 32 blocks
    t_local, cap, xcap = 2, 8, 8

    def local(_):
        ry = jax.lax.axis_index("ry")
        rx = jax.lax.axis_index("rx")
        x0 = rx * nx_l
        y0 = ry * ny_l
        z = jnp.zeros((t_local, cap))
        fx = x0.astype(jnp.float64)
        # slot 0: stays; slot 1: one hop right; slot 2: TWO hops right.
        x = z.at[0, 0].set((fx + 5.0) % nx)
        x = x.at[0, 1].set((fx + nx_l + 5.0) % nx)
        x = x.at[0, 2].set((fx + 2 * nx_l + 5.0) % nx)
        y = z + (y0.astype(jnp.float64) + 3.0)
        w = z.at[0, 0:3].set(1.0)
        p = ParticleState(x, y, z, z, z, w)
        merged, dropped = exchange_particles(
            p, block_x0=x0, block_y0=y0, block_nx=nx_l, block_ny=ny_l,
            nx=nx, ny=ny, rows=r, cols=c, cap=xcap,
        )
        live = jnp.sum((merged.w > 0).astype(jnp.int32))
        # every live slot in merged must now belong to THIS block
        col_ok = jnp.floor_divide(merged.x.astype(jnp.int32), nx_l) == rx
        ok = jnp.sum((merged.w > 0) & ~col_ok)
        return (
            jax.lax.psum(dropped, ("ry", "rx")),
            jax.lax.psum(live, ("ry", "rx")),
            jax.lax.psum(ok, ("ry", "rx")),
        )

    dropped, live, misrouted = jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=P(("ry", "rx")), out_specs=(P(), P(), P()),
        )
    )(jnp.zeros(r * c))
    n_sh = r * c
    assert int(dropped) == n_sh  # the 2-hop slot, once per shard
    assert int(live) == 2 * n_sh  # stayer + the arrived 1-hop neighbor
    assert int(misrouted) == 0
