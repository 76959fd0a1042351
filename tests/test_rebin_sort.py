"""Properties of the filler-key sort re-bin (particles/binning.py) for
every searchsorted method it accepts: the method changes speed, never
the result."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from minipic_tpu.core.geometry import Domain, Tiling
from minipic_tpu.core.state import ParticleState
from minipic_tpu.particles.binning import rebin, wrap_positions

METHODS = ["sort", "scan", "compare_all"]
NX = NY = 16
TILE = 4


def _tiling():
    return Tiling.for_domain(Domain(1.6, 1.6, NX, NY), TILE, TILE)


def _particles(x, y, cap, num_tiles):
    """Live particles (x, y) scattered over a [num_tiles, cap] pool with
    dead slots between them; momenta tag each particle by index."""
    n = len(x)
    slots = num_tiles * cap
    idx = np.random.default_rng(0).permutation(slots)[:n]
    def pool(v, fill=0.0):
        a = np.full(slots, fill, np.float32)
        a[idx] = v
        return jnp.asarray(a.reshape(num_tiles, cap))
    tag = np.arange(n, dtype=np.float32) + 1.0
    return ParticleState(pool(x), pool(y), pool(tag), pool(2 * tag),
                         pool(3 * tag), pool(np.ones(n, np.float32)))


def _random(n, cap, seed=1):
    rng = np.random.default_rng(seed)
    t = _tiling()
    return _particles(rng.uniform(0, NX, n), rng.uniform(0, NY, n), cap,
                      t.num_tiles)


@pytest.mark.parametrize("method", METHODS)
def test_rebin_keeps_every_live_particle_in_its_tile(method):
    t = _tiling()
    p = _random(300, 40)
    out, ovf = rebin(p, t, method=method)
    assert int(ovf) == 0
    w = np.asarray(out.w)
    tags = np.asarray(out.px)[w > 0]
    np.testing.assert_array_equal(np.sort(tags), np.arange(1, 301))
    np.testing.assert_array_equal(np.asarray(out.py)[w > 0], 2 * tags)
    # every live particle sits in the bucket of the tile it is in
    tid = np.broadcast_to(np.arange(t.num_tiles)[:, None], w.shape)
    col = np.floor(np.asarray(out.x) / TILE).astype(int)
    row = np.floor(np.asarray(out.y) / TILE).astype(int)
    np.testing.assert_array_equal((row * t.tile_cols + col)[w > 0], tid[w > 0])


@pytest.mark.parametrize("method", METHODS)
def test_rebin_buckets_are_live_compacted(method):
    out, _ = rebin(_random(300, 40), _tiling(), method=method)
    live = np.asarray(out.w) > 0
    counts = live.sum(axis=1)
    expect = np.arange(live.shape[1])[None, :] < counts[:, None]
    np.testing.assert_array_equal(live, expect)


@pytest.mark.parametrize("method", METHODS)
def test_rebin_counts_overflow(method):
    """A tile targeted by more particles than its capacity keeps
    `capacity` of them and counts the rest."""
    t = _tiling()
    cap = 10
    crowd = 25  # all in tile 0
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(0, TILE, crowd), rng.uniform(TILE, NX, 30)])
    y = np.concatenate([rng.uniform(0, TILE, crowd), rng.uniform(0, NY, 30)])
    out, ovf = rebin(_particles(x, y, cap, t.num_tiles), t, method=method)
    assert int(ovf) == crowd - cap
    live = np.asarray(out.w) > 0
    assert live[0].sum() == cap
    assert live.sum() == len(x) - (crowd - cap)


@pytest.mark.parametrize("method", METHODS)
def test_rebin_box_edge_positions(method):
    """Positions at and just inside the box edges — including f32 values
    that a periodic wrap rounds to exactly the box length — land in valid
    tiles and none is lost."""
    t = _tiling()
    below = np.nextafter(np.float32(0.0), np.float32(-1.0))
    x = np.array([0.0, NX - 1e-6, NX, below, NX * 0.5, 2 * NX - 1e-7],
                 np.float32)
    y = np.array([NY, 0.0, below, NY - 1e-6, NY, -NY], np.float32)
    p = wrap_positions(_particles(x, y, 8, t.num_tiles), NX, NY, True)
    assert float(jnp.max(p.x)) < NX and float(jnp.max(p.y)) < NY
    out, ovf = rebin(p, t, method=method)
    assert int(ovf) == 0
    assert int(jnp.sum(out.w > 0)) == len(x)
