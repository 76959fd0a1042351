"""The Triton advance kernel (ops/pallas/advance.py) in interpret mode
against the XLA advance on the same data, and its charge continuity."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from minipic_tpu.core.config import Deck, SpeciesSpec
from minipic_tpu.fields import init as finit
from minipic_tpu.fields.halo import fold_block_periodic, pad_fields_periodic
from minipic_tpu.fields.tiles import extract_field_tiles, fold_tiles
from minipic_tpu.ops.pallas.advance import CHUNK, advance_tiles
from minipic_tpu.particles.deposit import deposit_rho_chunk
from minipic_tpu.particles.species import load_species
from minipic_tpu.simulation import (_tile_origins, advance_species_tiles,
                                    tile_local_coords)


def _fixture(order, guard, tile):
    n = 32
    deck = Deck(
        box_x=3.2, box_y=3.2, nx=n, ny=n, tile_nx=tile, tile_ny=tile,
        guard=guard,
        species=(SpeciesSpec("e", -1.0, 1.0, ppc=2, ux=0.2, uth=0.1,
                             shape_order=order),),
        precision="f32",
    )
    t = deck.tiling
    live = 2 * tile * tile
    cap = live + 72  # several kernel blocks, the last one partial
    p = load_species(deck.species[0], deck.domain, t, cap,
                     jax.random.PRNGKey(order + 10 * guard + tile),
                     jnp.float32)
    # Dead slots inside the live run too, not only at the bucket tail.
    p = p._replace(w=p.w.at[:, ::7].set(0.0))
    f = finit.oblique_wave(deck.domain, amplitude=0.3, dtype=jnp.float32)
    ft = extract_field_tiles(pad_fields_periodic(f, guard), t.tile_rows,
                             t.tile_cols, t.tile_ny, t.tile_nx, guard)
    kw = dict(qm=-1.0, q=-1.0, order=order, tile_ny=tile, tile_nx=tile,
              g=guard, dt=deck.dt, dx=deck.dx, dy=deck.dy, grid=(n, n))
    return deck, p, ft, kw


@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("guard", [2, 4])
@pytest.mark.parametrize("order", [1, 2])
def test_kernel_matches_xla_advance(order, guard, tile):
    deck, p, ft, kw = _fixture(order, guard, tile)
    assert p.capacity > CHUNK and p.capacity % CHUNK
    assert int(jnp.sum(p.w == 0)) > 0
    origins = _tile_origins(deck.tiling, jnp.float32)
    px, jx, dx_ = advance_species_tiles(p, ft, origins=origins,
                                        kchunk=p.capacity, return_disp=True,
                                        **kw)
    pk, jk, dk = advance_tiles(p, ft, origins, interpret=True, **kw)
    for name in ("x", "y", "px", "py", "pz", "w"):
        np.testing.assert_allclose(np.asarray(getattr(pk, name)),
                                   np.asarray(getattr(px, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for name, a, b in zip(("jx", "jy", "jz"), jk, jx):
        assert a.shape == b.shape
        scale = float(jnp.abs(b).max())
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
    assert float(dk) == pytest.approx(float(dx_), rel=1e-6)


def _global(deck, tiles):
    t, g = deck.tiling, deck.guard
    t4 = tiles.reshape(t.tile_rows, t.tile_cols, t.tile_ny + 2 * g,
                       t.tile_nx + 2 * g)
    return fold_block_periodic(fold_tiles(t4, t.tile_ny, t.tile_nx, g), g)


def _rho(deck, p, origins, order):
    t, g = deck.tiling, deck.guard
    xi, eta = tile_local_coords(p.x, p.y, origins, t.tile_nx, t.tile_ny,
                                (deck.nx, deck.ny))
    return _global(deck, deposit_rho_chunk(xi, eta, -p.w, t.tile_ny,
                                           t.tile_nx, g, order, deck.dx,
                                           deck.dy))


@pytest.mark.parametrize("order", [1, 2])
def test_kernel_current_satisfies_continuity(order):
    """(rho1 - rho0)/dt + div J = 0 to f32 round-off with the kernel's J
    and the kernel's pushed positions."""
    deck, p, ft, kw = _fixture(order, 4, 8)
    origins = _tile_origins(deck.tiling, jnp.float32)
    p1, (jx, jy, _), _ = advance_tiles(p, ft, origins, interpret=True, **kw)
    rho0 = _rho(deck, p, origins, order)
    rho1 = _rho(deck, p1, origins, order)
    gx, gy = _global(deck, jx), _global(deck, jy)
    div = ((gx - jnp.roll(gx, 1, 1)) / deck.dx
           + (gy - jnp.roll(gy, 1, 0)) / deck.dy)
    resid = (rho1 - rho0) / deck.dt + div
    scale = float(jnp.abs(rho1 - rho0).max()) / deck.dt
    assert float(jnp.abs(resid).max()) <= 1e-5 * scale
