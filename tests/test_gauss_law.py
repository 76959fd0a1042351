"""Gauss-law preservation: the whole-loop consistency invariant.

Esirkepov deposition + the Yee update imply that div E - rho is a
*constant of motion* (whatever Gauss-law violation the initial condition
has, the evolution must not change it).  This exercises gather, push,
deposit, folding, and the field update together — any stagger or sign slip
anywhere breaks it.
"""
import numpy as np

from minipic_tpu.core.config import Deck, SpeciesSpec
from minipic_tpu.diag.device import gauss_residual
from minipic_tpu.simulation import Simulation


def test_gauss_law_residual_is_constant_of_motion():
    deck = Deck(
        box_x=8.0, box_y=8.0, nx=32, ny=32, tile_nx=8, tile_ny=8, guard=3,
        species=(
            SpeciesSpec("ele", charge=-1.0, mass=1.0, ppc=4, ux=0.3, uy=0.15, uth=0.05),
            SpeciesSpec("ion", charge=+1.0, mass=10.0, ppc=4, ux=-0.1, uth=0.02),
        ),
        precision="f64",
    )
    sim = Simulation(deck, seed=6)
    resid0 = np.asarray(gauss_residual(sim.state, deck)[0])
    sim.step(25)
    resid1, rho = (np.asarray(a) for a in gauss_residual(sim.state, deck))
    scale = max(1e-12, np.abs(rho).max())
    np.testing.assert_allclose(resid1, resid0, atol=1e-10 * scale)
