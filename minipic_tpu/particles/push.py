"""Relativistic Boris particle push.

Completes the "Particle Advance" stage of the reference's four-stage PIC
loop (Mini_PIC_2D_Report.pdf Fig. 1; unimplemented in the reference code —
SURVEY.md §0).  State contract from the reference's Particle struct
(Auxiliar_functions.h:16-21): positions (x, y) and proper momenta
(px, py, pz) in units of m_e c; 2-D positions with full 3-D momentum
("2D3V").

Normalized equations (time in 1/omega_p, E/B in m_e c omega_p / e):

    du/dt = (q/m) (E + (u/gamma) x B),   gamma = sqrt(1 + |u|^2)
    dx/dt = u_x / gamma,  dy/dt = u_y / gamma

Boris rotation splits the update into two half electric kicks around an
exact-magnitude magnetic rotation — energy-conserving for pure B fields,
second-order accurate, the standard PIC pusher (Birdsall & Langdon, the
report's ref [1]).

All functions are elementwise over arbitrarily-shaped arrays ([T, K] here);
XLA fuses the whole pusher into one elementwise kernel; the GPU advance
kernel calls the same functions.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def boris_push(px, py, pz, ex, ey, ez, bx, by, bz, qm: float, dt: float):
    """Advance momenta u^{n-1/2} -> u^{n+1/2} with fields at time n.

    qm = charge/mass in units of e/m_e.
    """
    h = qm * dt * 0.5
    # Half electric kick
    pxm = px + h * ex
    pym = py + h * ey
    pzm = pz + h * ez
    # Magnetic rotation at mid-step gamma
    gamma_inv = 1.0 / jnp.sqrt(1.0 + pxm * pxm + pym * pym + pzm * pzm)
    tx = h * bx * gamma_inv
    ty = h * by * gamma_inv
    tz = h * bz * gamma_inv
    t2 = tx * tx + ty * ty + tz * tz
    sfac = 2.0 / (1.0 + t2)
    sx, sy, sz = tx * sfac, ty * sfac, tz * sfac
    # p' = p- + p- x t
    ppx = pxm + (pym * tz - pzm * ty)
    ppy = pym + (pzm * tx - pxm * tz)
    ppz = pzm + (pxm * ty - pym * tx)
    # p+ = p- + p' x s
    pxp = pxm + (ppy * sz - ppz * sy)
    pyp = pym + (ppz * sx - ppx * sz)
    pzp = pzm + (ppx * sy - ppy * sx)
    # Second half electric kick
    return pxp + h * ex, pyp + h * ey, pzp + h * ez


def velocities(px, py, pz):
    gamma_inv = 1.0 / jnp.sqrt(1.0 + px * px + py * py + pz * pz)
    return px * gamma_inv, py * gamma_inv, pz * gamma_inv


def advance_positions(
    x, y, px, py, pz, dt: float, dx: float, dy: float
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """x^n -> x^{n+1} using u^{n+1/2}; positions in global *cell* units.

    No wrapping here — the Esirkepov deposit needs the unwrapped pre/post
    pair; periodic wrap (or absorption) is applied by the binning pass.
    """
    vx, vy, _ = velocities(px, py, pz)
    return x + vx * (dt / dx), y + vy * (dt / dy)
