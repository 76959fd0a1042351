"""Fused gather + Boris push + Esirkepov deposit: one Pallas kernel for
NVIDIA GPUs, lowered through Triton (``backend="triton"``).

The XLA advance (simulation.advance_species_tiles) builds dense
``[T, kc, n+2g]`` shape matrices and their products in device memory
between gather, push and deposit.  This kernel keeps all of that in
registers:

  grid = (num_tiles,): one program owns one tile and its bucket.
  The six field windows are loaded once.  The bucket is walked in
  ``chunk``-particle blocks by a loop inside the program (masked loads
  cover a partial last block); per block the 1-D shape vectors are built
  densely over the window, the six components are gathered by
  shape-vector x window products, the Boris push and move run
  elementwise, and the Esirkepov terms are contracted over the block's
  particles into three window accumulators, written once at the end.

Each program owns its tile's J windows, so there are no atomics and the
result is deterministic.  Particles are read once and written once.
Every product passes ``precision=HIGHEST``, which Triton lowers to IEEE
f32 (no TF32): continuity holds to f32 round-off.

Stagger and shape contracts are those of particles/gather.py and
particles/deposit.py; tests compare the two paths on the same data.
f32 only.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...core.state import FieldState, ParticleState
from ...particles.deposit import prefix_flux
from ...particles.push import boris_push, velocities
from ...particles.shapes import shape_values

_HIGHEST = lax.Precision.HIGHEST
# Particles per block and warps per program: the fastest pair measured on
# an H100 at the headline deck (54 ms; 64/4 took 81 ms, 128/8 92 ms, and
# 256/4, 512/8 and 128/2 spill registers at 670-915 ms).
CHUNK = 128
NUM_WARPS = 4


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _gather_dot(s, f):
    # shape [C, Wx] x window [Wy, Wx] -> [C, Wy] (contract x)
    return lax.dot_general(s, f, (((1,), (1,)), ((), ())), precision=_HIGHEST)


def _deposit_dot(a, b):
    # [C, Wy] x [C, Wx] -> [Wy, Wx] (contract the particle block)
    return lax.dot_general(a, b, (((0,), (0,)), ((), ())), precision=_HIGHEST)


def _kernel(ox_ref, oy_ref, x_ref, y_ref, px_ref, py_ref, pz_ref, w_ref,
            ex_ref, ey_ref, ez_ref, bx_ref, by_ref, bz_ref,
            xo_ref, yo_ref, pxo_ref, pyo_ref, pzo_ref,
            jx_ref, jy_ref, jz_ref, disp_ref,
            *, cap: int, chunk: int, win: int, g: int, tile_nx: int,
            tile_ny: int, order: int, qm: float, q: float, dt: float,
            dx: float, dy: float, grid: Optional[Tuple[int, int]]):
    t = pl.program_id(0)
    ox = ox_ref[t]
    oy = oy_ref[t]
    fex, fey, fez = ex_ref[...], ey_ref[...], ez_ref[...]
    fbx, fby, fbz = bx_ref[...], by_ref[...], bz_ref[...]
    # Window coordinates of the integer-stagger points, [1, W].
    ci = (lax.broadcasted_iota(jnp.int32, (1, win), 1) - g).astype(jnp.float32)
    ch = ci + 0.5

    def shp(pos, c):
        return shape_values(pos[:, None] - c, order)  # [C, W]

    def body(i, carry):
        ajx, ajy, ajz, dmax = carry
        idx = i * chunk + jnp.arange(chunk)
        mask = idx < cap

        def ld(ref):
            return plgpu.load(ref.at[idx], mask=mask, other=0.0)

        x, y, px, py, pz, w = (ld(r) for r in (x_ref, y_ref, px_ref, py_ref,
                                               pz_ref, w_ref))
        xi0 = x - ox
        eta0 = y - oy
        if grid is not None:
            # Same nearest-image fold as simulation.tile_local_coords.
            gnx, gny = grid
            xi0 = xi0 - gnx * jnp.floor((xi0 + (gnx - tile_nx) * 0.5) * (1.0 / gnx))
            eta0 = eta0 - gny * jnp.floor((eta0 + (gny - tile_ny) * 0.5) * (1.0 / gny))
        sx_i, sx_h = shp(xi0, ci), shp(xi0, ch)
        sy_i, sy_h = shp(eta0, ci), shp(eta0, ch)

        def red(s_x, f, s_y):
            return jnp.sum(_gather_dot(s_x, f) * s_y, axis=1)

        ex = red(sx_h, fex, sy_i)
        ey = red(sx_i, fey, sy_h)
        ez = red(sx_i, fez, sy_i)
        bx = red(sx_i, fbx, sy_h)
        by = red(sx_h, fby, sy_i)
        bz = red(sx_h, fbz, sy_h)
        px, py, pz = boris_push(px, py, pz, ex, ey, ez, bx, by, bz, qm, dt)
        vx, vy, vz = velocities(px, py, pz)
        x1 = x + vx * (dt / dx)
        y1 = y + vy * (dt / dy)
        plgpu.store(xo_ref.at[idx], x1, mask=mask)
        plgpu.store(yo_ref.at[idx], y1, mask=mask)
        plgpu.store(pxo_ref.at[idx], px, mask=mask)
        plgpu.store(pyo_ref.at[idx], py, mask=mask)
        plgpu.store(pzo_ref.at[idx], pz, mask=mask)

        # The end point is the STORED position (x1 - x, not v dt/dx), so
        # the deposit and the next step's charge see the same f32 value
        # and continuity holds to round-off.
        xi1 = xi0 + (x1 - x)
        eta1 = eta0 + (y1 - y)
        s1x = shp(xi1, ci)
        s1y = shp(eta1, ci)
        dsx = s1x - sx_i
        dsy = s1y - sy_i
        qw = q * w
        cx = (-qw / (dt * dy))[:, None]
        cy = (-qw / (dt * dx))[:, None]
        cz = (qw * vz / (dx * dy))[:, None]
        ajx = ajx + _deposit_dot((sy_i + 0.5 * dsy) * cx,
                                 prefix_flux(dsx, xi0, xi1, g, order))
        ajy = ajy + _deposit_dot(prefix_flux(dsy, eta0, eta1, g, order) * cy,
                                 sx_i + 0.5 * dsx)
        ajz = (ajz + _deposit_dot(sy_i * cz, sx_i + 0.5 * dsx)
               + _deposit_dot(dsy * cz, 0.5 * sx_i + (1.0 / 3.0) * dsx))
        m = jnp.maximum(jnp.abs(vx) * (dt / dx), jnp.abs(vy) * (dt / dy))
        dmax = jnp.maximum(dmax, jnp.max(jnp.where(w > 0, m, 0.0)))
        return ajx, ajy, ajz, dmax

    zero = jnp.zeros((win, win), jnp.float32)
    n_chunks = pl.cdiv(cap, chunk)
    ajx, ajy, ajz, dmax = lax.fori_loop(
        0, n_chunks, body, (zero, zero, zero, jnp.float32(0.0)))
    jx_ref[...] = ajx
    jy_ref[...] = ajy
    jz_ref[...] = ajz
    disp_ref[...] = jnp.full((1,), dmax, jnp.float32)


def advance_tiles(
    p: ParticleState,
    ftiles: FieldState,
    origins: Tuple[jax.Array, jax.Array],
    *,
    qm: float,
    q: float,
    order: int,
    tile_ny: int,
    tile_nx: int,
    g: int,
    dt: float,
    dx: float,
    dy: float,
    grid: Optional[Tuple[int, int]] = None,
    vma_axes: Tuple[str, ...] = (),
    interpret: bool = False,
):
    """Advance one species' buckets.  Same contract as the XLA path of
    simulation.advance_species_tiles with return_disp=True: returns the
    pushed particles (positions unwrapped, weights unchanged), the
    species' J window stacks ([T, nyg, nxg] each) and the largest
    per-axis step displacement of any live particle, in cells.
    `vma_axes`: the mesh axes the operands vary over inside shard_map."""
    t_total, cap = p.x.shape
    nyg, nxg = tile_ny + 2 * g, tile_nx + 2 * g
    # Triton blocks are powers of two, and a product needs every
    # dimension >= 16: zero-pad the windows to a W x W square.
    win = max(16, _next_pow2(max(nyg, nxg)))
    fw = tuple(jnp.pad(c, ((0, 0), (0, win - nyg), (0, win - nxg)))
               for c in ftiles)
    ox, oy = (o.reshape(t_total).astype(jnp.float32) for o in origins)

    kernel = functools.partial(
        _kernel, cap=cap, chunk=CHUNK, win=win, g=g, tile_nx=tile_nx,
        tile_ny=tile_ny, order=order, qm=qm, q=q, dt=dt, dx=dx, dy=dy,
        grid=grid)
    scal = pl.BlockSpec((t_total,), lambda t: (0,))
    part = pl.BlockSpec((None, cap), lambda t: (t, 0))
    wspec = pl.BlockSpec((None, win, win), lambda t: (t, 0, 0))
    vma = frozenset(vma_axes) if vma_axes else None

    def sds(shape):
        return jax.ShapeDtypeStruct(shape, jnp.float32, vma=vma)

    pshape, wshape = sds((t_total, cap)), sds((t_total, win, win))
    outs = pl.pallas_call(
        kernel,
        grid=(t_total,),
        in_specs=[scal, scal] + [part] * 6 + [wspec] * 6,
        out_specs=[part] * 5 + [wspec] * 3
        + [pl.BlockSpec((None, 1), lambda t: (t, 0))],
        out_shape=[pshape] * 5 + [wshape] * 3
        + [sds((t_total, 1))],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="pic_advance",
    )(ox, oy, *p, *fw)
    x1, y1, px, py, pz, jx, jy, jz, disp = outs
    p_out = ParticleState(x1, y1, px, py, pz, p.w)
    j = tuple(a[:, :nyg, :nxg] for a in (jx, jy, jz))
    return p_out, j, jnp.max(disp)
