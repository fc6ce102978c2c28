"""WENO5 momentum flux divergences: the momentum kernels.

Replaces ``breeze_tpu/pallas_kernels/momentum.py::momentum_div_pallas`` (the
``pl.pallas_call`` in ``_run``, body ``momentum_divs``) and, as
:func:`momentum_div_cols`, ``momentum_div_pallas_cols`` (the
``pl.pallas_call`` in ``_run_cols``).  It computes the nine WENO5 terms of
∇·(ρU⊗u), the advecting momenta interpolated to each interface and the
advected velocity reconstructed there upwind of them, with un-normalized
weights (velocities are bounded, see ``weno.weno5``):

    du at (zc, yc, xf),  dv at (zc, yf, xc),  dw at (zf, yc, xc).

Inputs are ρu, ρv, ρw and u, v, w as windows padded by ``H`` in z and y
(``fields.pad``), and 1/Δz at centers and faces, so stretched z works.
:func:`momentum_div_cols` takes the anelastic form ρu = ρᵣ(z)·u: the three
velocity windows and the reference density at centers and faces as
``H``-padded columns, the momenta formed inside the kernel.  Row 0 of
``dw`` reads below-wall pad data, which the wall condition overwrites.

On the H100 (``csrc/momentum.cu`` has the numbers) :func:`momentum_div` is
one thread per output point with x fastest, each interface reconstructed
twice; :func:`momentum_div_cols` is the fused tendency kernel's z-marching
tile (``csrc/momentum_tile.cuh``): 32 × 16 columns a block marching up
:data:`COLS_Z_CHUNK` levels, u, v, w in a ring of planes in shared memory,
each face reconstructed once.

``momentum_div`` and ``momentum_div_cols`` run their plain versions for
CPU tensors and the CUDA kernels for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .weno import H, sl, weno_sel, xs

#: Times each CUDA instance was launched (the plain versions do not count):
#: ``launches`` for :func:`momentum_div`, ``cols_launches`` for
#: :func:`momentum_div_cols`.
launches = 0
cols_launches = 0

#: The levels a block of the column kernel marches up; the chunk's six
#: planes below and above are loaded again by the chunks beside it.
COLS_Z_CHUNK = 64


def momentum_div_plain(ru, rv, rw, u, v, w, invdzc, invdzf,
                       inv_dx: float, inv_dy: float):
    """The kernel on whole arrays (any float dtype).  Arguments as
    :func:`momentum_div`."""
    nz = u.shape[0] - 2 * H
    ny = u.shape[1] - 2 * H
    s = lambda a, zo, yo: sl(a, zo, nz, yo, ny)
    sy = lambda a, zo, y0: sl(a, zo, nz, y0, ny + 1)
    sz = lambda a, z0, yo: sl(a, z0, nz + 1, yo, ny)
    dify = lambda F: F[:, 1:] - F[:, :-1]
    difz = lambda F: F[1:] - F[:-1]
    invdzc, invdzf = invdzc[:, None, None], invdzf[:, None, None]
    wsel = lambda cell, sign: weno_sel(cell, sign, normalize=False)

    # ---- u at (zc, yc, xf) -------------------------------------------------
    rus, us = s(ru, 0, 0), s(u, 0, 0)
    mf = 0.5 * (rus + xs(rus, 1))
    F = mf * wsel(lambda o: xs(us, o), mf)
    du = (F - xs(F, -1)) * inv_dx
    rvc = sy(rv, 0, 0)
    mf = 0.5 * (rvc + xs(rvc, -1))
    F = mf * wsel(lambda o: sy(u, 0, o - 1), mf)
    du = du + dify(F) * inv_dy
    rwc = sz(rw, 0, 0)
    mf = 0.5 * (rwc + xs(rwc, -1))
    F = mf * wsel(lambda o: sz(u, o - 1, 0), mf)
    du = du + difz(F) * invdzc

    # ---- v at (zc, yf, xc) -------------------------------------------------
    mf = 0.5 * (s(ru, 0, 0) + s(ru, 0, -1))
    vs = s(v, 0, 0)
    F = mf * wsel(lambda o: xs(vs, o - 1), mf)
    dv = (xs(F, 1) - F) * inv_dx
    mf = 0.5 * (sy(rv, 0, -1) + sy(rv, 0, 0))
    F = mf * wsel(lambda o: sy(v, 0, o - 1), mf)
    dv = dv + dify(F) * inv_dy
    mf = 0.5 * (sz(rw, 0, 0) + sz(rw, 0, -1))
    F = mf * wsel(lambda o: sz(v, o - 1, 0), mf)
    dv = dv + difz(F) * invdzc

    # ---- w at (zf, yc, xc) -------------------------------------------------
    mf = 0.5 * (s(ru, 0, 0) + s(ru, -1, 0))
    ws = s(w, 0, 0)
    F = mf * wsel(lambda o: xs(ws, o - 1), mf)
    dw = (xs(F, 1) - F) * inv_dx
    mf = 0.5 * (sy(rv, 0, 0) + sy(rv, -1, 0))
    F = mf * wsel(lambda o: sy(w, 0, o - 1), mf)
    dw = dw + dify(F) * inv_dy
    mf = 0.5 * (sz(rw, -1, 0) + sz(rw, 0, 0))
    F = mf * wsel(lambda o: sz(w, o - 1, 0), mf)
    dw = dw + difz(F) * invdzf
    return du, dv, dw


def momentum_div(ru, rv, rw, u, v, w, invdzc, invdzf,
                 inv_dx: float, inv_dy: float):
    """``(du, dv, dw)``, the divergences ∇·(ρU⊗u) (not their negatives).

    - ``ru``, ``rv``, ``rw``, ``u``, ``v``, ``w``: ``(nz+2H, ny+2H, nx)``
      windows padded in z and y;
    - ``invdzc``, ``invdzf``: 1/Δz at centers and at the stored faces,
      ``(nz,)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches
    if u.device.type == "cpu":
        return momentum_div_plain(ru, rv, rw, u, v, w, invdzc, invdzf, inv_dx, inv_dy)
    nzp, nyp, nx = u.shape
    nz, ny = nzp - 2 * H, nyp - 2 * H
    for name, t in (("ru", ru), ("rv", rv), ("rw", rw), ("u", u), ("v", v), ("w", w)):
        _build.require_cuda(name, t, u.shape)
    for name, t in (("invdzc", invdzc), ("invdzf", invdzf)):
        _build.require_cuda(name, t, (nz,))
    if nx < 4 or ny < 3 or nz < 4:
        raise ValueError("the CUDA kernel needs nx >= 4, ny >= 3, nz >= 4")
    outs = [torch.empty((nz, ny, nx), dtype=u.dtype, device=u.device) for _ in range(3)]
    _build.launch("breeze_momentum_div",
                  [ru, rv, rw, u, v, w, invdzc, invdzf, *outs],
                  [nz, ny, nx], [inv_dx, inv_dy], u)
    launches += 1
    return tuple(outs)


def momentum_div_cols_plain(u, v, w, colc, colf, invdzc, invdzf,
                            inv_dx: float, inv_dy: float):
    """The column instance on whole arrays (any float dtype).  Arguments as
    :func:`momentum_div_cols`."""
    colc, colf = colc[:, None, None], colf[:, None, None]
    return momentum_div_plain(u * colc, v * colc, w * colf, u, v, w, invdzc, invdzf,
                              inv_dx, inv_dy)


def momentum_div_cols(u, v, w, colc, colf, invdzc, invdzf,
                      inv_dx: float, inv_dy: float):
    """``(du, dv, dw)``, the divergences ∇·(ρU⊗u) with ρu = ρᵣ(z)·u.

    - ``u``, ``v``, ``w``: ``(nz+2H, ny+2H, nx)`` windows padded in z and y;
    - ``colc``, ``colf``: the reference density at centers and faces,
      ``(nz+2H,)``, padded as ``model.TendencyColumns`` pads them;
    - ``invdzc``, ``invdzf``: 1/Δz at centers and at the stored faces,
      ``(nz,)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global cols_launches
    if u.device.type == "cpu":
        return momentum_div_cols_plain(u, v, w, colc, colf, invdzc, invdzf, inv_dx, inv_dy)
    nzp, nyp, nx = u.shape
    nz, ny = nzp - 2 * H, nyp - 2 * H
    for name, t in (("u", u), ("v", v), ("w", w)):
        _build.require_cuda(name, t, u.shape)
    for name, t in (("colc", colc), ("colf", colf)):
        _build.require_cuda(name, t, (nzp,))
    for name, t in (("invdzc", invdzc), ("invdzf", invdzf)):
        _build.require_cuda(name, t, (nz,))
    if nx < 4 or ny < 3 or nz < 4:
        raise ValueError("the CUDA kernel needs nx >= 4, ny >= 3, nz >= 4")
    outs = [torch.empty((nz, ny, nx), dtype=u.dtype, device=u.device) for _ in range(3)]
    _build.launch("breeze_momentum_div_cols",
                  [u, v, w, colc, colf, invdzc, invdzf, *outs],
                  [nz, ny, nx, COLS_Z_CHUNK], [inv_dx, inv_dy], u)
    cols_launches += 1
    return tuple(outs)


def cols_kernel_info() -> dict:
    """The column kernel's resources: shared memory a block (bytes),
    blocks resident per SM, registers and local (spill) bytes a thread."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().breeze_momentum_div_cols_info(out),
                 "breeze_momentum_div_cols_info")
    return dict(zip(("smem_bytes", "blocks_per_sm", "registers", "local_bytes"), out))
