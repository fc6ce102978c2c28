"""Scalar WENO5 flux divergence: the advection kernel.

Replaces ``breeze_tpu/pallas_kernels/advection.py::div_rho_u_c_pallas`` (the
``pl.pallas_call`` in ``_run``, body ``_make_kernel``).  It computes
G = −∇·(ρuc) for a specific scalar c: at each face the mass flux is the
two-cell mean of ρ times the face velocity, and c is reconstructed there
by WENO5 upwind of it, with max-normalized weights and a 1e-9 floor.
``bounds`` clips each interface value to the hull of its two adjacent
cells (``WENO(5, bounds_preserving=True)``).

Inputs are c, u, v, w and ρ as windows padded by ``H`` in z and y
(``fields.pad``), and 1/Δz at centers, so stretched z works.

On the H100 it is bound by device memory (``csrc/advection.cu`` has the
numbers).  The design: one thread per output point with x fastest, as the
momentum kernel; the weight normalization takes an exact reciprocal where
the TPU kernel took an approximate one.

``div_rho_u_c`` runs :func:`div_rho_u_c_plain` for CPU tensors and the CUDA
kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from . import _build
from .weno import H, sl, weno_sel, xs

#: Times the CUDA kernel was launched (the plain version does not count).
launches = 0


def _face(cell, mf, bounds: bool):
    out = weno_sel(cell, mf, normalize=True)
    if bounds:
        lo, hi = cell(0), cell(1)
        out = torch.clamp(out, torch.minimum(lo, hi), torch.maximum(lo, hi))
    return out


def div_rho_u_c_plain(c, u, v, w, rho, invdz, inv_dx: float, inv_dy: float,
                      bounds: bool = False):
    """The kernel on whole arrays (any float dtype).  Arguments as
    :func:`div_rho_u_c`."""
    nz = c.shape[0] - 2 * H
    ny = c.shape[1] - 2 * H
    # x: faces 0..nx-1 (periodic)
    rs, cs = sl(rho, 0, nz, 0, ny), sl(c, 0, nz, 0, ny)
    mfx = 0.5 * (rs + xs(rs, -1)) * sl(u, 0, nz, 0, ny)
    Fx = mfx * _face(lambda o: xs(cs, o - 1), mfx, bounds)
    acc = (xs(Fx, 1) - Fx) * inv_dx
    # y: faces 0..ny
    mfy = (0.5 * (sl(rho, 0, nz, -1, ny + 1) + sl(rho, 0, nz, 0, ny + 1))
           * sl(v, 0, nz, 0, ny + 1))
    Fy = mfy * _face(lambda o: sl(c, 0, nz, o - 1, ny + 1), mfy, bounds)
    acc = acc + (Fy[:, 1:] - Fy[:, :-1]) * inv_dy
    # z: faces 0..nz (the top one from the pad, where w is 0)
    mfz = (0.5 * (sl(rho, -1, nz + 1, 0, ny) + sl(rho, 0, nz + 1, 0, ny))
           * sl(w, 0, nz + 1, 0, ny))
    Fz = mfz * _face(lambda o: sl(c, o - 1, nz + 1, 0, ny), mfz, bounds)
    acc = acc + (Fz[1:] - Fz[:-1]) * invdz[:, None, None]
    return -acc


def div_rho_u_c(c, u, v, w, rho, invdz, inv_dx: float, inv_dy: float,
                bounds: bool = False):
    """−∇·(ρuc) at centers, ``(nz, ny, nx)``.

    - ``c``, ``u``, ``v``, ``w``, ``rho``: ``(nz+2H, ny+2H, nx)`` windows
      padded in z and y;
    - ``invdz``: 1/Δz at centers, ``(nz,)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches
    if c.device.type == "cpu":
        return div_rho_u_c_plain(c, u, v, w, rho, invdz, inv_dx, inv_dy, bounds)
    nzp, nyp, nx = c.shape
    nz, ny = nzp - 2 * H, nyp - 2 * H
    for name, t in (("c", c), ("u", u), ("v", v), ("w", w), ("rho", rho)):
        _build.require_cuda(name, t, c.shape)
    _build.require_cuda("invdz", invdz, (nz,))
    if nx < 4 or ny < 3 or nz < 4:
        raise ValueError("the CUDA kernel needs nx >= 4, ny >= 3, nz >= 4")
    out = torch.empty((nz, ny, nx), dtype=c.dtype, device=c.device)
    _build.launch("breeze_div_rho_u_c", [c, u, v, w, rho, invdz, out],
                  [nz, ny, nx, int(bool(bounds))], [inv_dx, inv_dy], c)
    launches += 1
    return out
