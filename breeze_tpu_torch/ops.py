"""Finite-volume stencil operators on halo-padded tensors.

Port of the part of ``breeze_tpu/ops.py::StencilOps`` that the diagnostics
and the pressure projection use: center/face differences, the z-face
interpolation and the cell-centered divergence.  Staggering: face ``i`` is
the lower edge of cell ``i``, so a center→face difference is
``c[i] - c[i-1]`` and a face→center difference ``u[i+1] - u[i]``.
"""

from __future__ import annotations

import torch

from .grid import Grid


class StencilOps:
    """Operators bound to a grid.  Inputs are padded by ``halo``; outputs
    are interior-shaped."""

    def __init__(self, grid: Grid, halo: int):
        self.h = halo
        self.shape = grid.shape
        self.dz_c = grid.dz_c_col
        self.dz_f = grid.dz_f_col
        self.inv_dx = 1.0 / grid.dx
        self.inv_dy = 1.0 / grid.dy

    def v(self, a: torch.Tensor, dz: int = 0, dy: int = 0,
          dx: int = 0) -> torch.Tensor:
        """Interior-sized window of padded ``a`` shifted by (dz, dy, dx)."""
        h = self.h
        nz, ny, nx = self.shape
        return a[h + dz: h + dz + nz, h + dy: h + dy + ny,
                 h + dx: h + dx + nx]

    def dx_cf(self, c):
        return (self.v(c) - self.v(c, dx=-1)) * self.inv_dx

    def dx_fc(self, u):
        return (self.v(u, dx=1) - self.v(u)) * self.inv_dx

    def dy_cf(self, c):
        return (self.v(c) - self.v(c, dy=-1)) * self.inv_dy

    def dy_fc(self, v_):
        return (self.v(v_, dy=1) - self.v(v_)) * self.inv_dy

    def dz_cf(self, c):
        return (self.v(c) - self.v(c, dz=-1)) / self.dz_f

    def dz_fc(self, w):
        return (self.v(w, dz=1) - self.v(w)) / self.dz_c

    def iz_cf(self, c):
        return 0.5 * (self.v(c) + self.v(c, dz=-1))

    def div_c(self, fx, fy, fz):
        """Cell-centered divergence of face fluxes (padded inputs)."""
        return self.dx_fc(fx) + self.dy_fc(fy) + self.dz_fc(fz)
