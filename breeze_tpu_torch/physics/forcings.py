"""Column-linear large-scale forcings.

Port of the BOMEX forcings of ``breeze_tpu/physics/forcings.py``.  Each
forcing exposes ``column_parts(model, state, aux)``: a dict from prognostic
name to ``(add, damp)`` columns ``(nz, 1, 1)`` (or ``None``), meaning
``G += add(z) − damp(z)·field``.  The fused tendency kernel applies them in
its epilogue, so the port needs no separate full-field forcing pass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


def horizontal_mean(a: torch.Tensor) -> torch.Tensor:
    """Horizontal mean, shape ``(nz, 1, 1)``."""
    return torch.mean(a, dim=(1, 2), keepdim=True)


def _dz_mean(grid, c):
    """Column ∂z⟨c⟩ at centers: face derivative with the wall face zero and
    the top face extrapolated, averaged to centers."""
    mean = horizontal_mean(c)
    dm = (mean[1:] - mean[:-1]) / grid.dz_f_col[1: grid.nz]
    ddz_f = torch.cat([torch.zeros_like(dm[:1]), dm], 0)
    return 0.5 * (ddz_f + torch.cat([ddz_f[1:], ddz_f[-1:]], 0))


@dataclasses.dataclass(frozen=True)
class GeostrophicForcing:
    """Large-scale pressure gradient balancing the Coriolis force on the
    geostrophic wind: Fᵤ = −ρ f vᵍ(z), Fᵥ = +ρ f uᵍ(z)."""

    f: float
    u_g: float | Callable = 0.0
    v_g: float | Callable = 0.0

    def column_parts(self, model, state, aux):
        z = model.grid.z_c_col
        ug = self.u_g(z) if callable(self.u_g) else self.u_g
        vg = self.v_g(z) if callable(self.v_g) else self.v_g
        rho = model.reference.rho_col
        return {"rho_u": (-rho * self.f * vg + 0.0 * z, None),
                "rho_v": (rho * self.f * ug + 0.0 * z, None)}


@dataclasses.dataclass(frozen=True)
class SubsidenceForcing:
    """Large-scale subsidence F_c = −ρ wˢ(z) ∂z⟨c⟩ for θ and qᵗ."""

    w_profile: Callable

    def column_parts(self, model, state, aux):
        g = model.grid
        w_s = self.w_profile(g.z_c_col)
        rho = model.reference.rho_col
        parts = {"rho_theta": (-rho * w_s * _dz_mean(g, aux.theta), None)}
        if aux.qt is not None:
            parts["rho_qt"] = (-rho * w_s * _dz_mean(g, aux.qt), None)
        return parts


@dataclasses.dataclass(frozen=True)
class DrySubsidenceTendency:
    """Prescribed large-scale drying F_qt(z) added to ρqᵗ."""

    tendency_profile: Callable

    def column_parts(self, model, state, aux):
        if aux.qt is None:
            return {}
        rho = model.reference.rho_col
        return {"rho_qt": (rho * self.tendency_profile(model.grid.z_c_col), None)}


@dataclasses.dataclass(frozen=True)
class UpperSponge:
    """Rayleigh damping aloft, σ(z) = rate · sin²(π/2 · (z − z₀)/L) above
    z₀: momentum toward zero w and the horizontal-mean u, v."""

    rate: float
    bottom: float

    def _sigma(self, model):
        g = model.grid
        L = max(g.Lz - self.bottom, 1e-30)
        ramp = lambda z: torch.sin(
            0.5 * math.pi * torch.clamp((z - self.bottom) / L, 0, 1)) ** 2
        return self.rate * ramp(g.z_c_col), self.rate * ramp(g.z_f_col)

    def column_parts(self, model, state, aux):
        sig_c, sig_f = self._sigma(model)
        return {"rho_u": (sig_c * horizontal_mean(state.rho_u), sig_c),
                "rho_v": (sig_c * horizontal_mean(state.rho_v), sig_c),
                "rho_w": (None, sig_f)}
