"""Hydrostatic reference state.

Port of ``breeze_tpu/thermo/reference.py::make_reference_state`` for a
constant potential temperature (the closed-form dry adiabat).  The profiles
are built on the host in float64 numpy from the grid's heights (as rounded
to the field dtype, like the reference package), then stored as columns in
the grid's dtype on its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..grid import Grid
from .constants import MoistureMassFractions, ThermodynamicConstants


@dataclasses.dataclass(frozen=True)
class ReferenceState:
    """Hydrostatic reference column: centers ``(nz,)``, faces ``(nz+1,)``."""

    surface_pressure: float
    potential_temperature: float     # value at the surface
    standard_pressure: float
    p_c: torch.Tensor
    rho_c: torch.Tensor
    T_c: torch.Tensor
    rho_f: torch.Tensor
    qv_c: torch.Tensor
    ql_c: torch.Tensor
    qi_c: torch.Tensor

    @property
    def p_col(self):
        return self.p_c[:, None, None]

    @property
    def rho_col(self):
        return self.rho_c[:, None, None]

    @property
    def T_col(self):
        return self.T_c[:, None, None]

    @property
    def rho_f_col(self):
        """Face density at the stored faces 0..nz-1."""
        return self.rho_f[:-1, None, None]

    def moisture_fractions_col(self) -> MoistureMassFractions:
        return MoistureMassFractions(self.qv_c[:, None, None],
                                     self.ql_c[:, None, None],
                                     self.qi_c[:, None, None])


def make_reference_state(grid: Grid, constants: ThermodynamicConstants,
                         surface_pressure: float = 101325.0,
                         potential_temperature: float = 288.0,
                         standard_pressure: float = 1.0e5) -> ReferenceState:
    """Dry hydrostatic reference with constant θ (closed-form adiabat)."""
    p0 = float(surface_pressure)
    p_st = float(standard_pressure)
    Rd = constants.Rd
    cpd = constants.dry_air.heat_capacity
    kappa = Rd / cpd
    g = constants.gravitational_acceleration
    z_c = grid.host(grid.z_c)

    theta0 = float(potential_temperature)
    T0 = theta0 * (p0 / p_st) ** kappa
    p_c = p0 * (1.0 - g * z_c / (cpd * T0)) ** (cpd / Rd)
    rho_c = p0 / (Rd * T0) * (p_c / p0) ** (1.0 - kappa)
    T_c = theta0 * (p_c / p_st) ** kappa

    # bottom face: surface density; interior faces: center averages; top
    # face: the last center
    nz = grid.nz
    rho_f = np.empty(nz + 1, np.float64)
    rho_f[1:nz] = 0.5 * (rho_c[1:] + rho_c[:-1])
    rho_f[0] = p0 / (Rd * T0)
    rho_f[nz] = rho_c[-1]

    as_t = lambda a: torch.as_tensor(a, dtype=grid.dtype, device=grid.device)
    zeros = torch.zeros(nz, dtype=grid.dtype, device=grid.device)
    return ReferenceState(
        surface_pressure=p0, potential_temperature=theta0,
        standard_pressure=p_st,
        p_c=as_t(p_c), rho_c=as_t(rho_c), T_c=as_t(T_c), rho_f=as_t(rho_f),
        qv_c=zeros, ql_c=zeros, qi_c=zeros)
