"""Hydrostatic reference states.

Port of ``breeze_tpu/thermo/reference.py``: ``make_reference_state`` for a
constant potential temperature (the closed-form dry adiabat, the anelastic
model's), and ``make_exner_reference_state`` (the discretely balanced
column of the compressible core).  The profiles are built on the host in
float64 numpy from the grid's heights (as rounded to the field dtype, like
the reference package), then stored as columns in the grid's dtype on its
device.
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


@dataclasses.dataclass(frozen=True)
class ExnerReferenceState:
    """Discretely balanced reference column of the compressible core
    (``breeze_tpu.thermo.reference.ExnerReferenceState``): the face operator

        (p[k] − p[k−1]) / Δzᶠ[k] + g (ρ[k] + ρ[k−1]) / 2 = 0

    holds at every interior z-face to float64 roundoff before the columns
    are rounded to the grid's dtype.  Centers ``(nz,)``, faces ``(nz+1,)``."""

    surface_pressure: float
    surface_potential_temperature: float
    standard_pressure: float
    p_c: torch.Tensor
    rho_c: torch.Tensor
    T_c: torch.Tensor
    theta_c: torch.Tensor
    exner_c: torch.Tensor
    rho_f: torch.Tensor
    qv_c: torch.Tensor

    @property
    def p_col(self):
        return self.p_c[:, None, None]

    @property
    def rho_col(self):
        return self.rho_c[:, None, None]

    @property
    def theta_col(self):
        return self.theta_c[:, None, None]

    @property
    def T_col(self):
        return self.T_c[:, None, None]

    @property
    def rho_f_col(self):
        """Face density at the stored faces 0..nz-1."""
        return self.rho_f[:-1, None, None]


def make_exner_reference_state(grid: Grid, constants: ThermodynamicConstants,
                               surface_pressure: float = 101325.0,
                               potential_temperature=300.0,
                               vapor_mass_fraction=None,
                               standard_pressure: float = 1.0e5,
                               newton_iterations: int = 30) -> ExnerReferenceState:
    """Per-level Newton solve of the discrete hydrostatic balance
    (``breeze_tpu.thermo.reference.make_exner_reference_state``, transcribed
    as is): at each level k ≥ 1 solve

        F(p) = (p − p[k−1])/Δzᶠ[k] + g (ρ(p) + ρ[k−1]) / 2 = 0,
        ρ(p) = p^{1−κ} (pˢᵗ)^κ / (Rᵐ θₖ),

    from a continuous-Exner first guess; the first center is anchored by
    the continuous Exner recurrence over the half cell below it.  θ and qᵛ
    are numbers or functions of height."""
    p0 = float(surface_pressure)
    p_st = float(standard_pressure)
    g = constants.gravitational_acceleration
    Rd, Rv = constants.Rd, constants.Rv
    cpd = constants.dry_air.heat_capacity
    cpv = constants.vapor.heat_capacity

    z_c = grid.host(grid.z_c)
    dz_f = grid.host(grid.dz_f)
    nz = grid.nz
    value = lambda f, z: f(z) if callable(f) else float(f)
    theta_c = np.asarray([value(potential_temperature, z) for z in z_c])
    qv_c = np.asarray([0.0 if vapor_mass_fraction is None
                       else value(vapor_mass_fraction, z) for z in z_c])
    Rm_c = (1.0 - qv_c) * Rd + qv_c * Rv
    cpm_c = (1.0 - qv_c) * cpd + qv_c * cpv
    kappa_c = Rm_c / cpm_c

    p_c = np.empty(nz, np.float64)
    rho_c = np.empty(nz, np.float64)
    kap0 = kappa_c[0]
    Pi_0 = (p0 / p_st) ** kap0 - g * (z_c[0] - grid.z0) / (cpm_c[0] * theta_c[0])
    p_c[0] = p_st * Pi_0 ** (1.0 / kap0)
    rho_c[0] = p_c[0] ** (1.0 - kap0) * p_st ** kap0 / (Rm_c[0] * theta_c[0])
    for k in range(1, nz):
        kap = kappa_c[k]
        Rm_th = Rm_c[k] * theta_c[k]

        def rho_of(p):
            return p ** (1.0 - kap) * p_st ** kap / Rm_th

        Pi_guess = (p_c[k - 1] / p_st) ** kap - g * dz_f[k] / (cpm_c[k] * theta_c[k])
        p = p_st * max(Pi_guess, 1e-10) ** (1.0 / kap)
        for _ in range(newton_iterations):
            F = (p - p_c[k - 1]) / dz_f[k] + g * 0.5 * (rho_of(p) + rho_c[k - 1])
            dF = 1.0 / dz_f[k] + g * 0.5 * (1.0 - kap) * rho_of(p) / p
            p_new = p - F / dF
            converged = abs(p_new - p) < 1e-13 * p
            p = p_new
            if converged:
                break
        p_c[k] = p
        rho_c[k] = rho_of(p)

    exner_c = (p_c / p_st) ** kappa_c
    rho_f = np.empty(nz + 1, np.float64)
    rho_f[1:nz] = 0.5 * (rho_c[1:] + rho_c[:-1])
    rho_f[0] = rho_c[0]
    rho_f[nz] = rho_c[-1]
    as_t = lambda a: torch.as_tensor(a, dtype=grid.dtype, device=grid.device)
    return ExnerReferenceState(
        surface_pressure=p0, surface_potential_temperature=float(theta_c[0]),
        standard_pressure=p_st, p_c=as_t(p_c), rho_c=as_t(rho_c),
        T_c=as_t(theta_c * exner_c), theta_c=as_t(theta_c), exner_c=as_t(exner_c),
        rho_f=as_t(rho_f), qv_c=as_t(qv_c))
