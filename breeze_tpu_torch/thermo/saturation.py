"""Saturation vapor pressure and the warm phase equilibrium.

Port of the part of ``breeze_tpu/thermo/saturation.py`` that BOMEX uses:
the integrated Clausius-Clapeyron closure, its slope ratio, the saturation
specific humidity and :class:`WarmPhaseEquilibrium`.  The Flatau and Tetens
fits and the mixed-phase equilibrium are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from .constants import ThermodynamicConstants

LIQUID_SURFACE = 1.0


def _mixed_latent_heat_params(constants: ThermodynamicConstants, lam):
    """Effective (L0, dc) for a surface with liquid fraction lam."""
    L0l = constants.absolute_zero_latent_heat(constants.liquid)
    L0i = constants.absolute_zero_latent_heat(constants.ice)
    dcl = constants.specific_heat_difference(constants.liquid)
    dci = constants.specific_heat_difference(constants.ice)
    return lam * L0l + (1.0 - lam) * L0i, lam * dcl + (1.0 - lam) * dci


def clausius_clapeyron_svp(T, constants: ThermodynamicConstants,
                           lam=LIQUID_SURFACE):
    """``p = p_tr (T/T_tr)^(dc/Rv) exp[(L0/Rv)(1/T_tr - 1/T)]``."""
    L0, dc = _mixed_latent_heat_params(constants, lam)
    Rv = constants.Rv
    Ttr = constants.triple_point_temperature
    ptr = constants.triple_point_pressure
    return ptr * (T / Ttr) ** (dc / Rv) * torch.exp((L0 / Rv) * (1.0 / Ttr - 1.0 / T))


def saturation_vapor_pressure(T, constants: ThermodynamicConstants,
                              lam=LIQUID_SURFACE):
    if constants.saturation_formulation != "clausius_clapeyron":
        raise NotImplementedError(
            f"saturation formulation {constants.saturation_formulation!r} "
            "is not ported yet")
    return clausius_clapeyron_svp(T, constants, lam)


def saturation_vapor_pressure_slope_ratio(T, constants: ThermodynamicConstants,
                                          lam=LIQUID_SURFACE):
    """(dpᵛ⁺/dT) / pᵛ⁺ = (L₀ + Δc·T) / (Rᵛ T²)."""
    L0, dc = _mixed_latent_heat_params(constants, lam)
    return (L0 + dc * T) / (constants.Rv * T * T)


@dataclasses.dataclass(frozen=True)
class WarmPhaseEquilibrium:
    """Only liquid condensate; the equilibrated surface is planar liquid."""

    def liquid_fraction(self, T):
        return 1.0


def saturation_specific_humidity(T, rho, constants: ThermodynamicConstants,
                                 lam=LIQUID_SURFACE):
    """qᵛ⁺ = pᵛ⁺ / (ρ Rᵛ T)."""
    pvs = saturation_vapor_pressure(T, constants, lam)
    return pvs / (rho * constants.Rv * T)
