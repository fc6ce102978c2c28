"""Saturation adjustment and the negative-moisture correction.

Port of the part of ``breeze_tpu/physics/microphysics.py`` that BOMEX and
the moist compressible core run:

- :class:`SaturationAdjustment` with the warm equilibrium, and
  :func:`saturation_adjust`: the analytic-slope Newton on
  r(T) = T − T(θˡⁱ, q_eq(T), p) with the linearized Exner update, from the
  latent-overshoot second guess (cold) or a warm-start temperature;
- the compressible core's adjustments at the true density,
  :func:`density_saturation_adjust` (from θˡⁱ) and
  :func:`density_saturation_adjust_static_energy` (from e), each a secant
  of a fixed max(iterations + 2, 7) trips, and
  :func:`density_temperature_inversion` at a fixed partition;
- :func:`fix_negative_moisture` (the fix-negative kernel, see
  ``kernels/columnar.py``), :func:`species_borrow` and
  :func:`apply_negative_moisture_correction`.

The secant solver option and the mixed-phase equilibrium are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.columnar import fix_negative
from ..thermo.constants import MoistureMassFractions, ThermodynamicConstants
from ..thermo.saturation import (
    WarmPhaseEquilibrium,
    saturation_specific_humidity,
    saturation_vapor_pressure,
    saturation_vapor_pressure_slope_ratio,
)
from ..thermo.states import temperature_from_static_energy, temperature_from_theta_li


@dataclasses.dataclass(frozen=True)
class SaturationAdjustment:
    """Instantaneous equilibrium condensation (Newton solver).

    ``iterations``: Newton trips from a cold start; ``warm_iterations``:
    trips when a warm-start temperature is given (the previous stage's or
    step's converged T).
    """

    equilibrium: object = dataclasses.field(default_factory=WarmPhaseEquilibrium)
    iterations: int = 3
    warm_iterations: int = 2

    def __post_init__(self):
        if not isinstance(self.equilibrium, WarmPhaseEquilibrium):
            raise NotImplementedError("only the warm phase equilibrium is ported")


def adjustment_saturation_specific_humidity(T, p, qt, constants, lam):
    """Always-saturated branch: qᵛ⁺ = ε (1 − qᵗ) pᵛ⁺ / (p − pᵛ⁺)."""
    pvs = saturation_vapor_pressure(T, constants, lam)
    return constants.epsilon_dv * (1.0 - qt) * pvs / (p - pvs)


def equilibrated_moisture_fractions(T, qt, qvs, equilibrium) -> MoistureMassFractions:
    """Partition qᵗ into vapor + liquid condensate (warm equilibrium)."""
    qc = torch.clamp(qt - qvs, min=0.0)
    return MoistureMassFractions(qt - qc, qc, torch.zeros_like(qc))


def _newton_adjust_T_theta_li(T0, qt, p, theta_li,
                              constants: ThermodynamicConstants, eq,
                              iterations: int, p_standard: float):
    """Fixed-count Newton with the linearized Exner update
    Π(k) ≈ Π₀·(1 + (k−k₀)·log(p/pˢᵗ)) after the first trip.  Returns
    ``(T, qvs)``, qvs at the converged T from the last trip's linearized
    pvs."""
    Ll = constants.liquid.reference_latent_heat
    Li = constants.ice.reference_latent_heat
    eps = constants.epsilon_dv
    logp = torch.log(p / p_standard)
    T = T0
    Pi0 = k0 = pvs = slope = dT_step = None
    for i in range(iterations):
        lam = eq.liquid_fraction(T)
        pvs = saturation_vapor_pressure(T, constants, lam)
        inv_pmp = 1.0 / (p - pvs)
        qvs = eps * (1.0 - qt) * pvs * inv_pmp
        q = equilibrated_moisture_fractions(T, qt, qvs, eq)
        Rm = constants.mixture_gas_constant(q)
        cpm = constants.mixture_heat_capacity(q)
        inv_cpm = 1.0 / cpm
        k = Rm * inv_cpm
        if i == 0:
            Pi = torch.exp(k * logp)
            Pi0, k0 = Pi, k
        else:
            Pi = Pi0 * (1.0 + (k - k0) * logp)
        r = T - (Pi * theta_li + (Ll * q.liquid + Li * q.ice) * inv_cpm)
        L_eff = lam * Ll + (1.0 - lam) * Li
        slope = saturation_vapor_pressure_slope_ratio(T, constants, lam)
        dqvs = qvs * slope * p * inv_pmp
        drdT = 1.0 + L_eff * dqvs * inv_cpm
        dT_step = -torch.clamp(r / torch.clamp(drdT, min=0.1), -25.0, 25.0)
        T = T + dT_step
    pvs_f = pvs * (1.0 + slope * dT_step)
    qvs_f = eps * (1.0 - qt) * pvs_f / (p - pvs_f)
    return T, qvs_f


def saturation_adjust(theta_li, qt, p, constants: ThermodynamicConstants,
                      scheme: SaturationAdjustment, p_standard: float = 1.0e5,
                      T_guess=None):
    """Saturation-adjusted ``(T, MoistureMassFractions)`` from (θˡⁱ, qᵗ) at
    pressure p; ``T_guess`` warm-starts the Newton."""
    eq = scheme.equilibrium

    # unsaturated guess: all moisture is vapor
    q1 = MoistureMassFractions.vapor_only(qt)
    T1 = temperature_from_theta_li(theta_li, q1, p, constants, p_standard)
    lam1 = eq.liquid_fraction(T1)
    rho1 = constants.density(T1, p, q1)
    qvs1 = saturation_specific_humidity(T1, rho1, constants, lam1)
    saturated = qt > qvs1

    if T_guess is not None:
        T_start = torch.maximum(T_guess, T1 + 0.01)
        iterations = scheme.warm_iterations
    else:
        # damped Newton second guess from T1 by the analytic slope
        lam = eq.liquid_fraction(T1)
        qvs_a = adjustment_saturation_specific_humidity(T1, p, qt, constants, lam)
        qa = equilibrated_moisture_fractions(T1, qt, qvs_a, eq)
        cpm = constants.mixture_heat_capacity(qa)
        Ll = constants.liquid.reference_latent_heat
        Li = constants.ice.reference_latent_heat
        dT = (Ll * qa.liquid + Li * qa.ice) / cpm
        L_eff1 = lam * Ll + (1.0 - lam) * Li
        pvs_a = saturation_vapor_pressure(T1, constants, lam)
        dqvs1 = (qvs_a * saturation_vapor_pressure_slope_ratio(T1, constants, lam)
                 * p / (p - pvs_a))
        T_start = T1 + torch.clamp(dT / (1.0 + L_eff1 * dqvs1 / cpm), min=0.01)
        iterations = scheme.iterations

    T_star, qvs_s = _newton_adjust_T_theta_li(
        T_start, qt, p, theta_li, constants, eq, iterations, p_standard)
    q_sat = equilibrated_moisture_fractions(T_star, qt, qvs_s, eq)
    T = torch.where(saturated, T_star, T1)
    q = MoistureMassFractions(
        torch.where(saturated, q_sat.vapor, q1.vapor),
        torch.where(saturated, q_sat.liquid, 0.0),
        torch.where(saturated, q_sat.ice, 0.0))
    return T, q


def _secant(residual, Ta, Tb, trips: int):
    """``trips`` secant steps from (Ta, Tb); a step whose residual change
    is not above 1e-30 in magnitude keeps Tb."""
    ra = residual(Ta)
    for _ in range(trips):
        rb = residual(Tb)
        dr = rb - ra
        moved = dr.abs() > 1e-30
        safe = torch.where(moved, dr, torch.ones_like(dr))
        Tc = torch.where(moved, Tb - rb * (Tb - Ta) / safe, Tb)
        Ta, ra, Tb = Tb, rb, Tc
    return Tb


def _density_partition(T, rho, qt, constants, eq) -> MoistureMassFractions:
    """The equilibrium partition at the true density, qᵛ⁺ = pᵛ⁺/(ρRᵛT),
    guarded to at most max(qᵗ, 0) + 1."""
    qvs = saturation_specific_humidity(T, rho, constants, eq.liquid_fraction(T))
    qvs = torch.minimum(qvs, torch.clamp(qt, min=0.0) + 1.0)
    return equilibrated_moisture_fractions(T, qt, qvs, eq)


def density_saturation_adjust(theta_li, rho, qt, constants: ThermodynamicConstants,
                              scheme: SaturationAdjustment, p_standard: float = 1.0e5):
    """``(T, q, p)`` at density ρ from (θˡⁱ, qᵗ): the secant on
    r(T) = θˡⁱ(T; q_eq(T, ρ), p = ρRᵐT) − θ₀ from the dry closed form
    T₁ = θ(ρRᵈθ/pˢᵗ)^(Rᵈ/cᵛᵈ) and T₁ + 1, which covers both branches
    (unsaturated cells partition to vapor alone)."""
    eq = scheme.equilibrium
    Ll = constants.liquid.reference_latent_heat
    Li = constants.ice.reference_latent_heat

    def residual(T):
        q = _density_partition(T, rho, qt, constants, eq)
        Rm = constants.mixture_gas_constant(q)
        cpm = constants.mixture_heat_capacity(q)
        p = rho * Rm * T
        return ((T - (Ll * q.liquid + Li * q.ice) / cpm) * (p_standard / p) ** (Rm / cpm)
                - theta_li)

    Rd = constants.Rd
    cvd = constants.dry_air.heat_capacity - Rd
    T1 = theta_li * (rho * Rd * theta_li / p_standard) ** (Rd / cvd)
    T = _secant(residual, T1, T1 + 1.0, max(scheme.iterations + 2, 7))
    q = _density_partition(T, rho, qt, constants, eq)
    return T, q, rho * constants.mixture_gas_constant(q) * T


def density_saturation_adjust_static_energy(e, z, rho, qt,
                                            constants: ThermodynamicConstants,
                                            scheme: SaturationAdjustment):
    """``(T, q, p)`` at density ρ from (e, qᵗ): the secant on the fixed
    point T = (e − gz + ℒˡqˡ(T) + ℒⁱqⁱ(T))/cᵖᵐ(q(T)) from the all-vapor
    T₁ and T₁ + 1, taken only where qᵗ exceeds qᵛ⁺(T₁); p = ρRᵐT."""
    eq = scheme.equilibrium
    partition = lambda T: _density_partition(T, rho, qt, constants, eq)
    residual = lambda T: T - temperature_from_static_energy(e, z, partition(T), constants)
    q1 = MoistureMassFractions.vapor_only(qt)
    T1 = temperature_from_static_energy(e, z, q1, constants)
    saturated = qt > saturation_specific_humidity(T1, rho, constants, eq.liquid_fraction(T1))
    Tb = _secant(residual, T1, T1 + 1.0, max(scheme.iterations + 2, 7))
    q_sat = partition(Tb)
    T = torch.where(saturated, Tb, T1)
    q = MoistureMassFractions(torch.where(saturated, q_sat.vapor, q1.vapor),
                              torch.where(saturated, q_sat.liquid, 0.0),
                              torch.where(saturated, q_sat.ice, 0.0))
    return T, q, rho * constants.mixture_gas_constant(q) * T


def density_temperature_inversion(theta_li, rho, q: MoistureMassFractions, constants,
                                  p_standard: float = 1.0e5, iterations: int = 5):
    """``(T, p)`` from θˡⁱ at a fixed partition q and density ρ: the secant
    on (T − ℒq/cᵖᵐ)(pˢᵗ/ρRᵐT)^(Rᵐ/cᵖᵐ) − θ₀ from T₁ = θ(ρRᵐθ/pˢᵗ)^(Rᵐ/cᵛᵐ)
    and T₁ + 1, ``iterations`` + 1 trips."""
    Rm = constants.mixture_gas_constant(q)
    cpm = constants.mixture_heat_capacity(q)
    kappa = Rm / cpm
    lheat = (constants.liquid.reference_latent_heat * q.liquid
             + constants.ice.reference_latent_heat * q.ice) / cpm
    residual = lambda T: (T - lheat) * (p_standard / (rho * Rm * T)) ** kappa - theta_li
    T1 = theta_li * (rho * Rm * theta_li / p_standard) ** (Rm / (cpm - Rm))
    T = _secant(residual, T1, T1 + 1.0, iterations + 1)
    return T, rho * Rm * T


def fix_negative_moisture(rho_q, dz_col):
    """Δz-weighted vertical borrowing of negative moisture (column integral
    ∫ρq dz conserved); ``dz_col`` the cell thickness column."""
    return fix_negative(rho_q, dz_col.reshape(-1))


def species_borrow(chain, rho_qve):
    """Same-level borrowing along ``chain`` (ρq arrays, heaviest first): each
    negative entry borrows from the next lighter species, the lightest from
    ``rho_qve``.  Returns ``(new_chain, new_rho_qve)``."""
    chain = list(chain)
    for i, heavy in enumerate(chain):
        light = chain[i + 1] if i + 1 < len(chain) else rho_qve
        sink = torch.where(heavy < 0.0,
                           torch.minimum(-heavy, torch.clamp(light, min=0.0)),
                           0.0)
        chain[i] = heavy + sink
        if i + 1 < len(chain):
            chain[i + 1] = light - sink
        else:
            rho_qve = light - sink
    return chain, rho_qve


def apply_negative_moisture_correction(model, state):
    """The negative-moisture repair at step start.  The port's state holds
    no hydrometeor tracers yet, so only the vertical borrowing of ρqᵗ
    runs."""
    if state.rho_qt is None:
        return state
    return state.replace(
        rho_qt=fix_negative_moisture(state.rho_qt, model.grid.dz_c_col))
