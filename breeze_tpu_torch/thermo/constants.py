"""Thermodynamic constants and mixture laws for moist air.

Port of ``breeze_tpu/thermo/constants.py``.  Constants are Python floats in
frozen dataclasses; mixture laws act on tensors or floats alike.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class IdealGas:
    molar_mass: float = 0.02897        # kg / mol
    heat_capacity: float = 1005.0      # J / (kg K), at constant pressure


@dataclasses.dataclass(frozen=True)
class CondensedPhase:
    reference_latent_heat: float       # J / kg at the energy reference temperature
    heat_capacity: float               # J / (kg K)


def liquid_water() -> CondensedPhase:
    return CondensedPhase(reference_latent_heat=2_500_800.0, heat_capacity=4181.0)


def water_ice() -> CondensedPhase:
    return CondensedPhase(reference_latent_heat=2_834_000.0, heat_capacity=2108.0)


class MoistureMassFractions(NamedTuple):
    """Mass fractions of vapor / liquid / ice (tensors or floats)."""

    vapor: torch.Tensor | float
    liquid: torch.Tensor | float
    ice: torch.Tensor | float

    @classmethod
    def vapor_only(cls, qv):
        zero = torch.zeros_like(qv) if isinstance(qv, torch.Tensor) else 0.0
        return cls(qv, zero, zero)

    @property
    def total(self):
        return self.vapor + self.liquid + self.ice

    @property
    def dry(self):
        return 1.0 - self.total


@dataclasses.dataclass(frozen=True)
class ThermodynamicConstants:
    """Moist-air constants (defaults as ``breeze_tpu``)."""

    molar_gas_constant: float = 8.314462618
    gravitational_acceleration: float = 9.81
    energy_reference_temperature: float = 273.15
    triple_point_temperature: float = 273.16
    triple_point_pressure: float = 611.657
    dry_air: IdealGas = dataclasses.field(default_factory=IdealGas)
    vapor: IdealGas = dataclasses.field(
        default_factory=lambda: IdealGas(molar_mass=0.018015, heat_capacity=1850.0))
    liquid: CondensedPhase = dataclasses.field(default_factory=liquid_water)
    ice: CondensedPhase = dataclasses.field(default_factory=water_ice)
    saturation_formulation: str = "clausius_clapeyron"

    @property
    def Rd(self) -> float:
        return self.molar_gas_constant / self.dry_air.molar_mass

    @property
    def Rv(self) -> float:
        return self.molar_gas_constant / self.vapor.molar_mass

    @property
    def epsilon_dv(self) -> float:
        """Rd / Rv ≈ 0.622."""
        return self.Rd / self.Rv

    def specific_heat_difference(self, phase: CondensedPhase) -> float:
        return self.vapor.heat_capacity - phase.heat_capacity

    def absolute_zero_latent_heat(self, phase: CondensedPhase) -> float:
        return (phase.reference_latent_heat
                - self.specific_heat_difference(phase) * self.energy_reference_temperature)

    def mixture_gas_constant(self, q: MoistureMassFractions):
        """Rᵐ = qᵈ Rᵈ + qᵛ Rᵛ."""
        return q.dry * self.Rd + q.vapor * self.Rv

    def mixture_heat_capacity(self, q: MoistureMassFractions):
        """cᵖᵐ = qᵈ cᵖᵈ + qᵛ cᵖᵛ + qˡ cˡ + qⁱ cⁱ."""
        return (q.dry * self.dry_air.heat_capacity
                + q.vapor * self.vapor.heat_capacity
                + q.liquid * self.liquid.heat_capacity
                + q.ice * self.ice.heat_capacity)

    def density(self, T, p, q: MoistureMassFractions):
        """Moist ideal gas: ρ = p / (Rᵐ T)."""
        return p / (self.mixture_gas_constant(q) * T)
