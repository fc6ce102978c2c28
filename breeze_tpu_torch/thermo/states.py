"""Thermodynamic state relations: potential temperature → temperature.

Port of the part of ``breeze_tpu/thermo/states.py`` the liquid-ice
potential-temperature formulation needs.
"""

from __future__ import annotations

import torch

from .constants import MoistureMassFractions, ThermodynamicConstants

DEFAULT_STANDARD_PRESSURE = 1.0e5


def exner_function(p, q: MoistureMassFractions, constants: ThermodynamicConstants,
                   p_standard: float = DEFAULT_STANDARD_PRESSURE):
    """Moist Exner function Π = exp((Rᵐ/cᵖᵐ)·log(p/pˢᵗ)), with the log taken
    on ``p``'s own (column) shape."""
    Rm = constants.mixture_gas_constant(q)
    cpm = constants.mixture_heat_capacity(q)
    return torch.exp((Rm / cpm) * torch.log(p / p_standard))


def temperature_from_theta_li(theta_li, q: MoistureMassFractions, p,
                              constants: ThermodynamicConstants,
                              p_standard: float = DEFAULT_STANDARD_PRESSURE):
    """T = Π θˡⁱ + (ℒˡᵣ qˡ + ℒⁱᵣ qⁱ) / cᵖᵐ."""
    Pi = exner_function(p, q, constants, p_standard)
    cpm = constants.mixture_heat_capacity(q)
    Ll = constants.liquid.reference_latent_heat
    Li = constants.ice.reference_latent_heat
    return Pi * theta_li + (Ll * q.liquid + Li * q.ice) / cpm
