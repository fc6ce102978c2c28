"""Thermodynamic state relations: liquid-ice potential temperature and
moist static energy ↔ temperature.

Port of ``breeze_tpu/thermo/states.py``.
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


def theta_li_from_temperature(T, q: MoistureMassFractions, p,
                              constants: ThermodynamicConstants,
                              p_standard: float = DEFAULT_STANDARD_PRESSURE):
    """Inverse of :func:`temperature_from_theta_li`."""
    Pi = exner_function(p, q, constants, p_standard)
    cpm = constants.mixture_heat_capacity(q)
    Ll = constants.liquid.reference_latent_heat
    Li = constants.ice.reference_latent_heat
    return (T - (Ll * q.liquid + Li * q.ice) / cpm) / Pi


def static_energy(T, z, q: MoistureMassFractions, constants: ThermodynamicConstants):
    """Moist static energy e = cᵖᵐ T + g z − ℒˡᵣ qˡ − ℒⁱᵣ qⁱ."""
    cpm = constants.mixture_heat_capacity(q)
    return (cpm * T + constants.gravitational_acceleration * z
            - constants.liquid.reference_latent_heat * q.liquid
            - constants.ice.reference_latent_heat * q.ice)


def temperature_from_static_energy(e, z, q: MoistureMassFractions,
                                   constants: ThermodynamicConstants):
    """Inverse of :func:`static_energy` at fixed composition and height."""
    cpm = constants.mixture_heat_capacity(q)
    return (e - constants.gravitational_acceleration * z
            + constants.liquid.reference_latent_heat * q.liquid
            + constants.ice.reference_latent_heat * q.ice) / cpm
