"""The BOMEX case: Siebesma et al. (2003) trade-wind cumulus.

The configuration ``bench.py`` measures for ``breeze_tpu`` (its
``_build_bomex``), built through the port: a 6.4 km × 6.4 km × 3 km domain,
periodic in x and y, WENO5, warm saturation adjustment, Smagorinsky-Lilly
with the θᵥ correction, an f-plane, prescribed surface fluxes, and the
geostrophic, subsidence, drying and sponge forcings.

``coriolis=BETA_PLANE`` puts the case on BOMEX's β-plane, which takes the
anelastic route outside the fused tendency kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from .advection import WENO
from .grid import BOUNDED, PERIODIC, make_grid
from .model import AtmosphereModel, State, initial_state, make_model
from .physics.closures import SmagorinskyLilly
from .physics.coriolis import BetaPlane, FPlane
from .physics.forcings import (DrySubsidenceTendency, GeostrophicForcing,
                               SubsidenceForcing, UpperSponge)
from .physics.microphysics import SaturationAdjustment
from .physics.surface import PrescribedSurfaceFluxes

F_CORIOLIS = 3.76e-5
EXTENT = (6_400.0, 6_400.0, 3_000.0)
#: BOMEX's site on a β-plane: f₀ = 2Ω sin φ at φ ≈ 14.9°N, β = 2Ω cos φ / R,
#: the origin at the domain's centre
BETA_PLANE = BetaPlane(f0=F_CORIOLIS, beta=2.21e-11, y0=0.5 * EXTENT[1])


def subsidence_profile(z):
    return torch.where(z < 1500.0, -0.0065 * z / 1500.0,
                       torch.where(z < 2100.0, -0.0065 * (1 - (z - 1500.0) / 600.0),
                                   0.0 * z))


def drying_profile(z):
    return torch.where(z < 300.0, -1.2e-8 + 0.0 * z,
                       torch.where(z < 500.0, -1.2e-8 * (1 - (z - 300.0) / 200.0),
                                   0.0 * z))


def theta0(x, y, z):
    where = torch.where
    return where(z < 520.0, 298.7 + 0.0 * z,
           where(z < 1480.0, 298.7 + (z - 520.0) * (302.4 - 298.7) / 960.0,
           where(z < 2000.0, 302.4 + (z - 1480.0) * (308.2 - 302.4) / 520.0,
                 308.2 + (z - 2000.0) * 3.65e-3)))


def qt0(x, y, z):
    where = torch.where
    return where(z < 520.0, 17.0e-3 + z * (16.3e-3 - 17.0e-3) / 520.0,
           where(z < 1480.0, 16.3e-3 + (z - 520.0) * (10.7e-3 - 16.3e-3) / 960.0,
           where(z < 2000.0, 10.7e-3 + (z - 1480.0) * (4.2e-3 - 10.7e-3) / 520.0,
                 torch.clamp(4.2e-3 - (z - 2000.0) * 1.2e-6, min=1e-4))))


def u0(x, y, z):
    return torch.where(z < 700.0, -8.75 + 0.0 * z, -8.75 + (z - 700.0) * 1.8e-3)


def bomex_model(size, *, dtype: torch.dtype = torch.float32, device="cuda",
                coriolis=None) -> AtmosphereModel:
    """The BOMEX model on an ``(nx, ny, nz)`` grid over the BOMEX domain.
    ``coriolis`` ``None`` is the f-plane."""
    grid = make_grid(size, extent=EXTENT, topology=(PERIODIC, PERIODIC, BOUNDED),
                     dtype=dtype, device=device)
    return make_model(
        grid, advection=WENO(5), potential_temperature=298.7,
        surface_pressure=101_500.0,
        microphysics=SaturationAdjustment(),
        closure=SmagorinskyLilly(),
        coriolis=FPlane(f=F_CORIOLIS) if coriolis is None else coriolis,
        boundary_fluxes=PrescribedSurfaceFluxes(
            theta_flux=8.0e-3, qt_flux=5.2e-5, friction_velocity=0.28),
        forcings=(
            GeostrophicForcing(f=F_CORIOLIS, u_g=lambda z: -10.0 + 1.8e-3 * z,
                               v_g=0.0),
            SubsidenceForcing(w_profile=subsidence_profile),
            DrySubsidenceTendency(tendency_profile=drying_profile),
            UpperSponge(rate=0.05, bottom=2400.0),
        ))


def bomex_state(model: AtmosphereModel, noise: np.ndarray) -> State:
    """The BOMEX initial state with ``noise`` (a ``(nz, ny, nx)`` numpy
    array, e.g. 0.1·N(0, 1)) added to θ, damped as exp(−z/500 m)."""
    g = model.grid
    state = initial_state(model, theta=theta0, qt=qt0, u=u0)
    noise = torch.as_tensor(noise, dtype=g.dtype, device=g.device)
    damp = torch.exp(-g.z_c_col / 500.0)
    return state.replace(
        rho_theta=state.rho_theta + model.reference.rho_col * noise * damp)
