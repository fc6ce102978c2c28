"""Prescribed surface fluxes.

Port of ``breeze_tpu/physics/surface.py::PrescribedSurfaceFluxes`` and the
anelastic flux-BC tendencies: a kinematic flux F through the bottom wall
becomes ``ρ₀F/Δz₀`` on the wall-adjacent cells.  Time-dependent fluxes,
the bulk-coefficient drag, the bulk formulae and the filtered surface state
are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PrescribedSurfaceFluxes:
    """Constant kinematic surface fluxes.

    - ``theta_flux``: w'θ' [K m/s]; ``qt_flux``: w'qᵗ' [m/s]
    - ``friction_velocity``: u*, for the drag −u*² u₁/|U₁| (None: free slip)
    """

    theta_flux: float = 0.0
    qt_flux: float = 0.0
    friction_velocity: float | None = None
    gustiness: float = 0.1


def surface_flux_values(bf: PrescribedSurfaceFluxes, aux, want_moisture: bool):
    """``(F_theta, F_qt, F_u, F_v)`` through the bottom wall; ``None``
    means no flux of that quantity."""
    if bf.friction_velocity is None:
        F_u = F_v = None
    else:
        u1 = aux.u[0]
        v1 = aux.v[0]
        speed = torch.sqrt(u1 * u1 + v1 * v1 + bf.gustiness ** 2)
        ustar2 = bf.friction_velocity ** 2
        F_u = -ustar2 * u1 / speed
        F_v = -ustar2 * v1 / speed
    return bf.theta_flux, bf.qt_flux if want_moisture else None, F_u, F_v


def apply_boundary_flux_tendencies(model, aux, fields: dict, scale):
    """Add ``scale``·(surface-flux tendency) to the bottom rows of
    ``fields`` (name → tensor, updated in place).

    ``scale`` is 1 for a tendency and αΔt when ``fields`` holds stage-blended
    prognostics (the extras on top of the fused kernel's output).
    """
    bf = model.boundary_fluxes
    if not isinstance(bf, PrescribedSurfaceFluxes):
        raise NotImplementedError(f"boundary fluxes {bf!r} are not ported yet")
    dz0 = model.grid.dz_c[0]
    rho0 = model.reference.rho_c[0]
    th_flux, qt_flux, F_u, F_v = surface_flux_values(
        bf, aux, want_moisture="rho_qt" in fields)
    rows = {"rho_theta": th_flux, "rho_qt": qt_flux, "rho_u": F_u, "rho_v": F_v}
    for name, flux in rows.items():
        if flux is not None and name in fields:
            fields[name][0] += scale * (rho0 * flux / dz0)
