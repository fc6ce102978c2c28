"""Coriolis: the f-plane and the β-plane.

Port of ``breeze_tpu/physics/coriolis.py``: the ``FPlane`` and ``BetaPlane``
configurations and ``coriolis_terms`` on its traditional branches, the
f-plane (for the compressible core) and f(y) ẑ × U (for the anelastic model
outside the fused tendency kernel, which evaluates the f-plane terms
itself).  The other Coriolis types are not ported.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FPlane:
    """f-plane: constant rotation about ẑ."""

    f: float = 1.0e-4


@dataclasses.dataclass(frozen=True)
class BetaPlane:
    """f = f0 + β (y − y0)."""

    f0: float = 1.0e-4
    beta: float = 0.0
    y0: float = 0.0


def _f_at(coriolis, y):
    if isinstance(coriolis, FPlane):
        return coriolis.f
    if isinstance(coriolis, BetaPlane):
        return coriolis.f0 + coriolis.beta * (y - coriolis.y0)
    raise TypeError(coriolis)


def coriolis_terms(coriolis, so, rho_u_pad, rho_v_pad, rho_w_pad, grid=None):
    """(f×ρU)_x at u-points, (f×ρU)_y at v-points, (f×ρU)_z at w-points,
    to be *subtracted* from the momentum tendencies.  The transverse
    momentum is a 4-point average; ``so`` is a ``StencilOps`` over the
    padded momenta.  ``None`` gives zeros.  A :class:`BetaPlane` needs the
    ``grid``: f at y-centers multiplies the u-point term, f at y-faces the
    v-point term."""
    if coriolis is None:
        return 0.0, 0.0, 0.0
    if not isinstance(coriolis, (FPlane, BetaPlane)):
        raise NotImplementedError(f"Coriolis {coriolis!r} is not ported yet")
    v = so.v
    rv_u = 0.25 * (v(rho_v_pad) + v(rho_v_pad, dy=1)
                   + v(rho_v_pad, dx=-1) + v(rho_v_pad, dy=1, dx=-1))
    ru_v = 0.25 * (v(rho_u_pad) + v(rho_u_pad, dx=1)
                   + v(rho_u_pad, dy=-1) + v(rho_u_pad, dx=1, dy=-1))
    if isinstance(coriolis, FPlane):
        f_c = f_f = coriolis.f
    else:
        col = lambda y: torch.as_tensor(y, dtype=grid.dtype, device=grid.device)[None, :, None]
        f_c = _f_at(coriolis, col(grid.y_c()))   # at y-centers (u-points)
        f_f = _f_at(coriolis, col(grid.y_f()))   # at y-faces (v-points)
    return -f_c * rv_u, f_f * ru_v, 0.0
