"""Coriolis: the f-plane.

Port of ``breeze_tpu/physics/coriolis.py``: the ``FPlane`` configuration,
and ``coriolis_terms`` on its traditional f-plane branch for the
compressible core.  The anelastic model evaluates the same terms inside the
fused tendency kernel.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FPlane:
    """f-plane: constant rotation about ẑ."""

    f: float = 1.0e-4


def coriolis_terms(coriolis, so, rho_u_pad, rho_v_pad, rho_w_pad):
    """(f×ρU)_x at u-points, (f×ρU)_y at v-points, (f×ρU)_z at w-points,
    to be *subtracted* from the momentum tendencies.  The transverse
    momentum is a 4-point average; ``so`` is a ``StencilOps`` over the
    padded momenta.  ``None`` gives zeros."""
    if coriolis is None:
        return 0.0, 0.0, 0.0
    f = coriolis.f
    v = so.v
    rv_u = 0.25 * (v(rho_v_pad) + v(rho_v_pad, dy=1)
                   + v(rho_v_pad, dx=-1) + v(rho_v_pad, dy=1, dx=-1))
    ru_v = 0.25 * (v(rho_u_pad) + v(rho_u_pad, dx=1)
                   + v(rho_u_pad, dy=-1) + v(rho_u_pad, dx=1, dy=-1))
    return -f * rv_u, f * ru_v, 0.0
