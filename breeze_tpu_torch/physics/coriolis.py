"""Coriolis configuration.

Port of ``breeze_tpu/physics/coriolis.py::FPlane``.  The f × ρU terms (4-point
averages of the transverse momentum) are evaluated inside the fused tendency
kernel.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FPlane:
    """f-plane: constant rotation about ẑ."""

    f: float = 1.0e-4
