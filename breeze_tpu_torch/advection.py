"""Advection scheme configuration.

Port of ``breeze_tpu/advection.py::WENO`` (the config only).  The WENO5
reconstructions themselves live in the fused tendency kernel
(``kernels/tendency.py``), the only advection path the port has so far.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WENO:
    """WENO reconstruction of odd ``order``; ``bounds_preserving`` clips
    each interface value to the hull of its adjacent cells."""

    order: int = 5
    epsilon: float = 1e-6
    bounds_preserving: bool = False

    @property
    def required_halo(self):
        return (self.order + 1) // 2
