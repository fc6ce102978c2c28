"""Subgrid closure configuration.

Port of ``breeze_tpu/physics/closures.py::SmagorinskyLilly`` (the config
only).  The stress and diffusive-flux divergences are the epilogue of the
fused tendency kernel (``kernels/tendency.py``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SmagorinskyLilly:
    """Smagorinsky (1963) with Lilly's stratification correction:
    νₑ = (C Δ)² √(2 SᵢⱼSᵢⱼ) ς,  ς² = max(0, 1 − N²/(Pr |S|²)),  κₑ = νₑ/Pr."""

    coefficient: float = 0.16
    prandtl: float = 1.0 / 3.0
    buoyancy_correction: bool = True
