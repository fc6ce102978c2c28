"""The warm bubble on the split-explicit compressible core, dry or moist.

The configuration ``bench.py --dynamics compressible`` measures for
``breeze_tpu``, built through the port: a 12.8 km × 12.8 km × 3.2 km domain
(the FastEddy convective boundary layer's), periodic in x and y, WENO5, an
f-plane (f = 1e-4 s⁻¹), split-explicit stepping with the acoustic CFL 0.5
and the default thermal divergence damping, float32.  θ = 300 K plus a
0.5 K Gaussian bubble of 500 m radius at (Lx/2, Ly/2, Lz/4), which is the
benchmark's (6400, 6400, 800) m; the density is pressure-balanced.

Its variants, each a ``bench.py`` or ``tools/`` configuration of the JAX
package:

- ``moist=True`` (``bench.py --moist``): warm saturation adjustment and
  qᵗ = 0.008·exp(−z/1500 m);
- ``formulation="static_energy"`` with ``damping=DirectDivergenceDamping(0.1)``
  (``tools/tpu_check_k3_envelope.py``'s ``rhoe+direct``): ρe for ρθ and the
  direct divergence damping for the thermal;
- ``substep_floattype="bfloat16"`` (``bench.py --substep-floattype
  bfloat16``): the acoustic carries stored in bfloat16;
- ``per_substep_kernels=True`` (``bench.py --dynamics compressible`` with
  ``BREEZE_TPU_PALLAS_ACOUSTIC_SPLIT=1``): the substeps through the kernel
  pair K1/K2, dry or with bfloat16 carries.
"""

from __future__ import annotations

import torch

from .advection import WENO
from .dynamics.compressible import (CompressibleModel, CompressibleState,
                                    SplitExplicitTimeDiscretization,
                                    compressible_initial_state,
                                    make_compressible_model)
from .grid import BOUNDED, PERIODIC, make_grid
from .physics.coriolis import FPlane
from .physics.microphysics import SaturationAdjustment
from .thermo.saturation import WarmPhaseEquilibrium

EXTENT = (12_800.0, 12_800.0, 3_200.0)


def bubble_model(size, *, dtype: torch.dtype = torch.float32, device="cuda",
                 extent=EXTENT, moist: bool = False,
                 formulation: str = "potential_temperature", damping=None,
                 substep_floattype: str | None = None,
                 per_substep_kernels: bool = False) -> CompressibleModel:
    """The bubble model on an ``(nx, ny, nz)`` grid over ``extent``;
    ``damping`` a divergence-damping strategy, which replaces the default
    thermal damping."""
    grid = make_grid(size, extent=extent, topology=(PERIODIC, PERIODIC, BOUNDED),
                     dtype=dtype, device=device)
    td = SplitExplicitTimeDiscretization(
        acoustic_cfl=0.5, substep_floattype=substep_floattype, damping=damping,
        per_substep_kernels=per_substep_kernels,
        **({} if damping is None else {"damping_coefficient": 0.0}))
    return make_compressible_model(
        grid, advection=WENO(5), coriolis=FPlane(1e-4), time_discretization=td,
        formulation=formulation,
        microphysics=SaturationAdjustment(WarmPhaseEquilibrium()) if moist else None)


def bubble_state(model: CompressibleModel) -> CompressibleState:
    """The initial state: the bubble in θ, pressure-balanced density, at
    rest; with moisture qᵗ = 0.008·exp(−z/1500 m)."""
    g = model.grid
    cx, cy, cz = g.x0 + 0.5 * g.Lx, g.y0 + 0.5 * g.Ly, g.z0 + 0.25 * g.Lz

    def theta(x, y, z):
        return 300.0 + 0.5 * torch.exp(-((x - cx) ** 2 + (y - cy) ** 2
                                         + (z - cz) ** 2) / 500.0 ** 2)

    def qt(x, y, z):
        return 0.008 * torch.exp(-z / 1500.0)

    return compressible_initial_state(model, theta=theta,
                                      qt=qt if model.has_moisture else None)
