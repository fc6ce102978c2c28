"""The dry warm bubble on the split-explicit compressible core.

The configuration ``bench.py --dynamics compressible`` measures for
``breeze_tpu``, built through the port: a 12.8 km × 12.8 km × 3.2 km domain
(the FastEddy convective boundary layer's), periodic in x and y, WENO5, an
f-plane (f = 1e-4 s⁻¹), split-explicit stepping with the acoustic CFL 0.5
and the default thermal divergence damping, float32.  θ = 300 K plus a
0.5 K Gaussian bubble of 500 m radius at (Lx/2, Ly/2, Lz/4), which is the
benchmark's (6400, 6400, 800) m; the density is pressure-balanced.
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

EXTENT = (12_800.0, 12_800.0, 3_200.0)


def bubble_model(size, *, dtype: torch.dtype = torch.float32, device="cuda",
                 extent=EXTENT) -> CompressibleModel:
    """The bubble model on an ``(nx, ny, nz)`` grid over ``extent``."""
    grid = make_grid(size, extent=extent, topology=(PERIODIC, PERIODIC, BOUNDED),
                     dtype=dtype, device=device)
    return make_compressible_model(
        grid, advection=WENO(5), coriolis=FPlane(1e-4),
        time_discretization=SplitExplicitTimeDiscretization(acoustic_cfl=0.5))


def bubble_state(model: CompressibleModel) -> CompressibleState:
    """The initial state: the bubble in θ, pressure-balanced density, at
    rest."""
    g = model.grid
    cx, cy, cz = g.x0 + 0.5 * g.Lx, g.y0 + 0.5 * g.Ly, g.z0 + 0.25 * g.Lz

    def theta(x, y, z):
        return 300.0 + 0.5 * torch.exp(-((x - cx) ** 2 + (y - cy) ** 2
                                         + (z - cz) ** 2) / 500.0 ** 2)

    return compressible_initial_state(model, theta=theta)
