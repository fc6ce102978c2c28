"""The compressible dry bubble over a ridge in σ-coordinates.

The configuration ``bench.py --dynamics compressible --terrain`` measures for
``breeze_tpu``, built through the port: the bubble of ``bubble.py`` (a
12.8 km × 12.8 km × 3.2 km domain, periodic in x and y, WENO5, an f-plane
with f = 1e-4 s⁻¹, split-explicit stepping with the acoustic CFL 0.5 and the
default thermal divergence damping, float32) over a Schär-type ridge,

    h(x) = 250 · exp(−((x − 6400)/5000)²) · cos²(π(x − 6400)/4000) m,

uniform in y, in Gal-Chen σ-coordinates (``make_terrain``'s LinearDecay
default, its hydrostatic reference at 300 K).  The state is the bubble's:
θ = 300 K plus a 0.5 K Gaussian of 500 m at (6400, 6400, 800) m in the
computational coordinates, the density pressure-balanced against the flat
reference column, at rest, as the benchmark starts it.

On another extent the ridge keeps its shape: it is centred in x, its
widths scale with Lx/12800 and its height with Lz/3200, so that its slopes
are the benchmark's wherever Lx/Lz is.
"""

from __future__ import annotations

import numpy as np
import torch

from .advection import WENO
from .bubble import EXTENT, bubble_state
from .dynamics.compressible import (CompressibleModel, CompressibleState,
                                    SplitExplicitTimeDiscretization,
                                    make_compressible_model)
from .dynamics.terrain import make_terrain
from .grid import BOUNDED, PERIODIC, make_grid
from .physics.coriolis import FPlane
from .thermo.constants import ThermodynamicConstants


def ridge_elevation(x0: float, Lx: float, Lz: float, y0: float = 0.0, Ly: float = 1.0,
                    y_amplitude: float = 0.0):
    """The ridge's h(x, y) over a domain from ``x0`` of length ``Lx`` and
    height ``Lz``, as a callable of numpy coordinates.  ``y_amplitude``
    makes it vary in y by the factor (1 + a·sin(2π(y − y0)/Ly)), as the
    parity checks need (the benchmark's is 0)."""
    sx, sz, xc = Lx / EXTENT[0], Lz / EXTENT[2], x0 + 0.5 * Lx

    def h(x, y):
        out = (250.0 * sz * np.exp(-((x - xc) / (5000.0 * sx)) ** 2)
               * np.cos(np.pi * (x - xc) / (4000.0 * sx)) ** 2)
        return out * (1.0 + y_amplitude * np.sin(2.0 * np.pi * (y - y0) / Ly))

    return h


def ridge_model(size, *, dtype: torch.dtype = torch.float32, device="cuda",
                extent=EXTENT, y_amplitude: float = 0.0, sponge=None,
                **terrain_kw) -> CompressibleModel:
    """The ridge model on an ``(nx, ny, nz)`` grid over ``extent``.
    ``y_amplitude``, ``sponge`` (an ``UpperSponge``) and ``terrain_kw``
    (``make_terrain``'s, e.g. the SLEVE scale heights) vary it for the
    kernel checks; the defaults are the benchmark's."""
    grid = make_grid(size, extent=extent, topology=(PERIODIC, PERIODIC, BOUNDED),
                     dtype=dtype, device=device)
    constants = ThermodynamicConstants()
    terrain = make_terrain(grid, constants,
                           ridge_elevation(grid.x0, grid.Lx, grid.Lz, grid.y0, grid.Ly,
                                           y_amplitude), **terrain_kw)
    return make_compressible_model(
        grid, constants=constants, advection=WENO(5), coriolis=FPlane(1e-4),
        terrain=terrain,
        time_discretization=SplitExplicitTimeDiscretization(acoustic_cfl=0.5, sponge=sponge))


def ridge_state(model: CompressibleModel) -> CompressibleState:
    """The benchmark's start: the bubble in θ over the flat reference
    column, pressure-balanced, at rest."""
    return bubble_state(model)
