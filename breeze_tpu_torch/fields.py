"""Field locations and halo padding.

Port of ``breeze_tpu/fields.py``.  Fields are plain ``(nz, ny, nx)``
tensors; location (Center/Face per axis) is metadata, and :func:`pad` returns
a halo-padded copy by the topology + location rules:

- ``PERIODIC``: wrap-around;
- ``BOUNDED`` center: even mirror about the wall face;
- ``BOUNDED`` face (wall-normal velocity): odd reflection about the wall
  faces, with the upper wall face itself carrying 0.
"""

from __future__ import annotations

import enum

import torch

from .grid import Grid, Topology


class Loc(enum.Enum):
    CENTER = "c"
    FACE = "f"


C = Loc.CENTER
F = Loc.FACE

# Standard staggered locations, in (z, y, x) axis order.
CCC = (C, C, C)   # scalars, pressure
CCF = (C, C, F)   # u, rho_u (x-face)
CFC = (C, F, C)   # v, rho_v (y-face)
FCC = (F, C, C)   # w, rho_w (z-face)


def pad_axis(a: torch.Tensor, axis: int, h: int, topo: Topology,
             loc: Loc) -> torch.Tensor:
    if h == 0:
        return a
    n = a.shape[axis]
    sl = lambda lo, hi: a.narrow(axis, lo, hi - lo)
    if topo == Topology.PERIODIC:
        return torch.cat([sl(n - h, n), a, sl(0, h)], dim=axis)
    if loc == Loc.CENTER:
        return torch.cat([sl(0, h).flip(axis), a, sl(n - h, n).flip(axis)],
                         dim=axis)
    # odd reflection about faces 0 and n: -a[h..1], a, 0, -a[n-1..n-h+1]
    wall = torch.zeros_like(sl(0, 1))
    return torch.cat([-sl(1, h + 1).flip(axis), a, wall,
                      -sl(n - h + 1, n).flip(axis)], dim=axis)


def pad(a: torch.Tensor, grid: Grid, loc, halo: int,
        axes=(0, 1, 2)) -> torch.Tensor:
    """Pad ``a`` by ``halo`` on ``axes`` using the topology + location rules."""
    topos = grid.topologies()
    out = a
    for ax in axes:
        out = pad_axis(out, ax, halo, topos[ax], loc[ax])
    return out


def enforce_wall_normals(grid: Grid, rho_u, rho_v, rho_w):
    """Zero ρw on the bottom wall face of a bounded z (stored face 0; the
    top one is implicit), leaving the inputs untouched.  The port's models
    are periodic in x and y, so ρu and ρv pass through."""
    if grid.z_topology == Topology.BOUNDED:
        rho_w = rho_w.clone()
        rho_w[0] = 0.0
    return rho_u, rho_v, rho_w
