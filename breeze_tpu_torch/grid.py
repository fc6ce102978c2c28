"""Rectilinear staggered (Arakawa C) grid.

Port of ``breeze_tpu/grid.py`` (``Topology``, ``Grid``, ``make_grid``).
Arrays are laid out ``(z, y, x)`` with x contiguous; face ``i`` is the
lower edge of cell ``i`` and face-located fields store faces ``0..N-1``
(the upper wall face of a bounded axis is implicit).

The grid carries its ``dtype`` and ``device`` explicitly: every tensor a
model builds from it lives there.  The spacings are kept twice, as float64
host tuples (``dz_c_meta``, ``dz_f_meta``, for host-side set-up of columns)
and as tensors in the field dtype on the device.  Halo widths are chosen by
each caller of ``fields.pad``, so the grid carries none.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class Topology(enum.Enum):
    PERIODIC = "periodic"
    BOUNDED = "bounded"


PERIODIC = Topology.PERIODIC
BOUNDED = Topology.BOUNDED


@dataclasses.dataclass(frozen=True)
class Grid:
    """A rectilinear grid, uniform in x and y, possibly stretched in z.

    - ``z_c[k]``: height of cell center ``k`` (``(nz,)``)
    - ``z_f[k]``: height of face ``k`` (``(nz+1,)``)
    - ``dz_c[k] = z_f[k+1] - z_f[k]`` (``(nz,)``)
    - ``dz_f[k] = z_c[k] - z_c[k-1]``, ends closed by the half cells
      (``(nz+1,)``)
    """

    nx: int
    ny: int
    nz: int
    x_topology: Topology
    y_topology: Topology
    z_topology: Topology
    x0: float
    y0: float
    z0: float
    Lx: float
    Ly: float
    Lz: float
    dx: float
    dy: float
    dtype: torch.dtype
    device: torch.device
    dz_c_meta: tuple
    dz_f_meta: tuple
    z_c: torch.Tensor
    z_f: torch.Tensor
    dz_c: torch.Tensor
    dz_f: torch.Tensor

    @property
    def shape(self) -> tuple[int, int, int]:
        """Field shape ``(nz, ny, nx)``."""
        return (self.nz, self.ny, self.nx)

    @property
    def dz_c_col(self) -> torch.Tensor:
        return self.dz_c[:, None, None]

    @property
    def dz_f_col(self) -> torch.Tensor:
        """``dz_f[0:nz]`` (the stored w faces) as a column."""
        return self.dz_f[: self.nz, None, None]

    @property
    def z_c_col(self) -> torch.Tensor:
        return self.z_c[:, None, None]

    @property
    def z_f_col(self) -> torch.Tensor:
        return self.z_f[: self.nz, None, None]

    def host(self, t: torch.Tensor) -> np.ndarray:
        """A grid tensor as float64 numpy, keeping its dtype rounding."""
        return t.detach().cpu().numpy().astype(np.float64)

    def x_c(self) -> np.ndarray:
        return self.x0 + (np.arange(self.nx) + 0.5) * self.dx

    def y_c(self) -> np.ndarray:
        return self.y0 + (np.arange(self.ny) + 0.5) * self.dy

    def y_f(self) -> np.ndarray:
        return self.y0 + np.arange(self.ny) * self.dy

    def xyz_c(self):
        """Cell-center coordinates broadcastable to ``(nz, ny, nx)``."""
        kw = dict(dtype=self.dtype, device=self.device)
        x = torch.as_tensor(self.x_c(), **kw)[None, None, :]
        y = torch.as_tensor(self.y_c(), **kw)[None, :, None]
        return x, y, self.z_c_col

    def topologies(self) -> tuple[Topology, Topology, Topology]:
        """Topologies in array-axis order (z, y, x)."""
        return (self.z_topology, self.y_topology, self.x_topology)


def make_grid(size, extent=None, x=None, y=None, z=None,
              topology=(PERIODIC, PERIODIC, BOUNDED), *,
              dtype: torch.dtype, device) -> Grid:
    """Build a :class:`Grid` (``breeze_tpu.grid.make_grid``).

    ``size`` is ``(nx, ny, nz)``; ``extent`` ``(Lx, Ly, Lz)`` from the origin,
    or ``x``/``y`` intervals and ``z`` as an interval or ``nz+1`` face
    heights.  ``dtype`` and ``device`` are required: the port never picks a
    device by itself.
    """
    nx, ny, nz = size
    if extent is not None:
        x = (0.0, float(extent[0]))
        y = (0.0, float(extent[1]))
        if z is None:
            z = (0.0, float(extent[2]))
    if x is None or y is None or z is None:
        raise ValueError("give extent, or all of x, y and z")
    tx, ty, tz = topology
    x0, x1 = float(x[0]), float(x[1])
    y0, y1 = float(y[0]), float(y[1])

    if isinstance(z, (tuple, list)) and len(z) == 2 and np.isscalar(z[0]):
        z_f = np.linspace(float(z[0]), float(z[1]), nz + 1, dtype=np.float64)
    else:
        z_f = np.asarray(z, dtype=np.float64)
        if z_f.shape != (nz + 1,):
            raise ValueError("stretched z must provide nz+1 face heights")
    z_c = 0.5 * (z_f[1:] + z_f[:-1])
    dz_c = np.diff(z_f)
    dz_f = np.empty(nz + 1, dtype=np.float64)
    dz_f[1:nz] = z_c[1:] - z_c[:-1]
    dz_f[0] = dz_c[0]
    dz_f[nz] = dz_c[-1]

    device = torch.device(device)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return Grid(
        nx=nx, ny=ny, nz=nz,
        x_topology=tx, y_topology=ty, z_topology=tz,
        x0=x0, y0=y0, z0=float(z_f[0]),
        Lx=x1 - x0, Ly=y1 - y0, Lz=float(z_f[-1] - z_f[0]),
        dx=(x1 - x0) / nx, dy=(y1 - y0) / ny,
        dtype=dtype, device=device,
        dz_c_meta=tuple(float(v) for v in dz_c),
        dz_f_meta=tuple(float(v) for v in dz_f),
        z_c=as_t(z_c), z_f=as_t(z_f), dz_c=as_t(dz_c), dz_f=as_t(dz_f),
    )
