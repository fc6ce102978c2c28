"""WENO5 on whole arrays: the plain PyTorch side of ``csrc/weno.cuh``.

The plain versions of the stencil kernels (``tendency``, ``momentum``,
``advection``) share these, as their CUDA kernels share the header.
Windows are ``(nz+2H, ny+2H, nx)``, padded in z and y by ``fields.pad``;
x stays unpadded and periodic.
"""

from __future__ import annotations

import torch

#: Halo of the padded windows in z and y.
H = 3


def _sq(t):
    return t * t


def weno5(q, normalize: bool):
    """WENO5-JS from the upwind-selected cells ``q = (q₋₂ … q₂)``.

    Common-denominator weights (ratios as the classic 0.1/(β+ε)² form).
    ``normalize`` max-normalizes them with a 1e-9 floor so that the pair
    products stay in float32 range for large fields (scalars); momentum
    skips it (velocities ≲ 3e2 keep an order of magnitude of margin).
    """
    qm2, qm1, q0, q1, q2 = q
    p0 = (2.0 * qm2 - 7.0 * qm1 + 11.0 * q0) * (1.0 / 6.0)
    p1 = (-qm1 + 5.0 * q0 + 2.0 * q1) * (1.0 / 6.0)
    p2 = (2.0 * q0 + 5.0 * q1 - q2) * (1.0 / 6.0)
    b0 = (13.0 / 12.0) * _sq(qm2 - 2.0 * qm1 + q0) + 0.25 * _sq(qm2 - 4.0 * qm1 + 3.0 * q0)
    b1 = (13.0 / 12.0) * _sq(qm1 - 2.0 * q0 + q1) + 0.25 * _sq(qm1 - q1)
    b2 = (13.0 / 12.0) * _sq(q0 - 2.0 * q1 + q2) + 0.25 * _sq(3.0 * q0 - 4.0 * q1 + q2)
    e0, e1, e2 = b0 + 1e-6, b1 + 1e-6, b2 + 1e-6
    if normalize:
        inv_m = 1.0 / torch.maximum(e0, torch.maximum(e1, e2))
        e0 = torch.clamp(e0 * inv_m, min=1e-9)
        e1 = torch.clamp(e1 * inv_m, min=1e-9)
        e2 = torch.clamp(e2 * inv_m, min=1e-9)
    a0 = 0.1 * _sq(e1 * e2)
    a1 = 0.6 * _sq(e0 * e2)
    a2 = 0.3 * _sq(e0 * e1)
    return (a0 * p0 + a1 * p1 + a2 * p2) / (a0 + a1 + a2)


def weno_sel(cell, sign, normalize: bool):
    """Upwind WENO5 at an interface: ``cell(o)`` is the cell at offset o
    from the interface's left cell; ``sign >= 0`` selects the left-biased
    stencil, else the mirrored one ``cell(1 - o)``."""
    up = sign >= 0
    return weno5([torch.where(up, cell(o), cell(1 - o))
                  for o in (-2, -1, 0, 1, 2)], normalize)


def xs(a, o):
    """``xs(a, o)[..., i] = a[..., (i + o) mod nx]`` (periodic x)."""
    return torch.roll(a, -o, 2) if o % a.shape[2] else a


def sl(a, z0, nzr, y0, nyr):
    """Rows ``z0 .. z0+nzr`` and ``y0 .. y0+nyr`` of a window, counted from
    its interior."""
    return a[H + z0: H + z0 + nzr, H + y0: H + y0 + nyr]
