"""The anelastic pressure projection's stencil passes: the projection kernels.

Replaces ``breeze_tpu/pallas_kernels/projection.py``: ``divergence_pallas``
(the ``pl.pallas_call`` in ``_run_div``) and ``gradient_correct_pallas``
(the ``pl.pallas_call`` in ``_run_grad``).  Around the Poisson solve they
compute, on unpadded fields with periodic x and y and a bounded z,

- δ = ∇·(ρu) at centers, with the top face's ρw flux zero;
- ρu ← ρu − Δt ρᵣ∇φ with ρᵣ at each component's location and the bottom
  face of ρw pinned to zero (so no wall enforcement follows).

1/Δz enters as a column (stretched z works); Δt is a runtime argument.

On the H100 both are bound by device memory (pure streaming, ``csrc/
projection.cu`` has the numbers).  The design: one thread per point with x
fastest, neighbours read through modular x and y indices and the z walls
as conditions, so no padded window is built.

``divergence`` and ``gradient_correct`` run their plain versions for CPU
tensors and the CUDA kernels for CUDA tensors.
"""

from __future__ import annotations

import torch

from . import _build

#: Times each CUDA kernel was launched (the plain versions do not count).
div_launches = 0
grad_launches = 0


def divergence_plain(ru, rv, rw, invdzc, inv_dx: float, inv_dy: float):
    """The divergence kernel on whole arrays.  Arguments as
    :func:`divergence`."""
    rw_top = torch.cat([rw[1:], torch.zeros_like(rw[:1])], 0)
    return ((torch.roll(ru, -1, 2) - ru) * inv_dx
            + (torch.roll(rv, -1, 1) - rv) * inv_dy
            + (rw_top - rw) * invdzc[:, None, None])


def divergence(ru, rv, rw, invdzc, inv_dx: float, inv_dy: float):
    """δ = ∇·(ρu) at centers, ``(nz, ny, nx)``, from ρu, ρv, ρw on their
    faces ``(nz, ny, nx)`` and 1/Δz at centers ``(nz,)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global div_launches
    if ru.device.type == "cpu":
        return divergence_plain(ru, rv, rw, invdzc, inv_dx, inv_dy)
    nz, ny, nx = ru.shape
    for name, t in (("ru", ru), ("rv", rv), ("rw", rw)):
        _build.require_cuda(name, t, ru.shape)
    _build.require_cuda("invdzc", invdzc, (nz,))
    out = torch.empty_like(ru)
    _build.launch("breeze_divergence", [ru, rv, rw, invdzc, out], [nz, ny, nx],
                  [inv_dx, inv_dy], ru)
    div_launches += 1
    return out


def gradient_correct_plain(phi, ru, rv, rw, rhoc, rhof, invdzf,
                           inv_dx: float, inv_dy: float, dt: float):
    """The gradient-correction kernel on whole arrays.  Arguments as
    :func:`gradient_correct`."""
    col = lambda c: c[:, None, None]
    ru_o = ru - dt * col(rhoc) * (phi - torch.roll(phi, 1, 2)) * inv_dx
    rv_o = rv - dt * col(rhoc) * (phi - torch.roll(phi, 1, 1)) * inv_dy
    dzphi = (phi - torch.cat([phi[:1], phi[:-1]], 0)) * col(invdzf)
    rw_o = rw - dt * col(rhof) * dzphi
    rw_o[0] = 0.0
    return ru_o, rv_o, rw_o


def gradient_correct(phi, ru, rv, rw, rhoc, rhof, invdzf,
                     inv_dx: float, inv_dy: float, dt: float):
    """``(ρu, ρv, ρw) − Δt ρᵣ∇φ`` with the bottom face of ρw pinned.

    - ``phi``: the pressure potential at centers; ``ru``, ``rv``, ``rw``:
      the momenta on their faces, all ``(nz, ny, nx)``;
    - ``rhoc``, ``rhof``: ρᵣ at centers and at the stored faces, ``invdzf``:
      1/Δz at the stored faces, each ``(nz,)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global grad_launches
    if phi.device.type == "cpu":
        return gradient_correct_plain(phi, ru, rv, rw, rhoc, rhof, invdzf,
                                      inv_dx, inv_dy, dt)
    nz, ny, nx = phi.shape
    for name, t in (("phi", phi), ("ru", ru), ("rv", rv), ("rw", rw)):
        _build.require_cuda(name, t, phi.shape)
    for name, t in (("rhoc", rhoc), ("rhof", rhof), ("invdzf", invdzf)):
        _build.require_cuda(name, t, (nz,))
    outs = [torch.empty_like(phi) for _ in range(3)]
    _build.launch("breeze_gradient_correct", [phi, ru, rv, rw, rhoc, rhof, invdzf, *outs],
                  [nz, ny, nx], [inv_dx, inv_dy, dt], phi)
    grad_launches += 1
    return tuple(outs)
