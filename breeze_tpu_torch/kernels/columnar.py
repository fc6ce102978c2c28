"""Negative-moisture vertical borrowing: the fix-negative kernel.

Replaces ``breeze_tpu/pallas_kernels/columnar.py::fix_negative_moisture_pallas``
(the ``pl.pallas_call`` in ``_run_fix_negative``).

Per column, in mass-per-area units m = ρq·Δz (so ∫ρq dz is conserved on a
stretched grid), a top→bottom recurrence pushes each level's deficit down:

    newⱼ = mⱼ + carry,  outⱼ = max(newⱼ, 0),  carry = min(newⱼ, 0)

then the bottom level absorbs the carry and borrows min(needed, available)
from level 1.  A residual negative (column integral < 0) stays.

On the H100 the kernel is bound by device memory: one read and one write of
the field (≈134 MB at 256³ in float32), no arithmetic to speak of.  The
design is one thread per (y, x) column running the recurrence in registers
from top to bottom, with neighbouring threads on neighbouring x so that
every level's load and store is coalesced.  The TPU kernel's log-depth
suffix scans were a workaround for the TPU's vector unit and are not needed.

``fix_negative`` runs the plain PyTorch version for a CPU tensor and the CUDA
kernel (``csrc/columnar.cu``) for a CUDA tensor.
"""

from __future__ import annotations

import torch

from . import _build

#: Times the CUDA kernel was launched (the plain version does not count).
launches = 0


def fix_negative_plain(rho_q: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """The kernel's math on whole arrays: ``rho_q`` ``(nz, ny, nx)``, ``dz``
    the cell thickness column ``(nz,)``."""
    nz = rho_q.shape[0]
    if nz == 1:
        return rho_q.clone()
    dzc = dz[:, None, None]
    m = rho_q * dzc
    out = torch.empty_like(m)
    carry = torch.zeros_like(m[0])
    for j in range(nz - 1, 0, -1):
        new = m[j] + carry
        out[j] = torch.clamp(new, min=0.0)
        carry = torch.clamp(new, max=0.0)
    m0 = m[0] + carry
    lvl1 = out[1]
    take = torch.where(m0 < 0.0,
                       torch.minimum(-m0, torch.clamp(lvl1, min=0.0)), 0.0)
    out[0] = m0 + take
    out[1] = lvl1 - take
    return out / dzc


def fix_negative(rho_q: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """Δz-weighted vertical borrowing of ``rho_q`` (see the module doc)."""
    global launches
    if rho_q.device.type == "cpu":
        return fix_negative_plain(rho_q, dz)
    nz, ny, nx = rho_q.shape
    _build.require_cuda_f32("rho_q", rho_q)
    _build.require_cuda_f32("dz", dz, (nz,))
    out = torch.empty_like(rho_q)
    lib = _build.library()
    with torch.cuda.device(rho_q.device):
        err = lib.breeze_fix_negative(rho_q.data_ptr(), dz.data_ptr(),
                                      out.data_ptr(), nz, ny, nx,
                                      _build.stream_handle(rho_q))
    _build.check(err, "fix_negative")
    launches += 1
    return out
