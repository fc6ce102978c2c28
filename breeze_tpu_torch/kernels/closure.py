"""The Smagorinsky-Lilly closure as a pass of its own: the closure kernel.

Replaces ``breeze_tpu/pallas_kernels/closure.py::closure_tendencies_pallas``
(the ``pl.pallas_call`` in ``_run``, body ``_smag_block``), the split form
of the fused tendency kernel's closure epilogue; the model runs it on the
anelastic route outside the fused kernel.  From the z/y-padded u, v,
w, θ, (qᵗ) windows and the θᵥ window of Lilly's correction it computes

- the six staggered strains, |S|² with the off-diagonals averaged to
  centers, Lilly's ς (with the reference's top-cell N² quirk) and
  ν = (CΔ)²|S|ς at centers, mirrored at the z walls;
- the ρᵣ-weighted stress divergences G_u, G_v, G_w and the diffusive
  flux divergences G_θ, (G_qᵗ) with κ = ν/Pr.

Row 0 of G_w reads below-wall data, which the wall condition overwrites.

On the H100 it is bound by device memory: six windows read and five fields
written against ~390 float32 operations per point.  The design is the
fused kernel's: two launches, a ν pass writing ν at centers (the only
intermediate in device memory; the wall mirror is a clamp of the level),
then the divergences, one thread per output point with x fastest.  The
device code of both passes is ``csrc/smagorinsky.cuh``, which the fused
tendency kernel's epilogue includes too, so the two cannot drift apart.

``closure_tendencies`` runs :func:`closure_tendencies_plain` for CPU
tensors and the CUDA kernel (``csrc/closure.cu``) for CUDA tensors; the
fused tendency's plain version reuses :func:`closure_tendencies_plain`.
"""

from __future__ import annotations

import torch

from . import _build
from .weno import H, sl, xs

#: Times the CUDA kernel was called (two launches each; the plain version
#: does not count).
launches = 0


def closure_tendencies_plain(cfg, cols, u, v, w, thb, scalars):
    """The kernel on whole arrays (any float dtype; ``breeze_tpu``'s
    ``_smag_block`` with the whole domain as one block).  Arguments and
    result as :func:`closure_tendencies`."""
    prandtl, buoy_corr, g_acc = cfg.closure
    nz = u.shape[0] - 2 * H
    ny = u.shape[1] - 2 * H
    inv_dx, inv_dy = cfg.inv_dx, cfg.inv_dy

    def colw(c, z0, nzr):
        return c[H + z0: H + z0 + nzr, None, None]

    invdzc_e, invdzf_e, cd2_e = cols.invdzc_e, cols.invdzf_e, cols.cd2_e
    # strains on the centers z -1..nz, y -1..ny (everything ν needs)
    EZ0, EZN, EY0, EYN = -1, nz + 2, -1, ny + 2
    uE1 = sl(u, EZ0, EZN, EY0, EYN)
    S11 = (xs(uE1, 1) - uE1) * inv_dx
    vE = sl(v, EZ0, EZN, EY0, EYN + 1)
    S22 = (vE[:, 1:] - vE[:, :-1]) * inv_dy
    wE = sl(w, EZ0, EZN + 1, EY0, EYN)
    S33 = (wE[1:] - wE[:-1]) * colw(invdzc_e, EZ0, EZN)
    u12 = sl(u, EZ0, EZN, EY0 - 1, EYN + 2)
    dy_u = (u12[:, 1:] - u12[:, :-1]) * inv_dy
    v12 = sl(v, EZ0, EZN, EY0, EYN + 1)
    S12 = 0.5 * (dy_u + (v12 - xs(v12, -1)) * inv_dx)
    u13 = sl(u, EZ0 - 1, EZN + 2, EY0, EYN)
    dz_u = (u13[1:] - u13[:-1]) * colw(invdzf_e, EZ0, EZN + 1)
    w13 = sl(w, EZ0, EZN + 1, EY0, EYN)
    S13 = 0.5 * (dz_u + (w13 - xs(w13, -1)) * inv_dx)
    v23 = sl(v, EZ0 - 1, EZN + 2, EY0, EYN + 1)
    dz_v = (v23[1:] - v23[:-1]) * colw(invdzf_e, EZ0, EZN + 1)
    w23 = sl(w, EZ0, EZN + 1, EY0 - 1, EYN + 2)
    S23 = 0.5 * (dz_v + (w23[:, 1:] - w23[:, :-1]) * inv_dy)

    S12c = 0.25 * (S12[:, :-1] + S12[:, 1:] + xs(S12[:, :-1], 1) + xs(S12[:, 1:], 1))
    S13c = 0.25 * (S13[:-1] + S13[1:] + xs(S13[:-1], 1) + xs(S13[1:], 1))
    S23c = 0.25 * (S23[:-1, :-1] + S23[:-1, 1:] + S23[1:, :-1] + S23[1:, 1:])
    S2 = 2.0 * (S11 * S11 + S22 * S22 + S33 * S33
                + 2.0 * (S12c * S12c + S13c * S13c + S23c * S23c))
    abs_S = torch.sqrt(S2)
    kz = torch.arange(-1, nz + 1, device=u.device)[:, None, None]
    if buoy_corr:
        tE = sl(thb, EZ0 - 1, EZN + 2, EY0, EYN)
        dth_f = (tE[1:] - tE[:-1]) * colw(invdzf_e, EZ0, EZN + 1)
        dth = 0.5 * (dth_f[:-1] + dth_f[1:])
        # the reference's top cell copies its lower-face gradient
        dth = torch.where(kz == nz - 1, dth_f[:-1], dth)
        N2 = g_acc / torch.clamp(sl(thb, EZ0, EZN, EY0, EYN), min=1.0) * dth
        Ri = N2 / torch.clamp(S2, min=1e-20)
        abs_S = abs_S * torch.sqrt(torch.clamp(1.0 - Ri / prandtl, min=0.0))
    nu = colw(cd2_e, EZ0, EZN) * abs_S
    # z-wall mirror of ν: row -1 ← row 0, row nz ← row nz-1
    nu = torch.where(kz < 0, torch.roll(nu, -1, 0), nu)
    nu = torch.where(kz > nz - 1, torch.roll(nu, 1, 0), nu)

    def nuc(z0, nzr, y0, nyr):
        return nu[1 + z0: 1 + z0 + nzr, 1 + y0: 1 + y0 + nyr]

    rc = lambda z0, nzr: colw(cols.colc, z0, nzr)
    rf = lambda z0, nzr: colw(cols.colf, z0, nzr)

    rho_nu_c = rc(0, nz) * nuc(0, nz, -1, ny + 2)
    T11 = -2.0 * rho_nu_c[:, 1:-1] * S11[1:-1, 1:-1]
    T22 = -2.0 * rho_nu_c * S22[1:-1]
    T33 = -2.0 * (rc(-1, nz + 2) * nuc(-1, nz + 2, 0, ny)) * S33[:, 1:-1]
    nu12 = nuc(0, nz, -1, ny + 2)
    nu_xy = 0.25 * (nu12[:, 1:] + xs(nu12[:, 1:], -1)
                    + nu12[:, :-1] + xs(nu12[:, :-1], -1))
    T12 = -2.0 * rc(0, nz) * nu_xy * S12[1:-1, 1:-1]
    nu13 = nuc(-1, nz + 2, 0, ny)
    nu_xz = 0.25 * (nu13[1:] + xs(nu13[1:], -1) + nu13[:-1] + xs(nu13[:-1], -1))
    T13 = -2.0 * rf(0, nz + 1) * nu_xz * S13[1:-1, 1:-1]
    nu23 = nuc(-1, nz + 2, -1, ny + 2)
    nu_yz = 0.25 * (nu23[1:, 1:] + nu23[1:, :-1] + nu23[:-1, 1:] + nu23[:-1, :-1])
    T23 = -2.0 * rf(0, nz + 1) * nu_yz * S23[1:-1, 1:-1]

    invdzc_b = colw(invdzc_e, 0, nz)
    invdzf_b = colw(invdzf_e, 0, nz)
    gu = -((T11 - xs(T11, -1)) * inv_dx
           + (T12[:, 1:] - T12[:, :-1]) * inv_dy
           + (T13[1:] - T13[:-1]) * invdzc_b)
    T12v = T12[:, :-1]
    gv = -((xs(T12v, 1) - T12v) * inv_dx
           + (T22[:, 1:-1] - T22[:, :-2]) * inv_dy
           + (T23[1:, :-1] - T23[:-1, :-1]) * invdzc_b)
    T13w = T13[:-1]
    gw = -((xs(T13w, 1) - T13w) * inv_dx
           + (T23[:-1, 1:] - T23[:-1, :-1]) * inv_dy
           + (T33[1:-1] - T33[:-2]) * invdzf_b)

    kap = nu * (1.0 / prandtl)

    def scalar_diffusion(c):
        cz = sl(c, -1, nz + 2, 0, ny)
        Fz = (rf(0, nz + 1) * 0.5 * (kap[:-1, 1:-1] + kap[1:, 1:-1])
              * (cz[1:] - cz[:-1]) * colw(invdzf_e, 0, nz + 1))
        cy = sl(c, 0, nz, -1, ny + 2)
        Fy = (rc(0, nz) * 0.5 * (kap[1:-1, :-1] + kap[1:-1, 1:])
              * (cy[:, 1:] - cy[:, :-1]) * inv_dy)
        cxs = sl(c, 0, nz, 0, ny)
        kx = kap[1:-1, 1:-1]
        Fx = rc(0, nz) * 0.5 * (kx + xs(kx, -1)) * (cxs - xs(cxs, -1)) * inv_dx
        return ((xs(Fx, 1) - Fx) * inv_dx + (Fy[:, 1:] - Fy[:, :-1]) * inv_dy
                + (Fz[1:] - Fz[:-1]) * invdzc_b)

    return [gu, gv, gw] + [scalar_diffusion(c) for c in scalars]


def closure_tendencies(cfg, cols, u, v, w, thb, scalars):
    """``[G_u, G_v, G_w, G_θ, (G_qᵗ)]``, the Smagorinsky-Lilly tendencies.

    - ``cfg``: a ``TendencyConfig`` whose ``closure`` is ``(prandtl,
      buoyancy_correction, g)``; ``cols``: ``TendencyColumns`` with the
      closure's columns;
    - ``u``, ``v``, ``w``, ``thb`` (θᵥ, or θ without the moist correction)
      and each of ``scalars`` (θ, then qᵗ if moist): ``(nz+2H, ny+2H, nx)``
      windows padded in z and y.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches
    if u.device.type == "cpu":
        return closure_tendencies_plain(cfg, cols, u, v, w, thb, scalars)
    K = len(scalars)
    if K not in (1, 2) or cfg.closure is None:
        raise ValueError("expected 1 or 2 scalars and a Smagorinsky-Lilly closure")
    nzp, nyp, nx = u.shape
    nz, ny = nzp - 2 * H, nyp - 2 * H
    wins = [("u", u), ("v", v), ("w", w), ("thb", thb)]
    wins += [(f"scalar{k}", c) for k, c in enumerate(scalars)]
    for name, t in wins:
        _build.require_cuda(name, t, u.shape)
    for name in ("colc", "colf", "invdzc_e", "invdzf_e", "cd2_e"):
        _build.require_cuda(name, getattr(cols, name), (nzp,))
    if nx < 4 or ny < 3 or nz < 4:
        raise ValueError("the CUDA kernel needs nx >= 4, ny >= 3, nz >= 4")
    outs = [torch.empty((nz, ny, nx), dtype=u.dtype, device=u.device) for _ in range(3 + K)]
    nu = torch.empty((nz, ny, nx), dtype=u.dtype, device=u.device)
    prandtl, buoy_corr, g_acc = cfg.closure
    # order fixed by CloArgs in csrc/closure.cu
    ptrs = [u, v, w, thb, scalars[0], scalars[1] if K == 2 else None,
            cols.colc, cols.colf, cols.invdzc_e, cols.invdzf_e, cols.cd2_e,
            *outs, *([None] * (2 - K)), nu]
    _build.launch("breeze_closure_tendencies", ptrs, [nz, ny, nx, K, int(bool(buoy_corr))],
                  [cfg.inv_dx, cfg.inv_dy, prandtl, 1.0 / prandtl, g_acc], u)
    launches += 1
    return outs
