"""The fused anelastic stage: the tendency kernel.

Replaces ``breeze_tpu/pallas_kernels/tendency.py::fused_tendency_pallas``
(the ``pl.pallas_call`` in ``_run``, body ``_make_kernel``) with its closure
epilogue ``pallas_kernels/closure.py::_smag_block``.  One pass computes, for
every prognostic, the substepped value

    (1−α)·s⁰ + α·(s + Δt·G)

where G holds

- the nine momentum WENO5 flux divergences −∇·(ρU⊗u), with un-normalized
  weights (velocities are bounded, see ``weno5``);
- the scalar WENO5 flux divergences −∇·(ρuc) for θ and qᵗ, sharing the
  mass fluxes, with max-normalized weights and a 1e-9 floor;
- FPlane Coriolis from 4-point averages of the transverse momentum, and
  the buoyancy force interpolated to z-faces;
- the Smagorinsky-Lilly stress and diffusive-flux divergences (with
  Lilly's θᵥ correction and the reference's top-cell N² quirk);
- the column-linear forcings G += add(z) − damp(z)·(ρ-field).

Inputs are the velocity, scalar, buoyancy and θᵥ windows padded by ``H``
in z and y (``fields.pad``; x stays unpadded and periodic), the
time-independent columns of :class:`TendencyColumns`, and the current and
stage-0 prognostics.

On the H100 the kernel is bound by arithmetic: some thirty WENO5
reconstructions and the closure per point, against about seventeen
float32 fields of traffic.  The design: one thread per output point with x
fastest, so that window reads coalesce and neighbouring reads hit the
caches; periodic x is a modular index; ν (the eddy viscosity, with the
z-wall mirror done by clamping the level) is written once per stage by a
first pass of the same source, the only intermediate in device memory.
Tiling through shared memory and the tensor-core-free roofline work are left
for later.

``fused_tendency`` runs :func:`fused_tendency_plain` for CPU tensors and the
CUDA kernel (``csrc/tendency.cu``) for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

#: Halo of the padded windows in z and y.
H = 3

#: Times the CUDA kernel was launched (the plain version does not count).
launches = 0


@dataclasses.dataclass(frozen=True)
class TendencyConfig:
    """Static parameters of the stage.  ``closure`` is ``(prandtl,
    buoyancy_correction, g)`` for Smagorinsky-Lilly, or ``None``."""

    inv_dx: float
    inv_dy: float
    f_cor: float | None
    closure: tuple | None


@dataclasses.dataclass(frozen=True)
class TendencyColumns:
    """Time-independent z columns (one value per level, float).

    ``colc``/``colf``: reference density at centers/faces, padded by ``H``
    (even mirror, faces mirrored about the walls); ``invdzc``/``invdzf``:
    1/Δz at centers and at the stored faces, ``(nz,)``; ``invdzc_e``,
    ``invdzf_e``, ``cd2_e``: the closure's 1/Δz and (CΔ)² columns padded by
    ``H`` (``None`` without a closure).
    """

    colc: torch.Tensor
    colf: torch.Tensor
    invdzc: torch.Tensor
    invdzf: torch.Tensor
    invdzc_e: torch.Tensor | None = None
    invdzf_e: torch.Tensor | None = None
    cd2_e: torch.Tensor | None = None


# --------------------------------------------------------------------------
# Plain PyTorch version: the kernel's formulas on whole arrays
# --------------------------------------------------------------------------

def _sq(t):
    return t * t


def _weno5(q, normalize: bool):
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


def _weno_sel(cell, sign, normalize: bool):
    """Upwind WENO5 at an interface: ``cell(o)`` is the cell at offset o
    from the interface's left cell; ``sign >= 0`` selects the left-biased
    stencil, else the mirrored one ``cell(1 - o)``."""
    up = sign >= 0
    return _weno5([torch.where(up, cell(o), cell(1 - o))
                   for o in (-2, -1, 0, 1, 2)], normalize)


def _xs(a, o):
    """``_xs(a, o)[..., i] = a[..., (i + o) mod nx]`` (periodic x)."""
    return torch.roll(a, -o, 2) if o % a.shape[2] else a


def _sl(a, z0, nzr, y0, nyr):
    """Rows ``z0 .. z0+nzr`` and ``y0 .. y0+nyr`` of a window, counted from
    its interior."""
    return a[H + z0: H + z0 + nzr, H + y0: H + y0 + nyr]


def fused_tendency_plain(cfg: TendencyConfig, cols: TendencyColumns,
                         u, v, w, scalars, b, thb, fadd, fdamp, cur, prev,
                         alpha: float, dt: float):
    """The kernel on whole arrays (any float dtype; x rolls with
    ``torch.roll``).  Arguments as :func:`fused_tendency`."""
    nz = u.shape[0] - 2 * H
    ny = u.shape[1] - 2 * H
    col = lambda c: c[:, None, None]
    xs = _xs
    s = lambda a, zo, yo: _sl(a, zo, nz, yo, ny)
    sy = lambda a, zo, y0: _sl(a, zo, nz, y0, ny + 1)
    sz = lambda a, z0, yo: _sl(a, z0, nz + 1, yo, ny)
    dify = lambda F: F[:, 1:] - F[:, :-1]
    difz = lambda F: F[1:] - F[:-1]

    colc = col(cols.colc)
    colf = col(cols.colf)
    ru, rv, rw = u * colc, v * colc, w * colf
    invdzc, invdzf = col(cols.invdzc), col(cols.invdzf)
    inv_dx, inv_dy = cfg.inv_dx, cfg.inv_dy
    wsel = lambda cell, sign: _weno_sel(cell, sign, normalize=False)

    # ---- momentum: u at (zc, yc, xf) -------------------------------------
    rus, us = s(ru, 0, 0), s(u, 0, 0)
    mf = 0.5 * (rus + xs(rus, 1))
    F = mf * wsel(lambda o: xs(us, o), mf)
    du = (F - xs(F, -1)) * inv_dx
    rvc = sy(rv, 0, 0)
    mf = 0.5 * (rvc + xs(rvc, -1))
    F = mf * wsel(lambda o: sy(u, 0, o - 1), mf)
    du = du + dify(F) * inv_dy
    rwc = sz(rw, 0, 0)
    mf = 0.5 * (rwc + xs(rwc, -1))
    F = mf * wsel(lambda o: sz(u, o - 1, 0), mf)
    du = du + difz(F) * invdzc

    # ---- v at (zc, yf, xc) -----------------------------------------------
    mf = 0.5 * (s(ru, 0, 0) + s(ru, 0, -1))
    vs = s(v, 0, 0)
    F = mf * wsel(lambda o: xs(vs, o - 1), mf)
    dv = (xs(F, 1) - F) * inv_dx
    mf = 0.5 * (sy(rv, 0, -1) + sy(rv, 0, 0))
    F = mf * wsel(lambda o: sy(v, 0, o - 1), mf)
    dv = dv + dify(F) * inv_dy
    mf = 0.5 * (sz(rw, 0, 0) + sz(rw, 0, -1))
    F = mf * wsel(lambda o: sz(v, o - 1, 0), mf)
    dv = dv + difz(F) * invdzc

    # ---- w at (zf, yc, xc) -----------------------------------------------
    mf = 0.5 * (s(ru, 0, 0) + s(ru, -1, 0))
    ws = s(w, 0, 0)
    F = mf * wsel(lambda o: xs(ws, o - 1), mf)
    dw = (xs(F, 1) - F) * inv_dx
    mf = 0.5 * (sy(rv, 0, 0) + sy(rv, -1, 0))
    F = mf * wsel(lambda o: sy(w, 0, o - 1), mf)
    dw = dw + dify(F) * inv_dy
    mf = 0.5 * (sz(rw, -1, 0) + sz(rw, 0, 0))
    F = mf * wsel(lambda o: sz(w, o - 1, 0), mf)
    dw = dw + difz(F) * invdzf

    gu, gv = -du, -dv
    if cfg.f_cor is not None:
        rv_u = 0.25 * (s(rv, 0, 0) + s(rv, 0, 1)
                       + xs(s(rv, 0, 0), -1) + xs(s(rv, 0, 1), -1))
        ru_v = 0.25 * (s(ru, 0, 0) + xs(s(ru, 0, 0), 1)
                       + s(ru, 0, -1) + xs(s(ru, 0, -1), 1))
        gu = gu + cfg.f_cor * rv_u
        gv = gv - cfg.f_cor * ru_v
    b_slab = sz(b, -1, 0)
    gw = -dw + 0.5 * (b_slab[:-1] + b_slab[1:])

    cg = [None] * 5
    if cfg.closure is not None:
        cg = _smagorinsky_plain(cfg, cols, u, v, w, thb, scalars)
        gu, gv, gw = gu + cg[0], gv + cg[1], gw + cg[2]

    outs = []
    rufs = (s(ru, 0, 0), s(rv, 0, 0), s(rw, 0, 0))
    for n, g in enumerate((gu, gv, gw)):
        if fadd[n] is not None:
            g = g + col(fadd[n])
        if fdamp[n] is not None:
            g = g - col(fdamp[n]) * rufs[n]
        outs.append((1.0 - alpha) * prev[n] + alpha * (cur[n] + dt * g))

    # ---- scalars: shared mass fluxes, max-normalized weights --------------
    colc_iw = colc[H - 1: H + nz + 1]
    mfz = 0.5 * (colc_iw[:-1] + colc_iw[1:]) * sz(w, 0, 0)
    mfx, mfy = s(ru, 0, 0), sy(rv, 0, 0)
    for k, c in enumerate(scalars):
        cs = s(c, 0, 0)
        Fx = mfx * _weno_sel(lambda o: xs(cs, o - 1), mfx, True)
        acc = (xs(Fx, 1) - Fx) * inv_dx
        Fy = mfy * _weno_sel(lambda o: sy(c, 0, o - 1), mfy, True)
        acc = acc + dify(Fy) * inv_dy
        Fz = mfz * _weno_sel(lambda o: sz(c, o - 1, 0), mfz, True)
        acc = acc + difz(Fz) * invdzc
        g = -acc
        if cg[3 + k] is not None:
            g = g + cg[3 + k]
        n = 3 + k
        if fadd[n] is not None:
            g = g + col(fadd[n])
        if fdamp[n] is not None:
            g = g - col(fdamp[n]) * cs * colc[H: H + nz]
        outs.append((1.0 - alpha) * prev[n] + alpha * (cur[n] + dt * g))
    return outs


def _smagorinsky_plain(cfg, cols, u, v, w, thb, scalars):
    """Smagorinsky-Lilly tendencies ``[G_u, G_v, G_w, G_θ, G_qt]`` on whole
    arrays (the closure epilogue; ``breeze_tpu``'s ``_smag_block`` with the
    whole domain as one block)."""
    prandtl, buoy_corr, g_acc = cfg.closure
    nz = u.shape[0] - 2 * H
    ny = u.shape[1] - 2 * H
    inv_dx, inv_dy = cfg.inv_dx, cfg.inv_dy
    xs, sl = _xs, _sl

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

    out = [gu, gv, gw] + [scalar_diffusion(c) for c in scalars]
    return out + [None] * (5 - len(out))


# --------------------------------------------------------------------------
# The wrapper
# --------------------------------------------------------------------------

def fused_tendency(cfg: TendencyConfig, cols: TendencyColumns, u, v, w,
                   scalars, b, thb, fadd, fdamp, cur, prev,
                   alpha: float, dt: float):
    """The substepped prognostics ``[ρu, ρv, ρw, ρθ, (ρqᵗ)]`` of one stage.

    - ``u``, ``v``, ``w``, each of ``scalars`` (θ, then qᵗ if moist), ``b``
      (buoyancy force) and ``thb`` (θᵥ for Lilly's correction, or θ):
      ``(nz+2H, ny+2H, nx)`` windows padded in z and y.
    - ``fadd``/``fdamp``: per output, an ``(nz,)`` column or ``None``.
    - ``cur``/``prev``: the current and stage-0 prognostics ``(nz, ny, nx)``.
    - ``alpha``, ``dt``: the SSP-RK3 stage weight and the step.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches
    if u.device.type == "cpu":
        return fused_tendency_plain(cfg, cols, u, v, w, scalars, b, thb,
                                    fadd, fdamp, cur, prev, alpha, dt)
    K = len(scalars)
    n_out = 3 + K
    if K not in (1, 2) or not (len(fadd) == len(fdamp) == len(cur)
                               == len(prev) == n_out):
        raise ValueError("expected 1 or 2 scalars and 3+K outputs")
    nzp, nyp, nx = u.shape
    nz, ny = nzp - 2 * H, nyp - 2 * H
    wins = [("u", u), ("v", v), ("w", w), ("b", b), ("thb", thb)]
    wins += [(f"scalar{k}", c) for k, c in enumerate(scalars)]
    for name, t in wins:
        _build.require_cuda_f32(name, t, u.shape)
    for name, t in (("colc", cols.colc), ("colf", cols.colf)):
        _build.require_cuda_f32(name, t, (nzp,))
    for name, t in (("invdzc", cols.invdzc), ("invdzf", cols.invdzf)):
        _build.require_cuda_f32(name, t, (nz,))
    if cfg.closure is not None:
        for name in ("invdzc_e", "invdzf_e", "cd2_e"):
            _build.require_cuda_f32(name, getattr(cols, name), (nzp,))
    for n in range(n_out):
        _build.require_cuda_f32(f"cur{n}", cur[n], (nz, ny, nx))
        _build.require_cuda_f32(f"prev{n}", prev[n], (nz, ny, nx))
        for name, c in (("fadd", fadd[n]), ("fdamp", fdamp[n])):
            if c is not None:
                _build.require_cuda_f32(f"{name}{n}", c, (nz,))
    if nx < 4 or ny < 3 or nz < 4:
        raise ValueError("the CUDA kernel needs nx >= 4, ny >= 3, nz >= 4")

    outs = [torch.empty_like(c) for c in cur]
    nu = (torch.empty((nz, ny, nx), dtype=u.dtype, device=u.device)
          if cfg.closure is not None else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    pad5 = lambda seq: list(seq) + [None] * (5 - len(seq))
    # order fixed by TendArgs in csrc/tendency.cu
    ptrs = ([ptr(u), ptr(v), ptr(w), ptr(scalars[0]),
             ptr(scalars[1]) if K == 2 else None, ptr(b), ptr(thb),
             ptr(cols.colc), ptr(cols.colf), ptr(cols.invdzc), ptr(cols.invdzf),
             ptr(cols.invdzc_e), ptr(cols.invdzf_e), ptr(cols.cd2_e)]
            + [ptr(c) for c in pad5(fadd)] + [ptr(c) for c in pad5(fdamp)]
            + [ptr(c) for c in pad5(cur)] + [ptr(c) for c in pad5(prev)]
            + [ptr(c) for c in pad5(outs)] + [ptr(nu)])
    prandtl, buoy_corr, g_acc = cfg.closure or (1.0, False, 0.0)
    ints = [nz, ny, nx, K, int(cfg.f_cor is not None),
            int(cfg.closure is not None), int(bool(buoy_corr))]
    floats = [cfg.inv_dx, cfg.inv_dy, cfg.f_cor or 0.0, prandtl,
              1.0 / prandtl, g_acc, alpha, dt, 1.0 - alpha]
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    c_floats = (ctypes.c_float * len(floats))(*floats)
    lib = _build.library()
    with torch.cuda.device(u.device):
        err = lib.breeze_fused_tendency(c_ptrs, c_ints, c_floats,
                                        _build.stream_handle(u))
    _build.check(err, "fused_tendency")
    launches += 1
    return outs
