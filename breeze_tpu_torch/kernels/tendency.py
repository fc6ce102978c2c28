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

On the H100 the kernel is bound by float32 operations: 9 + 3K WENO5
face reconstructions (each face once), ν and the closure per point, about
1600 operations against about seventeen float32 fields of traffic.  The
design (``csrc/tendency.cu``) is 2.5-D blocking: a block owns a 32 × 16 tile
of columns and marches up a chunk of :data:`Z_CHUNK` levels.  The planes of
u, v, w, θ, qᵗ (and θᵥ) for levels k−3 … k+3, the tile plus its 3-point
halo, sit in a ring in shared memory, the next level's plane arriving by
``cp.async`` while a level computes.  Each x and y face flux of a level is
computed once into shared memory and every point takes differences; each z
face flux is carried in a register to the next level.  ν is computed one
level ahead for the tile and a 1-point halo into a ring of three ν planes,
so the closure epilogue needs no second launch and ν never reaches device
memory.  What holds it back: instruction issue and latency at one
512-thread block (16 warps) per SM, which the ~169 KB of shared memory
allows; the closure's stresses are still evaluated per point.

``fused_tendency`` runs :func:`fused_tendency_plain` for CPU tensors and the
CUDA kernel (``csrc/tendency.cu``) for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build
from .closure import closure_tendencies_plain
from .momentum import momentum_div_plain
from .weno import H, sl as _sl, weno_sel as _weno_sel, xs as _xs

#: Times the CUDA kernel was launched (the plain version does not count).
launches = 0

#: Levels each block of the CUDA kernel marches over: 256³ gives 8 × 16 × 4
#: blocks, about four waves at one block per SM on 132 SMs; each chunk loads
#: six planes and seeds its z fluxes once (64 read 2.11 ms against 2.14 for
#: 32 on an H100, PERF.md).
Z_CHUNK = 64


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
    inv_dx, inv_dy = cfg.inv_dx, cfg.inv_dy
    invdzc = col(cols.invdzc)
    du, dv, dw = momentum_div_plain(ru, rv, rw, u, v, w, cols.invdzc, cols.invdzf,
                                    inv_dx, inv_dy)

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
        cg = closure_tendencies_plain(cfg, cols, u, v, w, thb, scalars) + [None] * 2
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
        _build.require_cuda(name, t, u.shape)
    for name, t in (("colc", cols.colc), ("colf", cols.colf)):
        _build.require_cuda(name, t, (nzp,))
    for name, t in (("invdzc", cols.invdzc), ("invdzf", cols.invdzf)):
        _build.require_cuda(name, t, (nz,))
    if cfg.closure is not None:
        for name in ("invdzc_e", "invdzf_e", "cd2_e"):
            _build.require_cuda(name, getattr(cols, name), (nzp,))
    for n in range(n_out):
        _build.require_cuda(f"cur{n}", cur[n], (nz, ny, nx))
        _build.require_cuda(f"prev{n}", prev[n], (nz, ny, nx))
        for name, c in (("fadd", fadd[n]), ("fdamp", fdamp[n])):
            if c is not None:
                _build.require_cuda(f"{name}{n}", c, (nz,))
    if nx < 4 or ny < 3 or nz < 4:
        raise ValueError("the CUDA kernel needs nx >= 4, ny >= 3, nz >= 4")

    outs = [torch.empty_like(c) for c in cur]
    pad5 = lambda seq: list(seq) + [None] * (5 - len(seq))
    # order fixed by TendArgs in csrc/tendency.cu
    ptrs = ([u, v, w, scalars[0], scalars[1] if K == 2 else None, b, thb,
             cols.colc, cols.colf, cols.invdzc, cols.invdzf,
             cols.invdzc_e, cols.invdzf_e, cols.cd2_e]
            + pad5(fadd) + pad5(fdamp) + pad5(cur) + pad5(prev) + pad5(outs))
    prandtl, buoy_corr, g_acc = cfg.closure or (1.0, False, 0.0)
    ints = [nz, ny, nx, K, int(cfg.f_cor is not None),
            int(cfg.closure is not None), int(bool(buoy_corr)), Z_CHUNK]
    floats = [cfg.inv_dx, cfg.inv_dy, cfg.f_cor or 0.0, prandtl,
              1.0 / prandtl, g_acc, alpha, dt, 1.0 - alpha]
    _build.launch("breeze_fused_tendency", ptrs, ints, floats, u)
    launches += 1
    return outs


def kernel_info(K: int, closure: bool, thv_window: bool) -> dict:
    """The CUDA kernel's resources for K scalars, with or without the
    closure and a θᵥ window apart from θ's: shared memory a block (bytes),
    blocks resident per SM, registers and local (spill) bytes a thread."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().breeze_fused_tendency_info(
        (ctypes.c_int * 3)(K, int(closure), int(thv_window)), out), "breeze_fused_tendency_info")
    return dict(zip(("smem_bytes", "blocks_per_sm", "registers", "local_bytes"), out))
