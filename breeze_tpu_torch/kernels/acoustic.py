"""The acoustic substeps of the split-explicit compressible core.

Replaces ``breeze_tpu/pallas_kernels/acoustic.py::_run_k3`` (body ``_make_k3``,
entry point ``acoustic_substep_loop_pallas``) on all its branches: flat or
σ-terrain (LinearDecay or SLEVE), the ρe coupling C_ρ (flat), thermal,
direct or no divergence damping, with or without the upper Rayleigh
sponge, float32 or bfloat16 carries.  The plain version is the JAX
package's jnp substep loop (``dynamics/compressible.py::
acoustic_substep_loop``) on the same branches.

One substep advances the perturbations about the stage-entry state U^L
(steps A–E of ``acoustic_substep_loop``; χ is θ, or e in ρe):

A. ρu′, ρv′ forward under the slow tendencies and the perturbation
   pressure gradient of p′ = Cᴸ(ρχ)′ (+ C_ρρ′ in ρe), gated off on
   substep 0 when ``gate_first``; over terrain the gradient is
   slope-corrected, ∂x p′|_z = ∂x p′|_ζ − sx·(1/J)∂ζ p′;
B. the predictors ρ′★, (ρθ)′★ from the new horizontal divergences and the
   explicit (1−ω) part of the vertical ones; over terrain the horizontal
   fluxes are J-weighted, the divergences carry 1/J, and the vertical flux
   is the contravariant ρw̃′ = ρw′ − S′, with the slope part S′ of the new
   momenta explicit;
C. the off-centred Crank-Nicolson tridiagonal for ρw′ (the top face's
   coupling is dropped; the bottom face is ρw′ = 0 when flat and the
   kinematic bottom ρw′ = S′ over terrain), with the sponge on its
   diagonal and right-hand side, and in ρe the C_ρ couplings with unit
   face weight;
D. the recovery of ρ′, (ρθ)′ with the implicit ω part (×1/J over terrain);
E. the divergence damping of ρu′, ρv′: Klemp's thermal form from
   δτ(ρθ)′/θᴸ, or the direct form from δ = ∂x(θᴸₓρu′) + ∂y(θᴸᵧρv′),

and sums ρu′, ρv′, ρw′ over the stage's substeps.  The carries' storage
type is the perturbations' own: bfloat16 carries are rounded after every
substep, the arithmetic and the sums stay in the working type.

On the H100 it is bound by device memory: a substep does ~110 float32
operations a point and moves ~28 fields.  The design (``csrc/acoustic.cu``)
cuts each substep to one pass that moves each of those once.  A stage
factors its column solve once (the pivots c′ and 1/den, which depend only
on the stage's caches); each substep's pass holds a tile of columns over
all levels on chip, with the pointwise work A, B and D spread over the
block's groups of levels and the Thomas sweep's scratch in shared memory,
and folds the previous substep's damping E and sums into its own reads; a
closing pass applies the last substep's E.  So a stage is n_tau + 2
launches.  What bounds the pass in practice is the latency of each
group's march up its levels, hidden only by the number of groups in
flight, which registers cap.  Terrain, the sponge, C_ρ and the storage
type are template parameters of the kernels.  The TPU kernel's creeping y
halo, 8-aligned windows and k ≤ 3 unroll for VMEM have no counterpart
here.

``acoustic_substeps`` runs :func:`acoustic_substeps_plain` for CPU tensors
and the CUDA kernels for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from . import _build
from ..dynamics.tridiagonal import thomas_solve

#: Times a CUDA kernel was launched: one per substep and two more per
#: stage, the pivots and the closing pass (the plain version does not count).
launches = 0


class Perturbations(NamedTuple):
    """The carried perturbations about U^L and the substep sums."""

    rho: torch.Tensor
    rho_u: torch.Tensor
    rho_v: torch.Tensor
    rho_w: torch.Tensor
    rho_theta: torch.Tensor
    sum_rho_u: torch.Tensor
    sum_rho_v: torch.Tensor
    sum_rho_w: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AcousticConfig:
    """Static parameters: horizontal spacings, the CN off-centring ω, g,
    the divergence-damping coefficient (0 for none) and its form,
    ``"thermal"`` or ``"direct"``, and whether the substeps run through the
    per-substep pair K1/K2 (``kernels/acoustic_split.py``) rather than
    these kernels."""

    dx: float
    dy: float
    omega: float
    g_acc: float
    damping: float
    damping_mode: str = "thermal"
    per_substep_kernels: bool = False


@dataclasses.dataclass(frozen=True)
class ZColumns:
    """Δz at centers and at the stored faces (``(nz,)``, field dtype), which
    the plain version divides by as the jnp loop does, and their
    reciprocals from the float64 spacings, which the kernels take; the
    sponge's rate × ramp on the stored z-faces (``(nz,)``), or ``None``
    without a sponge."""

    dz_c: torch.Tensor
    dz_f: torch.Tensor
    inv_dzc: torch.Tensor
    inv_dzf: torch.Tensor
    sponge: torch.Tensor | None = None


class TerrainFields(NamedTuple):
    """The acoustic loop's metric factors over terrain, each
    ``(1|nz, ny, nx)``: z-extent 1 for LinearDecay's ζ-independent
    Jacobians, nz for the slopes and for every field of SLEVE."""

    inv_jac_c: torch.Tensor   # 1/J at ζ-centers
    inv_jac_f: torch.Tensor   # 1/J at ζ-faces
    jac_xf: torch.Tensor      # J at x-faces
    jac_yf: torch.Tensor      # J at y-faces
    sx_c_zf: torch.Tensor     # ∂z/∂x at (ζ-face, x-center)
    sy_c_zf: torch.Tensor     # ∂z/∂y at (ζ-face, y-center)
    sx_cf: torch.Tensor       # ∂z/∂x at (ζ-center, x-face)
    sy_cf: torch.Tensor       # ∂z/∂y at (ζ-center, y-face)


def _below(a):
    """Row k−1 of a z-leading array, the bottom row duplicated."""
    return torch.cat([a[:1], a[:-1]], 0)


def _up0(a):
    """Row k+1, the top row zero (the wall face nz is not stored)."""
    return torch.cat([a[1:], torch.zeros_like(a[:1])], 0)


def _above_dup(a):
    """Row k+1, the top row duplicated."""
    return torch.cat([a[1:], a[-1:]], 0)


def acoustic_substeps_plain(cfg: AcousticConfig, cols: ZColumns,
                            caches, G, pert: Perturbations, dtau: float,
                            n_tau: int, gate_first: bool,
                            metrics: TerrainFields | None = None,
                            rho_w_L=None) -> Perturbations:
    """The jnp substep loop on whole arrays, working in the caches' dtype
    and storing the carries in the perturbations' own.  Arguments as
    :func:`acoustic_substeps`."""
    omega, g_acc = cfg.omega, cfg.g_acc
    C_L, th_c, th_zf = caches.C_L, caches.theta_L, caches.theta_L_zf
    C_rho = caches.C_rho
    work, store = C_L.dtype, pert.rho.dtype
    nz = C_L.shape[0]
    dz_c, dz_f = cols.dz_c[:, None, None], cols.dz_f[:, None, None]
    xm = lambda a: torch.roll(a, 1, 2)      # a[i-1]
    ym = lambda a: torch.roll(a, 1, 1)      # a[j-1]
    xp = lambda a: torch.roll(a, -1, 2)     # a[i+1]
    yp = lambda a: torch.roll(a, -1, 1)     # a[j+1]
    dz_fc_div = lambda wf: (_up0(wf) - wf) / dz_c
    inv_dx, inv_dy = 1.0 / cfg.dx, 1.0 / cfg.dy
    terrain = metrics is not None
    if terrain:
        ijc, ijf, jxf, jyf, sxz, syz, sxc, syc = metrics
    else:
        ijc = ijf = 1.0
    # row k−1 of a ζ-dependent factor; a ζ-independent one is its own
    below_j = lambda a: _below(a) if torch.is_tensor(a) and a.shape[0] == nz else a
    ijc_b = below_j(ijc)

    # tridiagonal coefficients, substep-invariant: gravity carries 1/J at
    # the ρ-update's center row, the C·θ couplings 1/J at the face times
    # 1/J at the (ρθ)-update's center row; row 0 is the bottom face
    od2 = omega * omega * dtau * dtau
    C_below = _below(C_L)
    thf_above = _above_dup(th_zf)
    dz_c_below = _below(dz_c)
    a_coef = (0.5 * g_acc * od2 / dz_c_below * ijc_b
              - od2 / dz_f * C_below * _below(th_zf) / dz_c_below * ijf * ijc_b)
    b_coef = (1.0 - 0.5 * g_acc * od2 * (ijc_b / dz_c_below - ijc / dz_c)
              + od2 / dz_f * (C_L * th_zf / dz_c * ijc
                              + C_below * th_zf / dz_c_below * ijc_b) * ijf)
    c_coef = (-0.5 * g_acc * od2 / dz_c * ijc
              - od2 / dz_f * C_L * thf_above / dz_c * ijf * ijc)
    if C_rho is not None:
        # p′ = … + C_ρρ′: the same couplings with unit face weight (the ρ
        # predictor's vertical flux is ρw′ itself)
        Cr_below = _below(C_rho)
        a_coef = a_coef - od2 / dz_f * Cr_below / dz_c_below * ijf * ijc_b
        b_coef = b_coef + od2 / dz_f * (C_rho / dz_c * ijc + Cr_below / dz_c_below * ijc_b) * ijf
        c_coef = c_coef - od2 / dz_f * C_rho / dz_c * ijf * ijc
    sponge = None if cols.sponge is None else cols.sponge[:, None, None]
    sponge_full = None
    if sponge is not None:
        b_coef = b_coef + omega * abs(dtau) * sponge
        if rho_w_L is not None:
            sponge_full = abs(dtau) * sponge * rho_w_L
    a_coef[0], b_coef[0], c_coef[0] = 0.0, 1.0, 0.0
    th_xf = 0.5 * (th_c + xm(th_c))
    th_yf = 0.5 * (th_c + ym(th_c))

    def slope_part(ru, rv):
        """S′ at ζ-faces: the z-face slopes times the 4-point x/z and y/z
        means of ρu′, ρv′."""
        rub, rvb = _below(ru), _below(rv)
        return (sxz * (0.25 * (ru + xp(ru) + rub + xp(rub)))
                + syz * (0.25 * (rv + yp(rv) + rvb + yp(rvb))))

    def pressure(rt, rho):
        return C_L * rt if C_rho is None else C_L * rt + C_rho * rho

    rho_p, ru_p, rv_p, rw_p, rt_p = (a.to(work) for a in pert[:5])
    sum_ru, sum_rv, sum_rw = pert[5:]
    for i in range(n_tau):
        # A: horizontal momenta
        pp = pressure(rt_p, rho_p)
        pgf = 0.0 if (i == 0 and gate_first) else 1.0
        dpdx = (pp - xm(pp)) * inv_dx
        dpdy = (pp - ym(pp)) / cfg.dy
        if terrain:
            # slope-corrected: (∂x p′)_z = ∂x p′|_ζ − sx·(1/J)∂ζ p′
            dpz_f = (pp - _below(pp)) / dz_f * ijf
            dpz_c = 0.5 * (dpz_f + _above_dup(dpz_f))
            dpdx = dpdx - sxc * 0.5 * (dpz_c + xm(dpz_c))
            dpdy = dpdy - syc * 0.5 * (dpz_c + ym(dpz_c))
        ru_new = ru_p + dtau * (G.rho_u - pgf * dpdx)
        rv_new = rv_p + dtau * (G.rho_v - pgf * dpdy)
        # B: predictors
        if terrain:
            jru, jrv = jxf * ru_new, jyf * rv_new
            div_h = ((xp(jru) - jru) * inv_dx + (yp(jrv) - jrv) * inv_dy) * ijc
            fx, fy = th_xf * ru_new * jxf, th_yf * rv_new * jyf
            div_ht = ((xp(fx) - fx) * inv_dx + (yp(fy) - fy) * inv_dy) * ijc
            # the contravariant split ρw̃′ = ρw′ − S′, S′ of the new momenta
            # explicit, ρw′ Crank-Nicolson
            S_new = slope_part(ru_new, rv_new)
            rwt_old = rw_p - slope_part(ru_p, rv_p)
            rho_star = (rho_p + dtau * (G.rho - div_h)
                        - dtau * ijc * ((1.0 - omega) * dz_fc_div(rwt_old)
                                        - omega * dz_fc_div(S_new)))
            rt_star = (rt_p + dtau * (G.rho_theta - div_ht)
                       - dtau * ijc * ((1.0 - omega) * dz_fc_div(th_zf * rwt_old)
                                       - omega * dz_fc_div(th_zf * S_new)))
        else:
            div_h = (xp(ru_new) - ru_new) * inv_dx + (yp(rv_new) - rv_new) * inv_dy
            fx, fy = th_xf * ru_new, th_yf * rv_new
            div_ht = (xp(fx) - fx) * inv_dx + (yp(fy) - fy) * inv_dy
            rho_star = (rho_p + dtau * (G.rho - div_h)
                        - dtau * (1.0 - omega) * dz_fc_div(rw_p))
            rt_star = (rt_p + dtau * (G.rho_theta - div_ht)
                       - dtau * (1.0 - omega) * dz_fc_div(th_zf * rw_p))
        # C: column solve for ρw′
        rho_star_zf = 0.5 * (rho_star + _below(rho_star))
        rho_tau_zf = 0.5 * (rho_p + _below(rho_p))
        Crt_tau, Crt_star = pressure(rt_p, rho_p), pressure(rt_star, rho_star)
        d_rhs = (rw_p + dtau * G.rho_w
                 - g_acc * dtau * ((1.0 - omega) * rho_tau_zf + omega * rho_star_zf)
                 - dtau * ijf * ((1.0 - omega) * (Crt_tau - _below(Crt_tau)) / dz_f
                                 + omega * (Crt_star - _below(Crt_star)) / dz_f))
        if sponge is not None:
            d_rhs = d_rhs - (1.0 - omega) * abs(dtau) * sponge * rw_p
        if sponge_full is not None:
            d_rhs = d_rhs - sponge_full
        # the bottom face: the kinematic bottom ρw̃′ = 0 over terrain (a
        # Dirichlet row for ρw′ = S′, kept after the solve), the wall when flat
        d_rhs[0] = S_new[0] if terrain else 0.0
        rw_new = thomas_solve(a_coef, b_coef, c_coef, d_rhs)
        if not terrain:
            rw_new[0] = 0.0
        # D: recovery
        rho_new = rho_star - omega * dtau * ijc * dz_fc_div(rw_new)
        rt_new = rt_star - omega * dtau * ijc * dz_fc_div(th_zf * rw_new)
        # E: divergence damping, thermal or direct
        if cfg.damping and cfg.damping_mode == "direct":
            fx, fy = th_xf * ru_new, th_yf * rv_new
            delta = (xp(fx) - fx) * inv_dx + (yp(fy) - fy) * inv_dy
            ru_new = ru_new + cfg.damping * cfg.dx * (delta - xm(delta)) / th_xf
            rv_new = rv_new + cfg.damping * cfg.dy * (delta - ym(delta)) / th_yf
        elif cfg.damping:
            D = (rt_new - rt_p) / th_c
            ru_new = ru_new - cfg.damping * cfg.dx / dtau * (D - xm(D))
            rv_new = rv_new - cfg.damping * cfg.dy / dtau * (D - ym(D))
        rho_p, ru_p, rv_p, rw_p, rt_p = (a.to(store).to(work) for a in
                                         (rho_new, ru_new, rv_new, rw_new, rt_new))
        sum_ru, sum_rv, sum_rw = sum_ru + ru_p, sum_rv + rv_p, sum_rw + rw_p
    return Perturbations(*(a.to(store) for a in (rho_p, ru_p, rv_p, rw_p, rt_p)),
                         sum_ru, sum_rv, sum_rw)


def acoustic_substeps(cfg: AcousticConfig, cols: ZColumns, caches, G,
                      pert: Perturbations, dtau: float, n_tau: int,
                      gate_first: bool, metrics: TerrainFields | None = None,
                      rho_w_L=None) -> Perturbations:
    """``n_tau`` acoustic substeps of length ``dtau``.

    - ``caches``: the stage's ``C_L``, ``theta_L``, ``theta_L_zf``
      (``(nz, ny, nx)``) and ``C_rho`` (the same shape in ρe, else
      ``None``);
    - ``G``: the slow tendencies ``rho``, ``rho_u``, ``rho_v``, ``rho_w``,
      ``rho_theta``;
    - ``pert``: the perturbations at the first substep, in their storage
      type (the working type, or bfloat16 carries over float32 work), and
      the sums to add to, in the working type (read only; the result is in
      new tensors, the carries in the storage type);
    - ``gate_first``: no perturbation pressure gradient on substep 0;
    - ``metrics``: the terrain's metric factors, or ``None`` when flat;
    - ``rho_w_L``: with a sponge (``cols.sponge``), the stage-entry ρwᴸ it
      also damps (KDH08's full-field form), or ``None`` to damp the
      perturbation only.

    CPU tensors take the plain version; CUDA tensors launch the kernels.
    """
    if pert.rho.device.type == "cpu":
        return acoustic_substeps_plain(cfg, cols, caches, G, pert, dtau, n_tau,
                                       gate_first, metrics, rho_w_L)
    nz, ny, nx = shape = pert.rho.shape
    store = pert.rho.dtype
    if store not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA kernel stores the carries in float32 or bfloat16, "
                         f"got {store}")
    carried = dict(zip(("rho", "rho_u", "rho_v", "rho_w", "rho_theta"), pert[:5]))
    fields = dict(zip(("sum_rho_u", "sum_rho_v", "sum_rho_w"), pert[5:]))
    fields.update(C_L=caches.C_L, theta_L=caches.theta_L, theta_L_zf=caches.theta_L_zf)
    fields.update({f"G.{k}": getattr(G, k)
                   for k in ("rho", "rho_u", "rho_v", "rho_w", "rho_theta")})
    crho = caches.C_rho
    if crho is not None:
        if metrics is not None:
            raise ValueError("the C_ρ coupling over terrain has no kernel instance")
        fields["C_rho"] = crho
    if rho_w_L is not None:
        fields["rho_w_L"] = rho_w_L
    for name, t in carried.items():
        _build.require_cuda(name, t, shape, store)
    for name, t in fields.items():
        _build.require_cuda(name, t, shape)
    for name in ("inv_dzc", "inv_dzf") + (("sponge",) if cols.sponge is not None else ()):
        _build.require_cuda(name, getattr(cols, name), (nz,))
    jz = 0
    if metrics is not None:
        # the four Jacobian factors share a z-extent: 1 (a z-stride of 0 in
        # the kernel) or nz; the slopes always have nz rows
        jz = metrics.inv_jac_c.shape[0]
        if jz not in (1, nz):
            raise ValueError(f"metric z-extent {jz}: expected 1 or {nz}")
        for name, t in metrics._asdict().items():
            _build.require_cuda(f"metrics.{name}", t,
                                (jz if name in TerrainFields._fields[:4] else nz, ny, nx))
    if n_tau < 1 or dtau <= 0.0:
        raise ValueError("need n_tau >= 1 and dtau > 0")
    if cfg.damping_mode not in ("thermal", "direct"):
        raise ValueError(f"unknown damping form {cfg.damping_mode!r}")

    # The full-field sponge is a substep-invariant term of the column's
    # right-hand side, Δτ·rate·ramp·ρwᴸ: it folds into G.ρw.
    grw = G.rho_w
    if cols.sponge is not None and rho_w_L is not None:
        grw = G.rho_w - cols.sponge[:, None, None] * rho_w_L

    # The caller's tensors are read, never written: substep 0 reads them and
    # writes fresh buffers.  ρu′, ρv′ after A, the damping input, (ρθ)′ and
    # ρ′ are read at neighbouring columns, so each ping-pongs between two
    # buffers of its own; ρw′ and the sums are updated in place in theirs
    # after the pass that first writes them (the sums of ρu′, ρv′ from the
    # second pass on, which adds the first substep's damped carries).
    device = pert.rho.device
    new = lambda dtype=torch.float32: torch.empty(shape, dtype=dtype, device=device)
    rt, rho = ([p, new(store), new(store)] for p in (pert.rho_theta, pert.rho))
    ruw, rvw, dd = ([new(), new()] for _ in range(3))
    rw, ru_out, rv_out = new(store), new(store), new(store)
    cp, inv = new(), new()
    sums = [new() for _ in range(3)]
    prev_rw, prev_uv_sums, prev_rw_sum = pert.rho_w, list(pert[5:7]), pert.sum_rho_w
    omega, g_acc, damp = cfg.omega, cfg.g_acc, cfg.damping
    direct = cfg.damping_mode == "direct"
    od2 = omega * omega * dtau * dtau
    inputs = [caches.C_L, caches.theta_L, caches.theta_L_zf, crho, G.rho_u, G.rho_v,
              grw, G.rho, G.rho_theta, cols.inv_dzc, cols.inv_dzf]
    extra = [*(metrics if metrics is not None else [None] * 8), cols.sponge]
    ints = [nz, ny, nx, 0 if not damp else 2 if direct else 1, int(metrics is not None),
            int(cols.sponge is not None), int(jz == nz), int(crho is not None),
            int(store == torch.bfloat16), 1]
    # the damping's factor: αΔx (direct) or αΔx/Δτ (thermal)
    fac = damp if direct else damp / dtau
    floats = [1.0 / cfg.dx, 1.0 / cfg.dy, dtau, omega, 0.0, od2, 0.5 * g_acc * od2,
              g_acc * dtau, dtau * (1.0 - omega), omega * dtau, fac * cfg.dx, fac * cfg.dy]

    def launch(entry, src, dst, w):
        """``entry`` reading the previous substep from slot ``src`` of ρ′,
        (ρθ)′ and slot ``w`` of ρu′, ρv′ after A and the damping input;
        writing slots ``dst`` and ``1 − w``.  Order fixed by unpack() in
        csrc/acoustic.cu."""
        global launches
        ptrs = ([pert.rho_u, pert.rho_v, rt[src], rho[src], prev_rw, ruw[w], rvw[w], dd[w]]
                + inputs + prev_uv_sums + [prev_rw_sum, ru_out, rv_out, rt[dst], rho[dst], rw,
                                           ruw[1 - w], rvw[1 - w], dd[1 - w], cp, inv]
                + sums + extra)
        _build.launch(entry, ptrs, ints, floats, cp)
        launches += 1

    launch("breeze_acoustic_pivots", 0, 1, 0)
    src, w = 0, 0
    for t in range(n_tau):
        ints[9] = int(t == 0)                                 # the caller's ρu′, ρv′
        floats[4] = 0.0 if (t == 0 and gate_first) else 1.0   # pgf
        dst = 2 if src == 1 else 1
        launch("breeze_acoustic_substep", src, dst, w)
        if t > 0:
            prev_uv_sums = sums[:2]
        src, w, prev_rw, prev_rw_sum = dst, 1 - w, rw, sums[2]
    ints[9] = 0
    launch("breeze_acoustic_close", src, src, w)
    return Perturbations(rho[src], ru_out, rv_out, rw, rt[src], *sums)


def kernel_info(nz: int, terrain: bool, sponge: bool, crho: bool, bf16: bool) -> dict:
    """The substep kernel's resources for nz levels on a branch: shared
    memory a block (bytes), blocks resident per SM, registers and local
    (spill) bytes a thread."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().breeze_acoustic_info(
        (ctypes.c_int * 5)(nz, int(terrain), int(sponge), int(crho), int(bf16)), out),
        "breeze_acoustic_info")
    return dict(zip(("smem_bytes", "blocks_per_sm", "registers", "local_bytes"), out))
