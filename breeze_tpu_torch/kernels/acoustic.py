"""The acoustic substeps of the split-explicit compressible core.

Replaces ``breeze_tpu/pallas_kernels/acoustic.py::_run_k3`` (body ``_make_k3``,
driver ``acoustic_substep_loop_pallas``) on its flat branch: potential
temperature, float32 carries, thermal divergence damping or none, no
sponge.  The plain version is the JAX package's jnp substep loop
(``dynamics/compressible.py::acoustic_substep_loop``) on the same branch.

One substep advances the perturbations about the stage-entry state U^L
(steps A–E of ``acoustic_substep_loop``):

A. ρu′, ρv′ forward under the slow tendencies and the perturbation
   pressure gradient of p′ = Cᴸ(ρθ)′, gated off on substep 0 when
   ``gate_first``;
B. the predictors ρ′★, (ρθ)′★ from the new horizontal divergences and the
   explicit (1−ω) part of the vertical ones;
C. the off-centred Crank-Nicolson tridiagonal for ρw′ (ρw′ = 0 on the
   bottom face; the top face's coupling is dropped);
D. the recovery of ρ′, (ρθ)′ with the implicit ω part;
E. Klemp's thermal divergence damping of ρu′, ρv′ from δτ(ρθ)′/θᴸ,

and sums ρu′, ρv′, ρw′ over the stage's substeps.

On the H100 it is bound by device memory.  The design (``csrc/acoustic.cu``)
is two launches per substep: a column kernel, one thread per (y, x) column
marching z, for A–D (it recomputes the neighbours' ρu′, ρv′ that B needs,
pointwise in the previous substep's fields, and keeps the Thomas sweep's
c′, d′ in (z, y, x) scratch so that loads coalesce across x), then a
pointwise kernel for E and the sums.  The TPU kernel's creeping y halo,
8-aligned windows and k ≤ 3 unroll for VMEM have no counterpart here.

``acoustic_substeps`` runs :func:`acoustic_substeps_plain` for CPU tensors
and the CUDA kernels for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import _build
from ..dynamics.tridiagonal import thomas_solve

#: Times a CUDA kernel was launched, two per substep (the plain version
#: does not count).
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
    """Static parameters: horizontal spacings, the CN off-centring ω, g and
    the thermal damping coefficient (0 for none)."""

    dx: float
    dy: float
    omega: float
    g_acc: float
    damping: float


@dataclasses.dataclass(frozen=True)
class ZColumns:
    """Δz at centers and at the stored faces (``(nz,)``, field dtype), which
    the plain version divides by as the jnp loop does, and their
    reciprocals from the float64 spacings, which the kernels take."""

    dz_c: torch.Tensor
    dz_f: torch.Tensor
    inv_dzc: torch.Tensor
    inv_dzf: torch.Tensor


def _below(a):
    """Row k−1 of a z-leading array, the bottom row duplicated."""
    return torch.cat([a[:1], a[:-1]], 0)


def _up0(a):
    """Row k+1, the top row zero (the wall face nz is not stored)."""
    return torch.cat([a[1:], torch.zeros_like(a[:1])], 0)


def acoustic_substeps_plain(cfg: AcousticConfig, cols: ZColumns,
                            caches, G, pert: Perturbations, dtau: float,
                            n_tau: int, gate_first: bool) -> Perturbations:
    """The jnp substep loop on whole arrays (any float dtype).  Arguments as
    :func:`acoustic_substeps`."""
    omega, g_acc = cfg.omega, cfg.g_acc
    C_L, th_c, th_zf = caches.C_L, caches.theta_L, caches.theta_L_zf
    dz_c, dz_f = cols.dz_c[:, None, None], cols.dz_f[:, None, None]
    xm = lambda a: torch.roll(a, 1, 2)      # a[i-1]
    ym = lambda a: torch.roll(a, 1, 1)      # a[j-1]
    xp = lambda a: torch.roll(a, -1, 2)     # a[i+1]
    yp = lambda a: torch.roll(a, -1, 1)     # a[j+1]
    dz_fc_div = lambda wf: (_up0(wf) - wf) / dz_c
    inv_dx, inv_dy = 1.0 / cfg.dx, 1.0 / cfg.dy

    # tridiagonal coefficients, substep-invariant; row 0 pins the wall
    od2 = omega * omega * dtau * dtau
    C_below = _below(C_L)
    thf_above = torch.cat([th_zf[1:], th_zf[-1:]], 0)
    dz_c_below = _below(dz_c)
    a_coef = (0.5 * g_acc * od2 / dz_c_below
              - od2 / dz_f * C_below * _below(th_zf) / dz_c_below)
    b_coef = (1.0 - 0.5 * g_acc * od2 * (1.0 / dz_c_below - 1.0 / dz_c)
              + od2 / dz_f * (C_L * th_zf / dz_c + C_below * th_zf / dz_c_below))
    c_coef = -0.5 * g_acc * od2 / dz_c - od2 / dz_f * C_L * thf_above / dz_c
    a_coef[0], b_coef[0], c_coef[0] = 0.0, 1.0, 0.0
    th_xf = 0.5 * (th_c + xm(th_c))
    th_yf = 0.5 * (th_c + ym(th_c))

    rho_p, ru_p, rv_p, rw_p, rt_p = pert[:5]
    sum_ru, sum_rv, sum_rw = pert[5:]
    for i in range(n_tau):
        # A: horizontal momenta
        pp = C_L * rt_p
        pgf = 0.0 if (i == 0 and gate_first) else 1.0
        ru_new = ru_p + dtau * (G.rho_u - pgf * ((pp - xm(pp)) * inv_dx))
        rv_new = rv_p + dtau * (G.rho_v - pgf * ((pp - ym(pp)) / cfg.dy))
        # B: predictors
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
        Crt_tau, Crt_star = C_L * rt_p, C_L * rt_star
        d_rhs = (rw_p + dtau * G.rho_w
                 - g_acc * dtau * ((1.0 - omega) * rho_tau_zf + omega * rho_star_zf)
                 - dtau * ((1.0 - omega) * (Crt_tau - _below(Crt_tau)) / dz_f
                           + omega * (Crt_star - _below(Crt_star)) / dz_f))
        d_rhs[0] = 0.0
        rw_new = thomas_solve(a_coef, b_coef, c_coef, d_rhs)
        rw_new[0] = 0.0
        # D: recovery
        rho_new = rho_star - omega * dtau * dz_fc_div(rw_new)
        rt_new = rt_star - omega * dtau * dz_fc_div(th_zf * rw_new)
        # E: thermal divergence damping
        if cfg.damping:
            D = (rt_new - rt_p) / th_c
            ru_new = ru_new - cfg.damping * cfg.dx / dtau * (D - xm(D))
            rv_new = rv_new - cfg.damping * cfg.dy / dtau * (D - ym(D))
        rho_p, ru_p, rv_p, rw_p, rt_p = rho_new, ru_new, rv_new, rw_new, rt_new
        sum_ru, sum_rv, sum_rw = sum_ru + ru_p, sum_rv + rv_p, sum_rw + rw_p
    return Perturbations(rho_p, ru_p, rv_p, rw_p, rt_p, sum_ru, sum_rv, sum_rw)


def acoustic_substeps(cfg: AcousticConfig, cols: ZColumns, caches, G,
                      pert: Perturbations, dtau: float, n_tau: int,
                      gate_first: bool) -> Perturbations:
    """``n_tau`` acoustic substeps of length ``dtau``.

    - ``caches``: the stage's ``C_L``, ``theta_L``, ``theta_L_zf``
      (``(nz, ny, nx)``);
    - ``G``: the slow tendencies ``rho``, ``rho_u``, ``rho_v``, ``rho_w``,
      ``rho_theta``;
    - ``pert``: the perturbations at the first substep and the sums to add
      to (read only; the result is in new tensors);
    - ``gate_first``: no perturbation pressure gradient on substep 0.

    CPU tensors take the plain version; CUDA tensors launch the kernels.
    """
    global launches
    if pert.rho.device.type == "cpu":
        return acoustic_substeps_plain(cfg, cols, caches, G, pert, dtau, n_tau,
                                       gate_first)
    nz, ny, nx = shape = pert.rho.shape
    fields = dict(zip(("rho", "rho_u", "rho_v", "rho_w", "rho_theta",
                       "sum_rho_u", "sum_rho_v", "sum_rho_w"), pert))
    fields.update(C_L=caches.C_L, theta_L=caches.theta_L, theta_L_zf=caches.theta_L_zf)
    fields.update({f"G.{k}": getattr(G, k)
                   for k in ("rho", "rho_u", "rho_v", "rho_w", "rho_theta")})
    for name, t in fields.items():
        _build.require_cuda_f32(name, t, shape)
    for name in ("inv_dzc", "inv_dzf"):
        _build.require_cuda_f32(name, getattr(cols, name), (nz,))
    if n_tau < 1 or dtau <= 0.0:
        raise ValueError("need n_tau >= 1 and dtau > 0")

    # The caller's tensors are read, never written: substep 0 reads them and
    # writes fresh buffers.  ρu′, ρv′, (ρθ)′ then ping-pong between two
    # buffers of their own (slots 1 and 2); ρ′, ρw′ and the sums are updated
    # in place in theirs.
    new = lambda: torch.empty(shape, dtype=torch.float32, device=pert.rho.device)
    ru, rv, rt = ([p, new(), new()] for p in (pert.rho_u, pert.rho_v, pert.rho_theta))
    rho, rw, cp, dp, dd = (new() for _ in range(5))
    sums = [new() for _ in range(3)]
    prev = [pert.rho, pert.rho_w, *pert[5:]]
    omega, g_acc, damp = cfg.omega, cfg.g_acc, cfg.damping
    od2 = omega * omega * dtau * dtau
    inputs = [caches.C_L, caches.theta_L, caches.theta_L_zf, G.rho_u, G.rho_v,
              G.rho_w, G.rho, G.rho_theta, cols.inv_dzc, cols.inv_dzf]
    ints = [nz, ny, nx, int(bool(damp))]
    src = 0
    for t in range(n_tau):
        pgf = 0.0 if (t == 0 and gate_first) else 1.0
        dst = 2 if src == 1 else 1
        # order fixed by unpack() in csrc/acoustic.cu
        ptrs = ([ru[src], rv[src], rt[src]] + inputs + prev
                + [ru[dst], rv[dst], rt[dst], rho, rw, cp, dp, dd] + sums)
        floats = [1.0 / cfg.dx, 1.0 / cfg.dy, dtau, omega, pgf, od2,
                  0.5 * g_acc * od2, g_acc * dtau, dtau * (1.0 - omega),
                  omega * dtau, damp * cfg.dx / dtau, damp * cfg.dy / dtau]
        for entry in ("breeze_acoustic_column", "breeze_acoustic_damp"):
            _build.launch(entry, ptrs, ints, floats, rho)
            launches += 1
        src, prev = dst, [rho, rw, *sums]
    return Perturbations(rho, ru[src], rv[src], rw, rt[src], *sums)
