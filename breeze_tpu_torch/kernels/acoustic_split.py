"""The acoustic substeps through the per-substep kernel pair K1/K2.

Replaces ``breeze_tpu/pallas_kernels/acoustic.py::_run_k1`` (body
``_make_k1``) and ``::_run_k2`` (body ``_make_k2``), the pair that
``acoustic_substep_loop_pallas`` runs once per substep in place of K3 when
``BREEZE_TPU_PALLAS_ACOUSTIC_SPLIT`` is set.  The port reads no environment
variable: ``SplitExplicitTimeDiscretization(per_substep_kernels=True)``
selects this loop (``dynamics/compressible.py``).  Its envelope is the
pair's: flat terrain, the potential-temperature formulation, no or
thermal divergence damping, no sponge, float32 or bfloat16 carries.

One substep (the steps of ``kernels/acoustic.py``):

- K1, steps A and B: the new ρu′, ρv′ under the slow tendencies and the
  pressure gradient of p′ = Cᴸ(ρθ)′ (gated off by ``pgf = 0``), and the
  predictors ρ′★, (ρθ)′★ from the new horizontal divergences and the
  explicit (1−ω) part of the vertical ones.  Its four outputs are in the
  working type (float32 on the card) whatever the carries' type;
- K2, steps C, D and E: the Crank-Nicolson column solve for ρw′ (the
  Thomas sweep divides by its pivot), the recovery of ρ′, (ρθ)′, and the
  thermal damping of ρu′, ρv′ from D = ((ρθ)′new − (ρθ)′)/θᴸ with the
  stored (ρθ)′.  Its five outputs are in the carries' storage type.

Both take 1/Δz from the float64 spacings (``ZColumns.inv_dzc``,
``inv_dzf``).  The plain loop adds the stored ρu′, ρv′, ρw′ to the
stage's sums outside both kernels, as the TPU driver loop does
(``acoustic.py:1126-1128``); on the card K2 adds them itself
(:func:`acoustic_k2_sums`), the first substep's sums into new tensors and
the later ones in place.

On the H100 both kernels are bound by device memory; ``csrc/
acoustic_split.cu`` has the design: K1 one thread per point; K2 two
launches, the column solve in shared memory (32 columns × all levels a
block) and E, one thread per point.  ``acoustic_k1``, ``acoustic_k2``,
``acoustic_k2_sums`` and ``acoustic_substeps_split`` run the plain versions
for CPU tensors and the CUDA kernels for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .acoustic import AcousticConfig, Perturbations, ZColumns

#: Times each CUDA kernel was launched (the plain versions do not count):
#: K1 once a substep, K2 twice (the column solve, then E).
k1_launches = 0
k2_launches = 0


def _xm(a):
    return torch.roll(a, 1, 2)     # a[i-1]


def _ym(a):
    return torch.roll(a, 1, 1)     # a[j-1]


def _xp(a):
    return torch.roll(a, -1, 2)    # a[i+1]


def _yp(a):
    return torch.roll(a, -1, 1)    # a[j+1]


def _below(a):
    """Row k−1 of a z-leading array, the bottom row duplicated."""
    return torch.cat([a[:1], a[:-1]], 0)


def _up0(a):
    """Row k+1, the top row zero (the wall face nz is not stored)."""
    return torch.cat([a[1:], torch.zeros_like(a[:1])], 0)


def _check(cfg: AcousticConfig, caches) -> None:
    """Refuse what the pair has no branch for."""
    if caches.C_rho is not None:
        raise ValueError("the K1/K2 pair has no C_ρ (ρe) branch")
    if cfg.damping and cfg.damping_mode != "thermal":
        raise ValueError(f"the K1/K2 pair damps in the thermal form only, not "
                         f"{cfg.damping_mode!r}")


def acoustic_k1_plain(cfg: AcousticConfig, cols: ZColumns, caches, G, carries,
                      dtau: float, pgf: float):
    """K1 on whole arrays, in the caches' dtype.  Arguments as
    :func:`acoustic_k1`."""
    work = caches.C_L.dtype
    rho, ru, rv, rw, rt = (a.to(work) for a in carries)
    th, thf = caches.theta_L, caches.theta_L_zf
    inv_dx, inv_dy = 1.0 / cfg.dx, 1.0 / cfg.dy
    inv_dzc = cols.inv_dzc[:, None, None]
    pp = caches.C_L * rt
    ru_new = ru + dtau * (G.rho_u - pgf * ((pp - _xm(pp)) * inv_dx))
    rv_new = rv + dtau * (G.rho_v - pgf * ((pp - _ym(pp)) * inv_dy))
    div_h = (_xp(ru_new) - ru_new) * inv_dx + (_yp(rv_new) - rv_new) * inv_dy
    fx = 0.5 * (th + _xm(th)) * ru_new
    fy = 0.5 * (th + _ym(th)) * rv_new
    div_ht = (_xp(fx) - fx) * inv_dx + (_yp(fy) - fy) * inv_dy
    # ρw′ is zero on the top wall face (θᴸ there only multiplies it)
    dzdiv = (_up0(rw) - rw) * inv_dzc
    dzdiv_t = (_up0(thf * rw) - thf * rw) * inv_dzc
    rho_star = rho + dtau * (G.rho - div_h) - dtau * (1.0 - cfg.omega) * dzdiv
    rt_star = rt + dtau * (G.rho_theta - div_ht) - dtau * (1.0 - cfg.omega) * dzdiv_t
    return ru_new, rv_new, rho_star, rt_star


def acoustic_k2_plain(cfg: AcousticConfig, cols: ZColumns, caches, G_rho_w, carries,
                      k1, dtau: float):
    """K2 on whole arrays, in the caches' dtype, the outputs in the
    carries'.  Arguments as :func:`acoustic_k2`."""
    work, store = caches.C_L.dtype, carries[0].dtype
    rho_p, rw_p, rt_p = (carries[n].to(work) for n in (0, 3, 4))
    ru_new, rv_new, rhos, rts = k1
    cl, th, thf = caches.C_L, caches.theta_L, caches.theta_L_zf
    omega, g_acc = cfg.omega, cfg.g_acc
    od2 = omega * omega * dtau * dtau
    inv_dzc, inv_dzf = cols.inv_dzc[:, None, None], cols.inv_dzf[:, None, None]
    inv_dzc_b, cl_b = _below(inv_dzc), _below(cl)
    thf_a = torch.cat([thf[1:], thf[-1:]], 0)
    a_co = 0.5 * g_acc * od2 * inv_dzc_b - od2 * inv_dzf * cl_b * _below(thf) * inv_dzc_b
    b_co = (1.0 - 0.5 * g_acc * od2 * (inv_dzc_b - inv_dzc)
            + od2 * inv_dzf * thf * (cl * inv_dzc + cl_b * inv_dzc_b))
    c_co = -0.5 * g_acc * od2 * inv_dzc - od2 * inv_dzf * cl * thf_a * inv_dzc
    crt_tau, crt_star = cl * rt_p, cl * rts
    d = (rw_p + dtau * G_rho_w
         - g_acc * dtau * ((1.0 - omega) * (0.5 * (rho_p + _below(rho_p)))
                           + omega * (0.5 * (rhos + _below(rhos))))
         - dtau * ((1.0 - omega) * ((crt_tau - _below(crt_tau)) * inv_dzf)
                   + omega * ((crt_star - _below(crt_star)) * inv_dzf)))
    # C: Thomas along z, row 0 the wall's Dirichlet row (c′ = d′ = 0),
    # dividing by the pivot as the TPU kernel does
    nz = d.shape[0]
    cp, dp = torch.zeros_like(d), torch.zeros_like(d)
    for k in range(1, nz):
        den = b_co[k] - a_co[k] * cp[k - 1]
        cp[k] = c_co[k] / den
        dp[k] = (d[k] - a_co[k] * dp[k - 1]) / den
    for k in range(nz - 2, -1, -1):
        dp[k] = dp[k] - cp[k] * dp[k + 1]
    rw_new = dp
    # D: recovery
    rho_new = rhos - omega * dtau * (_up0(rw_new) - rw_new) * inv_dzc
    thw = thf * rw_new
    rt_new = rts - omega * dtau * (_up0(thw) - thw) * inv_dzc
    # E: thermal divergence damping from the stored (ρθ)′
    ru, rv = ru_new, rv_new
    if cfg.damping:
        D = (rt_new - rt_p) / th
        ru = ru - cfg.damping * cfg.dx / dtau * (D - _xm(D))
        rv = rv - cfg.damping * cfg.dy / dtau * (D - _ym(D))
    return tuple(a.to(store) for a in (rho_new, ru, rv, rw_new, rt_new))


def _require_carries(carries) -> torch.Size:
    """Validate the five carries for a kernel; returns their shape."""
    shape, store = carries[0].shape, carries[0].dtype
    if store not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the K1/K2 kernels store the carries in float32 or bfloat16, "
                         f"got {store}")
    for name, t in zip(Perturbations._fields, carries):
        _build.require_cuda(name, t, shape, store)
    return shape


def acoustic_k1(cfg: AcousticConfig, cols: ZColumns, caches, G, carries, dtau: float,
                pgf: float):
    """K1: one substep's A and B.

    - ``caches``: ``C_L``, ``theta_L``, ``theta_L_zf`` ``(nz, ny, nx)``
      (``C_rho`` must be ``None``: the pair has no ρe branch);
    - ``G``: the slow tendencies ``rho``, ``rho_u``, ``rho_v``,
      ``rho_theta``;
    - ``carries``: ρ′, ρu′, ρv′, ρw′, (ρθ)′ of the previous substep, in
      their storage type;
    - ``pgf``: 1, or 0 for no pressure gradient.

    Returns ρu′, ρv′ after A and the predictors ρ′★, (ρθ)′★, in the working
    type.  CPU tensors take the plain version; CUDA tensors launch the
    kernel.
    """
    global k1_launches
    _check(cfg, caches)
    if carries[0].device.type == "cpu":
        return acoustic_k1_plain(cfg, cols, caches, G, carries, dtau, pgf)
    nz, ny, nx = shape = _require_carries(carries)
    fields = dict(C_L=caches.C_L, theta_L=caches.theta_L, theta_L_zf=caches.theta_L_zf,
                  **{f"G.{k}": getattr(G, k) for k in ("rho_u", "rho_v", "rho", "rho_theta")})
    for name, t in fields.items():
        _build.require_cuda(name, t, shape)
    _build.require_cuda("inv_dzc", cols.inv_dzc, (nz,))
    store = carries[0].dtype
    rho, ru, rv, rw, rt = carries
    outs = [torch.empty(shape, dtype=torch.float32, device=rho.device) for _ in range(4)]
    # order fixed by launch_k1() in csrc/acoustic_split.cu
    _build.launch("breeze_acoustic_k1",
                  [ru, rv, rw, rho, rt, caches.C_L, caches.theta_L, caches.theta_L_zf,
                   G.rho_u, G.rho_v, G.rho, G.rho_theta, cols.inv_dzc, *outs],
                  [nz, ny, nx, int(store == torch.bfloat16)],
                  [1.0 / cfg.dx, 1.0 / cfg.dy, dtau, pgf, dtau * (1.0 - cfg.omega)], rho)
    k1_launches += 1
    return tuple(outs)


def acoustic_k2(cfg: AcousticConfig, cols: ZColumns, caches, G_rho_w, carries, k1,
                dtau: float):
    """K2: one substep's C, D and E.

    - ``G_rho_w``: the slow tendency of ρw ``(nz, ny, nx)``;
    - ``carries``: ρ′, ρu′, ρv′, ρw′, (ρθ)′ of the previous substep, in their
      storage type (K2 reads ρ′, ρw′, (ρθ)′);
    - ``k1``: :func:`acoustic_k1`'s ρu′, ρv′, ρ′★, (ρθ)′★ of this substep.

    Returns the new ρ′, ρu′, ρv′, ρw′, (ρθ)′ in the carries' storage type.
    CPU tensors take the plain version; CUDA tensors launch the kernels
    (the column solve, then E).
    """
    _check(cfg, caches)
    if carries[0].device.type == "cpu":
        return acoustic_k2_plain(cfg, cols, caches, G_rho_w, carries, k1, dtau)
    return _launch_k2(cfg, cols, caches, G_rho_w, carries, k1, dtau, (None,) * 3, (None,) * 3)


def acoustic_k2_sums(cfg: AcousticConfig, cols: ZColumns, caches, G_rho_w, carries, k1,
                     dtau: float, sums, sums_out):
    """K2 with the stage's sums: :func:`acoustic_k2`, and ``sums_out`` =
    ``sums`` + the stored ρu′, ρv′, ρw′ widened to the sums' type.

    - ``sums``: the sums of ρu′, ρv′, ρw′ so far, ``(nz, ny, nx)`` in the
      working type (float32 on the card);
    - ``sums_out``: where the new sums go, ``sums`` itself to add in place.

    Returns the new ρ′, ρu′, ρv′, ρw′, (ρθ)′ as :func:`acoustic_k2`.  CPU
    tensors take the plain version and add; CUDA tensors launch the kernels.
    """
    _check(cfg, caches)
    if carries[0].device.type == "cpu":
        out = acoustic_k2_plain(cfg, cols, caches, G_rho_w, carries, k1, dtau)
        for s, o, c in zip(sums, sums_out, out[1:4]):
            torch.add(s, c.to(s.dtype), out=o)
        return out
    shape = carries[0].shape
    for name, t in zip(("sum_rho_u", "sum_rho_v", "sum_rho_w"), sums):
        _build.require_cuda(name, t, shape)
    for name, t in zip(("sum_rho_u out", "sum_rho_v out", "sum_rho_w out"), sums_out):
        _build.require_cuda(name, t, shape)
    return _launch_k2(cfg, cols, caches, G_rho_w, carries, k1, dtau, sums, sums_out)


def _launch_k2(cfg, cols, caches, G_rho_w, carries, k1, dtau, sums, sums_out):
    """K2's two launches on the card; ``sums`` and ``sums_out`` three
    tensors each, or three ``None`` each for no sums."""
    global k2_launches
    nz, ny, nx = shape = _require_carries(carries)
    for name, t in zip(("ru_new", "rv_new", "rho_star", "rt_star", "C_L", "theta_L",
                        "theta_L_zf", "G.rho_w"),
                       (*k1, caches.C_L, caches.theta_L, caches.theta_L_zf, G_rho_w)):
        _build.require_cuda(name, t, shape)
    for name in ("inv_dzc", "inv_dzf"):
        _build.require_cuda(name, getattr(cols, name), (nz,))
    store = carries[0].dtype
    rho, _, _, rw, rt = carries
    ru_new, rv_new, rhos, rts = k1
    device = rho.device
    outs = [torch.empty(shape, dtype=store, device=device) for _ in range(5)]
    dd = torch.empty(shape, dtype=torch.float32, device=device) if cfg.damping else None
    omega, g_acc = cfg.omega, cfg.g_acc
    od2 = omega * omega * dtau * dtau
    fac = cfg.damping / dtau
    # order fixed by launch_k2() in csrc/acoustic_split.cu; outputs ρu′, ρv′,
    # ρw′, ρ′, (ρθ)′
    _build.launch("breeze_acoustic_k2",
                  [rhos, rts, ru_new, rv_new, rw, rho, rt, G_rho_w, caches.C_L,
                   caches.theta_L, caches.theta_L_zf, cols.inv_dzc, cols.inv_dzf,
                   *sums, *outs, dd, *sums_out],
                  [nz, ny, nx, int(store == torch.bfloat16)],
                  [dtau, omega, od2, 0.5 * g_acc * od2, g_acc * dtau, omega * dtau,
                   fac * cfg.dx, fac * cfg.dy], rho)
    k2_launches += 2
    ru, rv, rw_out, rho_out, rt_out = outs
    return rho_out, ru, rv, rw_out, rt_out


def k2_kernel_info(nz: int, bf16: bool) -> dict:
    """K2's column kernel's resources for nz levels: shared memory a block
    (bytes), blocks resident per SM, registers and local (spill) bytes a
    thread."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().breeze_acoustic_k2_info((ctypes.c_int * 2)(nz, int(bf16)),
                                                          out),
                 "breeze_acoustic_k2_info")
    return dict(zip(("smem_bytes", "blocks_per_sm", "registers", "local_bytes"), out))


def _substeps(k1, k2, cfg, cols, caches, G, pert, dtau, n_tau, gate_first):
    """``n_tau`` substeps of the pair ``k1``, ``k2``, adding the stored
    momenta to the sums (the caller's tensors are read, never written)."""
    if n_tau < 1 or dtau <= 0.0:
        raise ValueError("need n_tau >= 1 and dtau > 0")
    _check(cfg, caches)
    work = caches.C_L.dtype
    carries, sums = tuple(pert[:5]), list(pert[5:])
    for t in range(n_tau):
        pgf = 0.0 if (t == 0 and gate_first) else 1.0
        carries = k2(cfg, cols, caches, G.rho_w, carries,
                     k1(cfg, cols, caches, G, carries, dtau, pgf), dtau)
        stored = (carries[1], carries[2], carries[3])
        if t == 0:
            sums = [s + c.to(work) for s, c in zip(sums, stored)]
        else:
            for s, c in zip(sums, stored):
                s.add_(c)
    return Perturbations(*carries, *sums)


def acoustic_substeps_split_plain(cfg: AcousticConfig, cols: ZColumns, caches, G,
                                  pert: Perturbations, dtau: float, n_tau: int,
                                  gate_first: bool) -> Perturbations:
    """The substep loop through the plain pair, on any device.  Arguments
    as :func:`acoustic_substeps_split`."""
    return _substeps(acoustic_k1_plain, acoustic_k2_plain, cfg, cols, caches, G, pert,
                     dtau, n_tau, gate_first)


def acoustic_substeps_split(cfg: AcousticConfig, cols: ZColumns, caches, G,
                            pert: Perturbations, dtau: float, n_tau: int,
                            gate_first: bool) -> Perturbations:
    """``n_tau`` acoustic substeps of length ``dtau``, each one K1 and one
    K2 (two launches on the card); the arguments and the result as
    ``kernels.acoustic.acoustic_substeps``'s on a flat ρθ stage without a
    sponge.  The damping must be none or thermal.

    CPU tensors take the plain pair; CUDA tensors launch the kernels, K2
    with the sums folded in.
    """
    if pert.rho.device.type == "cpu":
        return _substeps(acoustic_k1, acoustic_k2, cfg, cols, caches, G, pert, dtau, n_tau,
                         gate_first)
    if n_tau < 1 or dtau <= 0.0:
        raise ValueError("need n_tau >= 1 and dtau > 0")
    carries, sums = tuple(pert[:5]), tuple(pert[5:])
    for t in range(n_tau):
        pgf = 0.0 if (t == 0 and gate_first) else 1.0
        # the first substep's sums go to new tensors: the caller's are read only
        out = tuple(torch.empty_like(s) for s in sums) if t == 0 else sums
        carries = acoustic_k2_sums(cfg, cols, caches, G.rho_w, carries,
                                   acoustic_k1(cfg, cols, caches, G, carries, dtau, pgf),
                                   dtau, sums, out)
        sums = out
    return Perturbations(*carries, *sums)
