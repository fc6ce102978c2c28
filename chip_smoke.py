#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``breeze_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root with one card visible:

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. the device: ``torch.cuda`` must be available; the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``breeze_tpu_torch/csrc`` with nvcc (one
   process per source), with each kernel's registers and spills;
3. each BOMEX kernel against its plain PyTorch version at the 256³ BOMEX
   shapes (the tendency kernel on a state with noise on every prognostic,
   its G and its increment each measured against their own size), with
   both times, and the tendency kernel's registers, spill, shared memory a
   block and blocks resident per SM;
4. a small BOMEX run through the kernels against the same run through the
   plain versions on the CPU, with the CPU float32-vs-float64 distance;
5. the anelastic slice: 256³ BOMEX (``bench.py``'s configuration, random θ
   noise from a fixed seed; the fused tendency kernel, the projection
   kernels), 2 warm-up and 10 timed SSP-RK3 steps at Δt = 1 s, with the
   launch counts, finiteness and the ∫ρθΔz / ∫ρqᵗΔz drift checked;
6. a per-layer breakdown of one more BOMEX step;
7. each compressible kernel against its plain version at 256×256×128 (the
   bubble with noise on its momenta and ρθ; one 7-substep acoustic stage
   with noise on all five perturbations and the slow tendencies of that
   state), with both times;
8. two steps of the bubble with noise on its momenta and ρθ at 64×32×32
   through the kernels against the same steps through the plain versions
   on the CPU;
9. the compressible slice: the 256×256×128 dry bubble (``bench.py
   --dynamics compressible``), 2 warm-up and 10 timed WS-RK3 steps at
   Δt = 0.5 s, with the launch counts, finiteness and the ∫ρ dV / ∫ρθ dV
   drift checked;
10. a per-layer breakdown of one more bubble step;
11. the acoustic kernel's σ-terrain branches against its plain version at
    256×256×128: one 7-substep stage over the benchmark's ridge made to
    vary in y (LinearDecay), over the same ridge in SLEVE coordinates, and
    over it with a full-field upper sponge, each from the noisy bubble over
    the ridge with noise on all five perturbations;
12. two steps of the noisy bubble over the ridge at 64×32×32 through the
    kernels against the same steps through the plain versions on the CPU;
13. the terrain slice: the 256×256×128 bubble over the ridge (``bench.py
    --dynamics compressible --terrain``), 2 warm-up and 10 timed steps, with
    the launch counts, finiteness and the ∫Jρ dV / ∫Jρθ dV drift checked;
14. a per-layer breakdown of one more ridge step;
15. the acoustic kernel's C_ρ, direct-damping and bfloat16-carry branches
    against its plain version at 256×256×128: one 7-substep stage each of
    C_ρ + thermal, θ + direct, C_ρ + direct (on the noisy moist bubble in
    ρe or ρθ) and bfloat16 carries (the noisy dry bubble);
16. two steps of the noisy moist bubble in ρe with direct damping at
    64×32×32 through the kernels against the same steps through the plain
    versions on the CPU;
17. the moist slice, 2 warm-up and 10 timed steps each at 256×256×128 of
    the moist bubble in ρθ (``bench.py --dynamics compressible --moist``),
    the moist bubble in ρe with direct damping, and the dry bubble with
    bfloat16 carries (``--substep-floattype bfloat16``), with the launch
    counts, finiteness and the ∫ρ dV, ∫ρθ dV, ∫ρqᵗ dV drift checked;
18. a per-layer breakdown of one more moist ρe step;
19. the anelastic route kernels against their plain versions at the 256³
    BOMEX shapes: the column-momentum kernel on the noisy BOMEX state's
    velocity windows (with its registers, spill, shared memory a block,
    blocks per SM and the field passes of its design), the projection
    kernels on a stage's predicted momenta and that stage's φ, the closure
    kernel on the moist windows with θᵥ, with both times;
20. two steps of BOMEX on the β-plane at 64×32×32 through the kernels
    against the same steps through the plain versions on the CPU, as
    phase 4;
21. BOMEX on the β-plane (the unfused route: the column-momentum, scalar,
    closure and projection kernels, whole-field Coriolis, the forcings'
    columns) at 256³, 2 warm-up and 10 timed steps, checked as phase 5;
22. a per-layer breakdown of one more β-plane step;
23. the per-substep acoustic pair K1/K2 at 256×256×128, each kernel
    against its plain version on one substep of phase 7's stage (the noisy
    bubble, noise on all five perturbations), then a 7-substep stage
    through the pair against the plain pair, in float32 and with bfloat16
    carries, and the same stage through K3 in turns with the pair for the
    A/B, with both kernels' times and bounds (K2 with the stage's sums, as
    the split loop runs it, and without), K2's resources and the field
    passes of its design;
24. two steps of the noisy bubble at 64×32×32 through the pair on CUDA
    against the same steps through the plain pair on the CPU, as phase 8;
25. the split slice, 2 warm-up and 10 timed steps each at 256×256×128 of
    the dry bubble and the bfloat16 bubble through the pair
    (``per_substep_kernels=True``), with the launch counts (14 K1, 28 K2,
    no K3 per step), finiteness, the dry path's ∫ρ dV / ∫ρθ dV drift, and
    the dry path's final state against phase 9's (K3) from the same start;
26. a per-layer breakdown of one more split step.

Each path's launch counts are zeroed just before its timed steps and read
just after.  The line before the last is a JSON object with one entry per
kernel (times measured here, the bound computed from this run's inputs);
the last line is ``{"ok": true, "device": {...}}``.  Phases 7, 11 and 15
also print the bytes the acoustic kernel's design moves a stage, the floor
they give, and its substep kernel's registers, shared memory and blocks
per SM.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

import breeze_tpu_torch as bt
from breeze_tpu_torch import bomex, bubble, ridge
from breeze_tpu_torch import fields as fl
from breeze_tpu_torch import model as M
from breeze_tpu_torch.dynamics import compressible as C
from breeze_tpu_torch.dynamics.terrain import kinematic_bottom_rho_w
from breeze_tpu_torch.kernels import (_build, acoustic, acoustic_split, advection, closure,
                                      columnar, momentum, projection, tendency)
from breeze_tpu_torch.kernels.weno import H
from breeze_tpu_torch.physics.microphysics import apply_negative_moisture_correction

SIZE = (256, 256, 256)
SEED = 1
DT = 1.0
WARMUP, STEPS = 2, 10
NAMES = ("rho_u", "rho_v", "rho_w", "rho_theta", "rho_qt")
# ∫ρθΔz and ∫ρqᵗΔz move only through the surface fluxes and the forcings:
# over these 12 s of BOMEX the totals moved by 8.93e-07 (θ) and 1.28e-06 (qᵗ)
# on an H100, so each bound is a small factor above its reading
DRIFT_BOUND = {"rho_theta": 5e-6, "rho_qt": 5e-6}
# the kernel against its plain version at the third SSP-RK3 stage's weight
# (1−α is rounded on the host) and a Δt at which αΔt·G stands well above the
# float32 rounding of the O(1)–O(300) state it is added to
ALPHA, PARITY_DT = 2.0 / 3.0, 3.0
PHASES = 26

# The compressible slice: bench.py --dynamics compressible
SIZE_C = (256, 256, 128)
DT_C = 0.5
C_NAMES = ("rho", "rho_u", "rho_v", "rho_w", "rho_theta")
# ∫ρ dV and ∫ρθ dV are flux-form with periodic x, y and walls in z, so
# they move by float32 rounding alone: over these 6 s they moved by 1.19e-08
# (ρ) and 1.18e-08 (ρθ) on an H100, so each bound is a small factor above
C_DRIFT_BOUND = {"rho": 5e-8, "rho_theta": 5e-8}
# two steps of the noisy bubble at 64×32×32, the CUDA run against the CPU
# float32 run: the CPU float32 and float64 runs differ by 2.1e-07–6.6e-05 of
# each field's largest value (ρw the most), so the bound is a small factor
# above the float32 rounding of the step
C_SMALL_LIMIT = 3e-4
# The ridge: in σ-coordinates ∫Jρ dV and ∫Jρθ dV are the flux-form totals.
# The thermal divergence damping leaks a little mass through the surface
# face (it damps ρu′ after the column solve has set ρw′ there from the old
# ρu′; 3.04e-08 over 1 s at 32×16×16 in float64, 0 without damping,
# tests/test_torch_terrain.py).  Over these 6 s they moved by 2.63e-09 (ρ)
# and 3.58e-09 (ρθ) on an H100, so each bound is a small factor above
RIDGE_DRIFT_BOUND = {"rho": 2e-8, "rho_theta": 2e-8}
# the parity cases' SLEVE decay heights and sponge depth on the 3.2 km domain
SLEVE = dict(large_scale_height=1600.0, small_scale_height=800.0)
SPONGE_DEPTH = 1000.0
# The moist slice's three paths, as bubble_model's options.  The drift of
# ∫ρ dV, ∫ρθ dV and ∫ρqᵗ dV is flux form (the repair of negative ρqᵗ keeps
# each column's total), so the moist ρθ path keeps the dry bubble's bound;
# in ρe the buoyancy work moves ∫ρe dV, which is printed but not gated;
# bfloat16 carries round ρ′ to 8 bits each substep, which is not flux form,
# so that path gates on finiteness and the kernel limit alone.
MOIST_PATHS = {
    "moist_theta": (dict(moist=True), {"rho": 5e-8, "rho_theta": 5e-8, "rho_qt": 5e-8}),
    "moist_rhoe_direct": (dict(moist=True, formulation="static_energy",
                               damping=C.DirectDivergenceDamping(0.1)),
                          {"rho": 5e-8, "rho_qt": 5e-8}),
    "bf16": (dict(substep_floattype="bfloat16"), {}),
}
# The split slice's two paths: the dry and the bfloat16 bubble through the
# K1/K2 pair, gated as their K3 paths are (phases 9 and 17)
SPLIT_PATHS = {
    "bubble_split": (dict(per_substep_kernels=True), C_DRIFT_BOUND),
    "bf16_split": (dict(per_substep_kernels=True, substep_floattype="bfloat16"), {}),
}
# The dry split path's final state against the K3 path's after the same 12
# steps from the plain bubble, each field against its largest value.  The
# momenta grow from rest by buoyancy alone and carry float32 rounding noise
# of their own size's order: on the CPU at 64×32×32 (Δx = 50 m, Δz = 25 m,
# as here) the same 12 steps moved them by 3.47e-03–3.96e-03 between
# float32 and float64, and by 2.86e-04–5.11e-04 between the plain pair and
# K3's plain loop in float32.  The two CUDA routes round independently
# through every substep, so the limit is a small factor above the float32
# noise, far below the O(1) a wrong term gives.
SPLIT_VS_K3_LIMIT = 1e-2

# The least time of a kernel's work: its bytes (each input read once, each
# output written once) at the H100 SXM's 3.35 TB/s, or its float32
# operations at 67 TFLOP/s outside the tensor cores, whichever is larger.
# Operations per output point, counted from the sources with every
# interface reconstructed once: WENO5 69 (78 max-normalized), its mass
# flux and flux 3-4, each divergence 3.
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
OPS_PER_POINT = {
    "fused_tendency": 1600,    # 9 momentum + 6 scalar faces, closure ~390
    "fix_negative": 6,
    "momentum_div": 675,       # 9 faces × 72 + 3 × 9
    "div_rho_u_c": 256,        # 3 faces × 82 + 10
    "acoustic_substeps": 110,  # per substep: A 12, B 34, C 35, D 10, E 16, sums 3
    # + the slope PGF 24, J-weighted fluxes 8, S′ 18, 1/J factors 20
    "acoustic_substeps_terrain": 180,
    # + C_ρρ′ in A 2, in C's pressures 4, its couplings in the coefficients 18
    "acoustic_substeps_crho": 135,
    # the direct form: δ 7 and E 14 for the thermal form's E 16
    "acoustic_substeps_direct": 115,
    "acoustic_substeps_crho_direct": 140,
    "momentum_div_cols": 678,  # momentum_div's 675 and ρᵣ(z)·u, ρᵣ(z)·v, ρᵣ(z)·w, 3
    "closure": 390,            # strains, ν, the θᵥ correction, five flux divergences
    "divergence": 8,
    "gradient_correct": 12,
    # per substep: A 12 and B 34 (K1); C 35, D 10, E 16 and the three sums (K2)
    "acoustic_k1": 46,
    "acoustic_k2": 64,
}

# The anelastic paths, as bomex_model's Coriolis: the canonical f-plane
# (the fused tendency kernel's route) and BOMEX's β-plane (the unfused
# route), each with the launches per step it must show (fix_negative at
# least once)
BOMEX_PATHS = {
    "bomex": (None, {"fused_tendency": 3, "momentum_div_cols": 0, "div_rho_u_c": 0,
                     "closure": 0, "divergence": 3, "gradient_correct": 3,
                     "fix_negative": 1}),
    "bomex_beta": (bomex.BETA_PLANE,
                   {"fused_tendency": 0, "momentum_div_cols": 3, "div_rho_u_c": 6,
                    "closure": 3, "divergence": 3, "gradient_correct": 3,
                    "fix_negative": 1}),
}
# two steps at 64×32×32, CUDA against CPU float32, state-relative: float32
# reassociation between the kernels and the plain versions through six
# stages and projections.  On the β-plane the distance read 1.71e-07–
# 4.26e-07 on an H100 beside a float32-vs-float64 distance of 1.65e-07–
# 4.85e-07, so its limit is a small factor above both
SMALL_LIMIT = {"bomex": 1e-5, "bomex_beta": 3e-6}


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_to_max(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |got − ref|, that over max |ref|)."""
    err = float((got.double() - ref.double()).abs().max())
    return err, err / max(float(ref.double().abs().max()), 1e-30)


def bound(name: str, inputs, outputs, shape, points: int) -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel's work: each distinct input
    read once and each output written once, ``points`` the output points
    times the passes.  A window padded by H rows in z and y counts at its
    interior ``shape``: its halo rows are copies of interior rows, which
    the function need not read twice."""
    nz, ny, nx = shape
    padded = (nz + 2 * H, ny + 2 * H, nx)
    distinct = {(t.data_ptr(), tuple(t.shape)): t for t in inputs}
    nbytes = sum((nz * ny * nx if tuple(t.shape) == padded else t.numel())
                 * t.element_size() for t in [*distinct.values(), *outputs])
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * OPS_PER_POINT[name] * points / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def flat(*items):
    """The tensors in nested lists, tuples and dicts (anything else dropped)."""
    out = []
    for it in items:
        if isinstance(it, dict):
            out += flat(*it.values())
        elif isinstance(it, (list, tuple)):
            out += flat(*it)
        elif isinstance(it, torch.Tensor):
            out.append(it)
    return out


def column_totals(model, state) -> dict:
    dz = model.grid.dz_c_col.double()
    return {k: float((getattr(state, k).double() * dz).sum()) for k in DRIFT_BOUND}


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available; this script "
                         "measures the port on an NVIDIA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(f"[1/{PHASES}] device: {name}, {torch.cuda.device_count()} visible, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name, smi


#: the acoustic kernels' template arguments in their mangled names: the
#: storage type (the substep and closing kernels), then the terrain, sponge
#: and C_ρ flags (the substep and pivot kernels)
ACOUSTIC_INSTANCE = re.compile(r"acoustic_(substep|pivot|close)_kernelI(f|13__nv_bfloat16)?"
                               r"(?:Lb([01])ELb([01])ELb([01])E)?")


def split_label(line: str) -> str:
    """``acoustic_k1``, ``acoustic_k2[bf16]``, ``acoustic_k2e``, … for a
    ptxas line naming an instance of the K1/K2 pair's kernels."""
    kernel, storage = re.search(r"acoustic_(k[12]e?)_kernelI(f|13__nv_bfloat16)", line).groups()
    return f"acoustic_{kernel}" + ("[bf16]" if storage != "f" else "")


def acoustic_label(line: str) -> str:
    """``acoustic_substep[flat]``, ``acoustic_pivot[terrain+sponge]``,
    ``acoustic_close[bf16]``, … for a ptxas line naming an instance."""
    kernel, storage, *flags = ACOUSTIC_INSTANCE.search(line).groups()
    parts = ["bf16"] if storage not in (None, "f") else []
    parts += [n for n, f in zip(("terrain", "sponge", "crho"), flags) if f == "1"]
    if kernel == "close":
        return "acoustic_close" + (f"[{'+'.join(parts)}]" if parts else "")
    return f"acoustic_{kernel}[{'+'.join(parts) or 'flat'}]"


def phase_build() -> dict:
    """Build; returns each kernel's registers and spill stores as ptxas
    reports them."""
    t0 = time.perf_counter()
    _build.library()
    report, entry = {}, ""
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = next((k for k in ("fused_tendency", "fix_negative", "momentum_div_cols", "momentum_div",
                                      "div_rho_u_c", "acoustic_substep",
                                      "acoustic_pivot", "acoustic_close", "acoustic_k1",
                                      "acoustic_k2",
                                      "closure_nu", "closure_tendencies",
                                      "divergence", "gradient_correct") if k in line), "?")
            if entry in ("acoustic_k1", "acoustic_k2"):
                entry = split_label(line)
            elif entry.startswith("acoustic"):
                entry = acoustic_label(line)
        elif "spill stores" in line:
            spills = line.split(",")[1].strip()
        elif "Used" in line and "registers" in line and entry:
            regs = line.split("Used")[1].split(",")[0].strip()
            report[entry] = f"{regs}, {spills}"
    print(f"[2/{PHASES}] built kernels in {time.perf_counter() - t0:.1f} s; "
          + "; ".join(f"{k}: {v}" for k, v in report.items()))
    return report


def perturbed(model, state, seed: int):
    """``state`` with noise on every prognostic (ρu, ρv at ρᵣ·N(0, 1), ρw at
    half that, ρqᵗ by 5 %), and a distinct stage-0 state: every term of the
    tendency and both branches of the blend are then non-trivial."""
    g = model.grid
    rng = np.random.default_rng(seed)
    gauss = lambda sd: torch.as_tensor(rng.normal(0.0, sd, g.shape),
                                       dtype=g.dtype, device=g.device)
    rho = model.reference.rho_col
    s = state.replace(rho_u=state.rho_u + rho * gauss(1.0),
                      rho_v=state.rho_v + rho * gauss(1.0),
                      rho_w=state.rho_w + rho * gauss(0.5),
                      rho_qt=state.rho_qt * (1.0 + gauss(0.05)))
    return s, s.replace(rho_u=s.rho_u + 0.1, rho_theta=s.rho_theta * 1.001)


def tendency_errors(args) -> dict:
    """Per field, (max abs error, that over the reference's largest value)
    of the CUDA kernel against the plain version, on two quantities:

    - ``G``: the tendency alone (zero current and stage-0 fields with
      α = Δt = 1 make the output exactly G);
    - ``increment``: out − ((1−α)s⁰ + α·s) = αΔt·G at the given weights.

    Both are measured against their own size, not the state's: an error in
    G would otherwise hide under the O(1) state values."""
    cur, prev, alpha, dt = args[10:]
    zeros = [torch.zeros_like(c) for c in cur]
    g_args = args[:10] + (zeros, zeros, 1.0, 1.0)
    pairs = {"G": (tendency.fused_tendency(*g_args),
                   tendency.fused_tendency_plain(*g_args)),
             "increment": tuple(
                 [o.double() - ((1.0 - alpha) * p.double() + alpha * c.double())
                  for o, c, p in zip(outs, cur, prev)]
                 for outs in (tendency.fused_tendency(*args),
                              tendency.fused_tendency_plain(*args)))}
    errors = {}
    for what, (got, ref) in pairs.items():
        for name, g, r in zip(NAMES, got, ref):
            if name == "rho_w":       # row 0 is overwritten by the projection
                g, r = g[1:], r[1:]
            errors[what, name] = rel_to_max(g, r)
    return errors


def phase_parity(model, state) -> list[dict]:
    s, s0 = perturbed(model, state, SEED + 1)
    aux = M.diagnose(model, s, T_guess=s.diagnostics["T_warm"])
    args = M.tendency_kernel_args(model, s, aux, PARITY_DT, s0, ALPHA)
    del aux
    errors = tendency_errors(args)
    torch.cuda.synchronize()
    for (what, name), (err, rel) in errors.items():
        # float32 reassociation and FMA contraction between the kernel and
        # the plain version: 1e-5 of the largest value of each field
        if not rel < 1e-5:
            raise AssertionError(f"fused_tendency {what} {name}: abs {err:.3e} "
                                 f"rel {rel:.3e}")
    max_abs = max(err for (what, _), (err, _) in errors.items() if what == "G")
    worst = {what: max(rel for (w, _), (_, rel) in errors.items() if w == what)
             for what in ("G", "increment")}
    t_kernel = cuda_ms(lambda: tendency.fused_tendency(*args), 5)
    t_plain = cuda_ms(lambda: tendency.fused_tendency_plain(*args), 2)
    points = args[10][0].numel()
    cfg, scalars, thb = args[0], args[5], args[7]
    info = tendency.kernel_info(len(scalars), cfg.closure is not None, thb is not scalars[0])
    entries = [dict(name="fused_tendency", route="cuda",
                    source="breeze_tpu_torch/csrc/tendency.cu",
                    replaces="breeze_tpu/pallas_kernels/tendency.py:360",
                    max_abs_err=max_abs, ms=t_kernel, plain_ms=t_plain,
                    shared_bytes=info["smem_bytes"], blocks_per_sm=info["blocks_per_sm"],
                    **bound("fused_tendency", flat(args[2:12], vars(args[1])),
                            args[10], model.grid.shape, points))]
    print(f"[3/{PHASES}] fused_tendency 256^3 stage, noise on every prognostic: max abs "
          f"err of G {max_abs:.3e}; G-relative {worst['G']:.2e}, "
          f"increment-relative {worst['increment']:.2e} (limit 1e-5); "
          f"kernel {t_kernel:.3f} ms, plain {t_plain:.3f} ms; {info['registers']} registers, "
          f"{info['local_bytes']} bytes of local memory (spills), {info['smem_bytes']} bytes "
          f"of shared memory a block, {info['blocks_per_sm']} block(s) per SM "
          f"(z chunk {tendency.Z_CHUNK})")
    del args, s, s0

    nz, ny, nx = model.grid.shape
    rng = np.random.default_rng(SEED)
    rq = rng.normal(2e-3, 3e-3, (nz, ny, nx)).astype(np.float32)
    rq[:, 0, :2] = -np.abs(rq[:, 0, :2]) - 1e-3
    rq = torch.from_numpy(rq).to(model.grid.device)
    max_abs, times = 0.0, []
    for label, dz in (("uniform", model.grid.dz_c),
                      ("stretched", torch.as_tensor(20.0 * 1.01 ** np.arange(nz),
                                                    dtype=torch.float32,
                                                    device=model.grid.device))):
        got = columnar.fix_negative(rq, dz)
        ref = columnar.fix_negative_plain(rq, dz)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=2e-5, atol=1e-8, err_msg=label)
        dzc = dz.double()[:, None, None]
        np.testing.assert_allclose((got.double() * dzc).sum(0).cpu().numpy(),
                                   (rq.double() * dzc).sum(0).cpu().numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=label)
        max_abs = max(max_abs, float((got - ref).abs().max()))
        times.append((cuda_ms(lambda: columnar.fix_negative(rq, dz), 20),
                      cuda_ms(lambda: columnar.fix_negative_plain(rq, dz), 3)))
    t_kernel, t_plain = times[0]
    entries.append(dict(name="fix_negative", route="cuda",
                        source="breeze_tpu_torch/csrc/columnar.cu",
                        replaces="breeze_tpu/pallas_kernels/columnar.py:113",
                        max_abs_err=max_abs, ms=t_kernel, plain_ms=t_plain,
                        **bound("fix_negative", [rq, model.grid.dz_c], [rq],
                                model.grid.shape, rq.numel())))
    print(f"[3/{PHASES}] fix_negative 256^3: max abs err {max_abs:.3e}; kernel "
          f"{t_kernel:.3f} ms, plain {t_plain:.3f} ms (uniform Δz); "
          f"{times[1][0]:.3f} / {times[1][1]:.3f} ms (stretched)")
    return entries


def phase_small_reference(path: str, phase: int) -> None:
    """Two steps of a BOMEX path at 64×32×32 through the CUDA kernels
    against the same steps through the plain versions on the CPU, with the
    CPU float32-vs-float64 distance beside each field's."""
    size, shape = (64, 32, 32), (32, 32, 64)
    noise = 0.1 * np.random.default_rng(SEED).standard_normal(shape)
    runs = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        model = bomex.bomex_model(size, dtype=dtype, device=device,
                                  coriolis=BOMEX_PATHS[path][0])
        state = bomex.bomex_state(model, noise)
        for _ in range(2):
            state = bt.ssp_rk3_step(model, state, DT)
        runs[device, dtype] = {k: getattr(state, k).cpu().double() for k in NAMES}
    ref, f64 = runs["cpu", torch.float32], runs["cpu", torch.float64]
    # the projection couples the momenta, so each momentum component is
    # measured against the largest momentum; scalars against themselves
    mom_scale = max(float(f64[k].abs().max()) for k in NAMES[:3])
    limit, parts = SMALL_LIMIT[path], []
    for name in NAMES:
        scale = mom_scale if name in NAMES[:3] else float(f64[name].abs().max())
        err = float((runs["cuda", torch.float32][name] - ref[name]).abs().max()) / scale
        gap = float((ref[name] - f64[name]).abs().max()) / scale
        parts.append(f"{name} {err:.2e} (f32-vs-f64 {gap:.2e})")
        if not err < limit:
            raise AssertionError(f"64x32x32 {path} after 2 steps, {name}: rel {err:.3e} "
                                 f"(limit {limit})")
    print(f"[{phase}/{PHASES}] 64x32x32 {path}, 2 steps, CUDA vs CPU plain float32 "
          f"(state-relative, limit {limit}): " + ", ".join(parts))


def phase_slice(model, state, label: str, path: str, phase: int) -> tuple[dict, object]:
    """2 warm-up and 10 timed steps of a BOMEX path at 256³; returns the
    launches per step of every kernel and the final state."""
    totals0 = column_totals(model, state)
    for _ in range(WARMUP):
        state = bt.ssp_rk3_step(model, state, DT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_route_counts()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = bt.ssp_rk3_step(model, state, DT)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    per_step = {k: v / STEPS for k, v in route_counts().items()}
    for k, n in BOMEX_PATHS[path][1].items():
        if not (per_step[k] >= n if k == "fix_negative" else per_step[k] == n):
            raise AssertionError(f"{path} missed its kernels: {per_step}")
    for name in NAMES:
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{path}: {name} is not finite after {WARMUP + STEPS} steps")
    totals1 = column_totals(model, state)
    drift = {k: abs(totals1[k] - totals0[k]) / abs(totals0[k]) for k in totals0}
    for k, limit in DRIFT_BOUND.items():
        if not drift[k] < limit:
            raise AssertionError(f"{path}: ∫{k}Δz drifted by {drift[k]:.3e} (bound {limit})")
    ms = 1e3 * elapsed / STEPS
    points = SIZE[0] * SIZE[1] * SIZE[2]
    print(f"[{phase}/{PHASES}] 256^3 {path}: {ms:.2f} ms/step, {points / (ms * 1e-3):.4e} "
          f"points/s on {label}; launches per step {per_step}; drift θ "
          f"{drift['rho_theta']:.2e} qt {drift['rho_qt']:.2e}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return per_step, state


def phase_breakdown(model, state, label: str, phase: int = 6, what: str = "step") -> None:
    """One step with the device drained between layers (host clock)."""
    spans = {"fix_negative": 0.0, "diagnose": 0.0, "tendency+extras": 0.0,
             "projection": 0.0}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        spans[key] += 1e3 * (time.perf_counter() - t0)
        return out

    state = timed("fix_negative", lambda: apply_negative_moisture_correction(model, state))
    state0, prev_T = state, state.diagnostics["T_warm"]
    for alpha in bt.timesteppers.SSP_RK3_ALPHAS:
        aux = timed("diagnose", lambda: M.diagnose(model, state, T_guess=prev_T))
        prev_T = aux.T
        ns = timed("tendency+extras",
                   lambda: M.stage_update(model, state, state0, DT, alpha, aux=aux))
        ru, rv, rw, _ = timed("projection", lambda: M.pressure_projection(
            model, ns.rho_u, ns.rho_v, ns.rho_w, alpha * DT))
        state = ns.replace(rho_u=ru, rho_v=rv, rho_w=rw)
    total = sum(spans.values())
    print(f"[{phase}/{PHASES}] one {what} by layer on {label}, ms (synchronized): "
          + ", ".join(f"{k} {v:.2f}" for k, v in spans.items())
          + f"; total {total:.2f}")


def noisy_bubble(model, seed: int):
    """The bubble (dry or moist) with noise on the momenta (0.5·N(0, 1), ρw
    off the bottom face) and ρθ (0.05·N(0, 1); in ρe 50·N(0, 1), about the
    same pressure noise): every WENO and Coriolis term of the slow
    tendencies is then non-trivial."""
    g = model.grid
    rng = np.random.default_rng(seed)
    gauss = lambda sd: torch.as_tensor(rng.normal(0.0, sd, g.shape), dtype=g.dtype,
                                       device=g.device)
    state = bubble.bubble_state(model)
    rho_w = state.rho_w + gauss(0.2)
    rho_w[0] = 0.0
    scale = 1e3 if model.formulation == "static_energy" else 1.0
    return state.replace(rho_u=state.rho_u + gauss(0.5), rho_v=state.rho_v + gauss(0.5),
                         rho_w=rho_w, rho_theta=state.rho_theta + gauss(0.05 * scale))


def check_rel(what: str, pairs, limit: float) -> float:
    """Each (got, ref) within ``limit`` of max |ref|; returns the largest
    absolute error."""
    worst = 0.0
    for name, got, ref in pairs:
        err, rel = rel_to_max(got, ref)
        if not rel < limit:
            raise AssertionError(f"{what} {name}: abs {err:.3e} rel {rel:.3e} (limit {limit})")
        worst = max(worst, err)
    return worst


def stage_args(model, s, aux, seed: int):
    """One acoustic stage from state ``s``: N = 7 substeps with the PGF
    gate at Δτ = Δt/7 (the last stage's), the stage's caches and slow
    tendencies, noise 1e-3·N(0, 1) on the five perturbations (in the
    carries' storage type; ρw′ zero on a flat bottom face) and zero sums;
    returns the arguments of ``acoustic_substeps`` and its keywords."""
    g = model.grid
    caches = C.stage_caches(model, s, aux)
    G = C.stage_slow_tendencies(model, s, aux)
    rng = np.random.default_rng(seed)
    pert = [torch.as_tensor(rng.normal(0.0, 1e-3, g.shape), dtype=g.dtype, device=g.device)
            for _ in range(5)]
    if model.terrain is None:
        pert[3][0] = 0.0
    pert = [p.to(model.substep_dtype or g.dtype) for p in pert]
    zero = torch.zeros(g.shape, dtype=g.dtype, device=g.device)
    pert = acoustic.Perturbations(*pert, zero, zero, zero)
    n_tau = 7
    stage = (model.acoustic_config, model.z_columns, caches, G, pert, DT_C / n_tau, n_tau, True)
    return stage, dict(metrics=model.acoustic_metrics, rho_w_L=C.sponge_rho_w_L(model, s))


def design_bytes(stage, kw) -> int:
    """The bytes one stage moves through device memory by the acoustic
    kernels' design, each launch's fields read once and written once (the
    neighbours' values come from the caches): the pivots, the first pass
    (the caller's ρu′, ρv′, no damping input), the later passes and the
    closing pass (csrc/acoustic.cu)."""
    cfg, _, caches, _, pert, _, n_tau, _ = stage
    n = pert.rho.numel()
    f, c = 4 * n, pert.rho.element_size() * n
    damp = f if cfg.damping else 0
    direct = f if cfg.damping and cfg.damping_mode == "direct" else 0
    crho = f if caches.C_rho is not None else 0
    m = kw["metrics"]
    # the four slopes and the Jacobians; 1/J at centers read again in D
    terrain = 0 if m is None else 4 * f + sum(4 * t.numel() for t in m[:4]) + 4 * m[0].numel()
    pivots = 2 * f + crho + (0 if m is None else 4 * (m[0].numel() + m[1].numel())) + 2 * f
    # carries, Cᴸ, θᴸ, θᴸ at faces, C_ρ, the slow tendencies, the pivots; D
    # writes the carries and E's input (the thermal form reads θᴸ again)
    common = (3 * c + 3 * f + crho + 5 * f + 2 * f + terrain + 3 * c + 2 * f + damp
              + (damp - direct))
    first = common + 2 * c + f + f                     # ρu′, ρv′ in; ρw′'s sum
    later = common + 2 * f + damp + 3 * f + 3 * f      # after A, E's input, three sums
    close = 2 * f + damp + direct + 2 * f + 2 * c + 2 * f
    return pivots + first + (n_tau - 1) * later + close


def stage_entry(name: str, model, stage, kw, got, launches: int) -> dict:
    """The stage's bound (``bound``: each distinct input read once, each
    output written once), the acoustic launches its checked call made, and
    the substep kernel's resources on this branch."""
    cfg, cols, caches, G, pert, _, n_tau, _ = stage
    g = model.grid
    if launches != n_tau + 2:
        raise AssertionError(f"{name}: {launches} acoustic launches a stage, not n_tau + 2 = "
                             f"{n_tau + 2}")
    info = acoustic.kernel_info(g.nz, model.terrain is not None, cols.sponge is not None,
                                caches.C_rho is not None, pert.rho.dtype == torch.bfloat16)
    return dict(**bound(name, flat(caches, G, pert, kw, cols.inv_dzc, cols.inv_dzf, cols.sponge),
                        got, g.shape, n_tau * g.nx * g.ny * g.nz),
                launches_per_stage=launches, substep_kernel=info)


def counted_stage(stage, **kw):
    """One call of ``acoustic_substeps`` and the launches it made."""
    before = acoustic.launches
    got = acoustic.acoustic_substeps(*stage, **kw)
    torch.cuda.synchronize()
    return got, acoustic.launches - before


def substep_line(e: dict, stage, kw) -> str:
    """The design's bytes a substep and the floor they give a stage, and the
    substep kernel's resources."""
    moved, n_tau = design_bytes(stage, kw), stage[6]
    k = e["substep_kernel"]
    return (f"; {e['launches_per_stage']} launches; {moved / n_tau / 1e9:.3f} GB a substep by "
            f"design, floor {1e3 * moved / HBM_BYTES_PER_S:.3f} ms a stage; substep kernel "
            f"{k['registers']} registers, {k['local_bytes']} B local, {k['smem_bytes']} B "
            f"shared a block, {k['blocks_per_sm']} block(s) per SM")


def phase_compressible_parity(model) -> list[dict]:
    g = model.grid
    points = g.nx * g.ny * g.nz
    s = noisy_bubble(model, SEED + 2)
    aux = C.compressible_diagnose(model, s)
    pz = lambda a, loc: fl.pad(a, g, loc, halo=3, axes=(0, 1))
    vel = [pz(aux.u, fl.CCF), pz(aux.v, fl.CFC), pz(aux.w, fl.FCC)]
    inv_dx, inv_dy = 1.0 / g.dx, 1.0 / g.dy
    entries, lines = [], []

    # float32 reassociation and FMA contraction: 1e-5 of each output's
    # largest value, as for the tendency kernel
    mom = [pz(s.rho_u, fl.CCF), pz(s.rho_v, fl.CFC), pz(s.rho_w, fl.FCC)]
    margs = (*mom, *vel, model.z_columns.inv_dzc, model.z_columns.inv_dzf, inv_dx, inv_dy)
    got = momentum.momentum_div(*margs)
    torch.cuda.synchronize()
    max_abs = check_rel("momentum_div", zip("uvw", got, momentum.momentum_div_plain(*margs)),
                        1e-5)
    entries.append(dict(name="momentum_div", route="cuda",
                        source="breeze_tpu_torch/csrc/momentum.cu",
                        replaces="breeze_tpu/pallas_kernels/momentum.py:283",
                        max_abs_err=max_abs,
                        ms=cuda_ms(lambda: momentum.momentum_div(*margs), 20),
                        plain_ms=cuda_ms(lambda: momentum.momentum_div_plain(*margs), 3),
                        **bound("momentum_div", flat(margs), got, g.shape, points)))

    aargs = (pz(aux.theta, fl.CCC), *vel, pz(s.rho, fl.CCC), model.z_columns.inv_dzc, inv_dx, inv_dy,
             model.scalar_advection.bounds_preserving)
    got = advection.div_rho_u_c(*aargs)
    torch.cuda.synchronize()
    max_abs = check_rel("div_rho_u_c", [("G", got, advection.div_rho_u_c_plain(*aargs))],
                        1e-5)
    entries.append(dict(name="div_rho_u_c", route="cuda",
                        source="breeze_tpu_torch/csrc/advection.cu",
                        replaces="breeze_tpu/pallas_kernels/advection.py:214",
                        max_abs_err=max_abs,
                        ms=cuda_ms(lambda: advection.div_rho_u_c(*aargs), 20),
                        plain_ms=cuda_ms(lambda: advection.div_rho_u_c_plain(*aargs), 3),
                        **bound("div_rho_u_c", flat(aargs), [got], g.shape, points)))

    stage, kw = stage_args(model, s, aux, SEED + 3)
    got, launches = counted_stage(stage)
    # float32: the kernel's sweep on d·(1/den) and lo·(1/den) against the
    # plain (d − lo·d′)·(1/den), and FMA contraction, through 7 substeps:
    # 5e-5 of each output's largest value (the TPU kernel's test's limit)
    max_abs = check_rel("acoustic_substeps",
                        zip(acoustic.Perturbations._fields, got,
                            acoustic.acoustic_substeps_plain(*stage)), 5e-5)
    entries.append(dict(name="acoustic_substeps", route="cuda",
                        source="breeze_tpu_torch/csrc/acoustic.cu",
                        replaces="breeze_tpu/pallas_kernels/acoustic.py:876",
                        max_abs_err=max_abs,
                        ms=cuda_ms(lambda: acoustic.acoustic_substeps(*stage), 5),
                        plain_ms=cuda_ms(lambda: acoustic.acoustic_substeps_plain(*stage), 1),
                        **stage_entry("acoustic_substeps", model, stage, kw, got, launches)))
    for e in entries:
        lines.append(f"{e['name']} max abs err {e['max_abs_err']:.3e}, kernel "
                     f"{e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms, bound "
                     f"{e['bound_ms']:.3f} ms ({e['bound_by']})"
                     + (substep_line(e, stage, kw) if "substep_kernel" in e else ""))
    print(f"[7/{PHASES}] compressible kernels at 256x256x128 (acoustic: one 7-substep "
          "stage), each against its plain version: " + "; ".join(lines))
    return entries


def phase_compressible_small(phase: int = 8, **options) -> None:
    """Two bubble steps at 64×32×32 (Δx = 50 m, Δz = 25 m) through the CUDA
    kernels against the same steps through the plain versions on the CPU;
    ``options`` are ``bubble_model``'s.

    The state is :func:`noisy_bubble`'s, so that the momenta are O(1) and
    every term of the step acts on them; from the plain bubble they would
    grow from buoyancy alone, O(1e-2), and carry float32 rounding noise of
    the same order.  Each field of the CUDA run must agree with the CPU
    float32 run within ``C_SMALL_LIMIT`` of its largest value; the distance
    between the CPU float32 and float64 runs of the same steps, printed
    beside it, measures the float32 rounding that limit stands above."""
    runs = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        model = bubble.bubble_model((64, 32, 32), dtype=dtype, device=device,
                                    extent=(3_200.0, 1_600.0, 800.0), **options)
        state = noisy_bubble(model, SEED + 4)
        for _ in range(2):
            state = bt.acoustic_rk3_step(model, state, DT_C)
        runs[device, dtype] = {k: getattr(state, k).cpu().double() for k in C_NAMES}
    worst = []
    for name in C_NAMES:
        ref, f64 = runs["cpu", torch.float32][name], runs["cpu", torch.float64][name]
        scale = float(f64.abs().max())
        err = float((runs["cuda", torch.float32][name] - ref).abs().max()) / scale
        noise = float((ref - f64).abs().max()) / scale
        worst.append(f"{name} {err:.2e} (f32-vs-f64 {noise:.2e})")
        if not err < C_SMALL_LIMIT:
            raise AssertionError(f"64x32x32 bubble after 2 steps, {name}: rel {err:.3e} "
                                 f"(limit {C_SMALL_LIMIT})")
    what = " through the K1/K2 pair" if options.get("per_substep_kernels") else ""
    print(f"[{phase}/{PHASES}] 64x32x32 noisy bubble{what}, 2 steps, CUDA vs CPU plain "
          f"float32 (state-relative, limit {C_SMALL_LIMIT}): " + ", ".join(worst))


def volume_totals(model, state) -> dict:
    """∫ρ dV, ∫ρθ dV (∫ρe dV in ρe) and with moisture ∫ρqᵗ dV, with J in
    σ-coordinates (per unit horizontal area of a cell)."""
    w = model.grid.dz_c_col.double()
    if model.terrain is not None:
        w = w * model.terrain.jac_c3.double()
    return {k: float((getattr(state, k).double() * w).sum())
            for k in ("rho", "rho_theta", "rho_qt") if getattr(state, k) is not None}


#: ms/step of each compressible path, by its name in phase_compressible_slice
STEP_MS = {}


def phase_compressible_slice(model, state, label: str, phase: int = 9,
                             what: str = "dry bubble",
                             drift_bound=C_DRIFT_BOUND) -> tuple[dict, object]:
    """2 warm-up and 10 timed steps; each total in ``drift_bound`` gated,
    every total's drift printed."""
    moist = model.has_moisture
    totals0 = volume_totals(model, state)
    for _ in range(WARMUP):
        state = bt.acoustic_rk3_step(model, state, DT_C)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    momentum.launches = advection.launches = acoustic.launches = columnar.launches = 0
    acoustic_split.k1_launches = acoustic_split.k2_launches = 0
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = bt.acoustic_rk3_step(model, state, DT_C)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = {"momentum_div": momentum.launches, "div_rho_u_c": advection.launches,
              "acoustic_substeps": acoustic.launches, "fix_negative": columnar.launches,
              "acoustic_k1": acoustic_split.k1_launches,
              "acoustic_k2": acoustic_split.k2_launches}
    # three stages of 3 + 4 + 7 substeps: one launch each of K3's
    # counterpart and two a stage (the pivots, the closing pass), or one
    # of K1 and two of K2 (the column solve, E) each; with moisture ρqᵗ
    # through the scalar kernel once a stage and its repair once a step
    split = model.acoustic_config.per_substep_kernels
    plan = C.stage_substep_plan(C.substep_count(model, DT_C), DT_C)
    k3 = sum(n_tau + 2 for n_tau, _ in plan)
    if counts != {"momentum_div": 3 * STEPS, "div_rho_u_c": (6 if moist else 3) * STEPS,
                  "acoustic_substeps": 0 if split else k3 * STEPS,
                  "fix_negative": STEPS if moist else 0,
                  "acoustic_k1": 14 * STEPS if split else 0,
                  "acoustic_k2": 28 * STEPS if split else 0}:
        raise AssertionError(f"the compressible path missed its kernels: {counts}")
    for name in C_NAMES + (("rho_qt",) if moist else ()):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{name} is not finite after {WARMUP + STEPS} steps")
    totals1 = volume_totals(model, state)
    drift = {k: abs(totals1[k] - totals0[k]) / abs(totals0[k]) for k in totals0}
    for k, limit in drift_bound.items():
        if not drift[k] < limit:
            raise AssertionError(f"∫{k} dV drifted by {drift[k]:.3e} (bound {limit})")
    ms = STEP_MS[what] = 1e3 * elapsed / STEPS
    points = SIZE_C[0] * SIZE_C[1] * SIZE_C[2]
    print(f"[{phase}/{PHASES}] 256x256x128 {what}: {ms:.2f} ms/step, "
          f"{points / (ms * 1e-3):.4e} points/s on {label}; launches {counts}; "
          f"max |rho_w| {float(state.rho_w.abs().max()):.3e}; drift "
          + " ".join(f"{k} {v:.2e}" + ("" if k in drift_bound else " (not gated)")
                     for k, v in drift.items())
          + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, state


def phase_compressible_breakdown(model, state, label: str, phase: int = 10,
                                 what: str = "bubble") -> None:
    """One step with the device drained between layers (host clock); with
    moisture the step-start repair and the scalar transport too."""
    spans = {"diagnose+caches": 0.0, "slow tendencies": 0.0, "acoustic loop": 0.0,
             "recovery": 0.0}
    if model.has_moisture:
        spans = {"fix_negative": 0.0, **spans, "scalars": 0.0}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        spans[key] += 1e3 * (time.perf_counter() - t0)
        return out

    plan = C.stage_substep_plan(C.substep_count(model, DT_C), DT_C)
    if model.has_moisture:
        state = timed("fix_negative", lambda: apply_negative_moisture_correction(model, state))
    state_n = state
    def diagnose():
        aux = C.compressible_diagnose(model, state)
        return aux, C.stage_caches(model, state, aux)

    for beta, (n_tau, dtau) in zip(C.WS_RK3_BETAS, plan):
        aux, caches = timed("diagnose+caches", diagnose)
        G = timed("slow tendencies", lambda: C.stage_slow_tendencies(model, state, aux))
        pert = timed("acoustic loop", lambda: C.acoustic_stage(model, state, state_n, caches,
                                                                G, n_tau, dtau))
        new = timed("recovery", lambda: C.recover(model, state, pert))
        if model.has_moisture:
            new = timed("scalars", lambda: C.advance_scalars(model, state_n, state, new, pert,
                                                             n_tau, beta * DT_C, G))
        state = new
    total = sum(spans.values())
    print(f"[{phase}/{PHASES}] one {what} step by layer on {label}, ms (synchronized): "
          + ", ".join(f"{k} {v:.2f}" for k, v in spans.items())
          + f"; total {total:.2f}")


def noisy_ridge(model, seed: int):
    """The bubble over the ridge with noise on the momenta (0.5·N(0, 1)) and
    ρθ (0.05·N(0, 1)), and on ρw (0.2·N(0, 1)) off the surface face, where
    the kinematic bottom sets it from the noisy ρu, ρv."""
    g = model.grid
    rng = np.random.default_rng(seed)
    gauss = lambda sd: torch.as_tensor(rng.normal(0.0, sd, g.shape), dtype=g.dtype,
                                       device=g.device)
    state = ridge.ridge_state(model)
    rho_u, rho_v = state.rho_u + gauss(0.5), state.rho_v + gauss(0.5)
    rho_w = state.rho_w + gauss(0.2)
    rho_w[0] = kinematic_bottom_rho_w(model.terrain, rho_u, rho_v)
    return state.replace(rho_u=rho_u, rho_v=rho_v, rho_w=rho_w,
                         rho_theta=state.rho_theta + gauss(0.05))


#: phase 11's cases: ridge_model's options
TERRAIN_CASES = {"linear": {}, "sleve": SLEVE,
                 "linear+sponge": dict(sponge=C.UpperSponge(depth=SPONGE_DEPTH))}


def branch_stage(case: str, device):
    """The model and one 7-substep stage (``stage_args``) of an acoustic
    branch at 256×256×128 as phases 7, 11 and 15 build it: ``flat`` (the
    noisy dry bubble), a key of ``TERRAIN_CASES`` (the noisy bubble over the
    ridge made to vary in y) or of ``BRANCH_CASES`` (the noisy bubble of
    that configuration)."""
    if case in TERRAIN_CASES:
        model = ridge.ridge_model(SIZE_C, device=device, y_amplitude=0.3, **TERRAIN_CASES[case])
        s, seed = noisy_ridge(model, SEED + 5), SEED + 6
    else:
        model = bubble.bubble_model(SIZE_C, device=device,
                                    **({} if case == "flat" else BRANCH_CASES[case][0]))
        s, seed = (noisy_bubble(model, SEED + 2), SEED + 3) if case == "flat" else (
            noisy_bubble(model, SEED + 8), SEED + 9)
    return (model, *stage_args(model, s, C.compressible_diagnose(model, s), seed))


def phase_terrain_parity(device, registers: dict) -> dict:
    """The terrain branches of the acoustic kernel against the plain loop at
    256×256×128: one entry for the ridge in LinearDecay (the main path's
    branch), with the SLEVE and the sponge cases as its variants."""
    results, lines = [], []
    for case in TERRAIN_CASES:
        model, stage, kw = branch_stage(case, device)
        got, launches = counted_stage(stage, **kw)
        # as phase 7: 5e-5 of each output's largest value
        max_abs = check_rel(f"acoustic_substeps over terrain ({case})",
                            zip(acoustic.Perturbations._fields, got,
                                acoustic.acoustic_substeps_plain(*stage, **kw)), 5e-5)
        instance = "terrain+sponge" if "sponge" in case else "terrain"
        entry = dict(case=case, max_abs_err=max_abs,
                     ms=cuda_ms(lambda: acoustic.acoustic_substeps(*stage, **kw), 5),
                     plain_ms=cuda_ms(lambda: acoustic.acoustic_substeps_plain(*stage, **kw), 1),
                     registers={k: registers.get(f"{k}[{instance}]")
                                for k in ("acoustic_substep", "acoustic_pivot")},
                     **stage_entry("acoustic_substeps_terrain", model, stage, kw, got, launches))
        results.append(entry)
        lines.append(f"{case}: max abs err {max_abs:.3e}, kernel {entry['ms']:.3f} ms, plain "
                     f"{entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.3f} ms "
                     f"({entry['bound_by']})" + substep_line(entry, stage, kw))
        del model, stage, kw, got
        torch.cuda.empty_cache()
    print(f"[11/{PHASES}] acoustic kernel over terrain at 256x256x128 (one 7-substep stage, "
          "a ridge varying in y), against its plain version: " + "; ".join(lines))
    main, *variants = results
    main.pop("case")
    return dict(name="acoustic_substeps_terrain", route="cuda",
                source="breeze_tpu_torch/csrc/acoustic.cu",
                replaces="breeze_tpu/pallas_kernels/acoustic.py:876",
                **main, variants=variants)


def phase_terrain_small() -> None:
    """Two steps of the noisy bubble over the ridge at 64×32×32 (Δx = 50 m,
    Δz = 25 m) through the CUDA kernels against the same steps through the
    plain versions on the CPU, as phase 8; beside each field's distance,
    the CPU float32-vs-float64 distance, and each run's ∫Jρ dV drift."""
    runs, drift = {}, {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        model = ridge.ridge_model((64, 32, 32), dtype=dtype, device=device,
                                  extent=(3_200.0, 1_600.0, 800.0))
        state = noisy_ridge(model, SEED + 7)
        totals0 = volume_totals(model, state)
        for _ in range(2):
            state = bt.acoustic_rk3_step(model, state, DT_C)
        totals1 = volume_totals(model, state)
        drift[device, dtype] = abs(totals1["rho"] - totals0["rho"]) / totals0["rho"]
        runs[device, dtype] = {k: getattr(state, k).cpu().double() for k in C_NAMES}
    worst = []
    for name in C_NAMES:
        ref, f64 = runs["cpu", torch.float32][name], runs["cpu", torch.float64][name]
        scale = float(f64.abs().max())
        err = float((runs["cuda", torch.float32][name] - ref).abs().max()) / scale
        noise = float((ref - f64).abs().max()) / scale
        worst.append(f"{name} {err:.2e} (f32-vs-f64 {noise:.2e})")
        if not err < C_SMALL_LIMIT:
            raise AssertionError(f"64x32x32 ridge after 2 steps, {name}: rel {err:.3e} "
                                 f"(limit {C_SMALL_LIMIT})")
    print(f"[12/{PHASES}] 64x32x32 noisy bubble over the ridge, 2 steps, CUDA vs CPU plain "
          f"float32 (state-relative, limit {C_SMALL_LIMIT}): " + ", ".join(worst)
          + "; ∫Jρ dV drift: " + ", ".join(f"{d} {str(t)[6:]} {v:.2e}"
                                           for (d, t), v in drift.items()))


#: phase 15's cases: (bubble_model's options, the OPS_PER_POINT key, the
#: substep and closing kernels' instances)
BRANCH_CASES = {
    "crho+direct": (dict(moist=True, formulation="static_energy",
                         damping=C.DirectDivergenceDamping(0.1)),
                    "acoustic_substeps_crho_direct", "acoustic_substep[crho]", "acoustic_close"),
    "crho+thermal": (dict(moist=True, formulation="static_energy"),
                     "acoustic_substeps_crho", "acoustic_substep[crho]", "acoustic_close"),
    "theta+direct": (dict(moist=True, damping=C.DirectDivergenceDamping(0.1)),
                     "acoustic_substeps_direct", "acoustic_substep[flat]", "acoustic_close"),
    "bf16": (dict(substep_floattype="bfloat16"), "acoustic_substeps",
             "acoustic_substep[bf16]", "acoustic_close[bf16]"),
}


def phase_branch_parity(device, registers: dict) -> list[dict]:
    """The acoustic kernel's C_ρ, direct-damping and bfloat16 branches
    against the plain loop at 256×256×128, one 7-substep stage each from
    the noisy bubble of the branch's configuration with noise 1e-3·N(0, 1)
    on the five perturbations: one entry for the moist ρe + direct path's
    branch (C_ρ + direct) with the C_ρ + thermal and θ + direct cases as its
    variants, one for the bfloat16 path's."""
    results, lines = {}, []
    for case, (_, ops, substep, close) in BRANCH_CASES.items():
        model, stage, kw = branch_stage(case, device)
        got, launches = counted_stage(stage)
        # float32 as phase 7: 5e-5 of each output's largest value; bfloat16
        # carries may round the other way where the kernel's and the plain
        # version's float32 results straddle a rounding boundary: 3e-2, the
        # TPU kernel's test's limit for them
        limit = 3e-2 if case == "bf16" else 5e-5
        pairs = list(zip(acoustic.Perturbations._fields, got,
                         acoustic.acoustic_substeps_plain(*stage)))
        max_abs = check_rel(f"acoustic_substeps ({case})", pairs, limit)
        worst = max(rel_to_max(g_, r_)[1] for _, g_, r_ in pairs)
        del pairs
        entry = dict(case=case, max_abs_err=max_abs,
                     ms=cuda_ms(lambda: acoustic.acoustic_substeps(*stage), 5),
                     plain_ms=cuda_ms(lambda: acoustic.acoustic_substeps_plain(*stage), 1),
                     registers={k: registers.get(k) for k in (substep, close)},
                     **stage_entry(ops, model, stage, kw, got, launches))
        results[case] = entry
        lines.append(f"{case}: max abs err {max_abs:.3e}, relative {worst:.2e} (limit "
                     f"{limit}), kernel {entry['ms']:.3f} ms, plain {entry['plain_ms']:.3f} ms, "
                     f"bound {entry['bound_ms']:.3f} ms ({entry['bound_by']})"
                     + substep_line(entry, stage, kw))
        del model, stage, kw, got
        torch.cuda.empty_cache()
    print(f"[15/{PHASES}] acoustic kernel's C_ρ, direct and bf16 branches at 256x256x128 "
          "(one 7-substep stage), against its plain version: " + "; ".join(lines))
    entries = []
    for name, main, variants in (("acoustic_substeps_rhoe_direct", "crho+direct",
                                  ("crho+thermal", "theta+direct")),
                                 ("acoustic_substeps_bf16", "bf16", ())):
        entry = results[main]
        entry.pop("case")
        entries.append(dict(name=name, route="cuda", source="breeze_tpu_torch/csrc/acoustic.cu",
                            replaces="breeze_tpu/pallas_kernels/acoustic.py:876", **entry,
                            variants=[results[v] for v in variants]))
    return entries


def phase_moist_small() -> None:
    """Two steps of the noisy moist bubble in ρe with direct damping at
    64×32×32 (Δx = 50 m, Δz = 25 m) through the CUDA kernels against the
    same steps through the plain versions on the CPU, as phase 8; beside
    each field's distance, the CPU float32-vs-float64 distance."""
    kw = MOIST_PATHS["moist_rhoe_direct"][0]
    runs = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        model = bubble.bubble_model((64, 32, 32), dtype=dtype, device=device,
                                    extent=(3_200.0, 1_600.0, 800.0), **kw)
        state = noisy_bubble(model, SEED + 10)
        for _ in range(2):
            state = bt.acoustic_rk3_step(model, state, DT_C)
        runs[device, dtype] = {k: getattr(state, k).cpu().double()
                               for k in C_NAMES + ("rho_qt",)}
    worst = []
    for name in C_NAMES + ("rho_qt",):
        ref, f64 = runs["cpu", torch.float32][name], runs["cpu", torch.float64][name]
        scale = float(f64.abs().max())
        err = float((runs["cuda", torch.float32][name] - ref).abs().max()) / scale
        noise = float((ref - f64).abs().max()) / scale
        worst.append(f"{name} {err:.2e} (f32-vs-f64 {noise:.2e})")
        if not err < C_SMALL_LIMIT:
            raise AssertionError(f"64x32x32 moist rhoe bubble after 2 steps, {name}: rel "
                                 f"{err:.3e} (limit {C_SMALL_LIMIT})")
    print(f"[16/{PHASES}] 64x32x32 noisy moist bubble in rho-e with direct damping, 2 steps, "
          f"CUDA vs CPU plain float32 (state-relative, limit {C_SMALL_LIMIT}): "
          + ", ".join(worst))


def zero_route_counts() -> None:
    tendency.launches = columnar.launches = advection.launches = closure.launches = 0
    momentum.launches = momentum.cols_launches = 0
    projection.div_launches = projection.grad_launches = 0


def route_counts() -> dict:
    return {"fused_tendency": tendency.launches, "momentum_div_cols": momentum.cols_launches,
            "div_rho_u_c": advection.launches, "closure": closure.launches,
            "divergence": projection.div_launches, "gradient_correct": projection.grad_launches,
            "fix_negative": columnar.launches, "momentum_div": momentum.launches}


def check_allclose(what: str, pairs, rtol: float, atol: float) -> float:
    """Each (got, ref) within atol + rtol·|ref| pointwise, as
    ``np.testing.assert_allclose``; returns the largest absolute error."""
    worst = 0.0
    for name, got, ref in pairs:
        diff = (got.double() - ref.double()).abs()
        excess = float((diff - (atol + rtol * ref.double().abs())).max())
        if not excess <= 0.0:
            raise AssertionError(f"{what} {name}: max abs {float(diff.max()):.3e} exceeds "
                                 f"atol {atol} + rtol {rtol}·|ref| by {excess:.3e}")
        worst = max(worst, float(diff.max()))
    return worst


def cols_design(shape) -> str:
    """The column-momentum kernel's design at ``shape``: its field passes
    through device memory (the three velocity windows read at their
    interior, the three divergences written) and the floor they give, and
    how often its ring reads each window's points through L2 (each 32 × 16
    tile with its 3-point halo, each z chunk with three planes below and
    above)."""
    nz, ny, nx = shape
    chunk = momentum.COLS_Z_CHUNK
    moved = 6 * 4 * nz * ny * nx
    ring = (chunk + 6) / chunk * (32 + 6) * (16 + 6) / (32 * 16)
    return (f"design 6 field passes, {moved / 1e9:.3f} GB, floor "
            f"{1e3 * moved / HBM_BYTES_PER_S:.3f} ms; the ring reads each window "
            f"{ring:.2f} times through L2 (z chunk {chunk})")


def phase_route_parity(model, state) -> list[dict]:
    """The four kernels of the anelastic routes against their plain versions
    at the 256³ BOMEX shapes, each at its reference test's limit."""
    g = model.grid
    points = g.nx * g.ny * g.nz
    cfg, cols, ref_state = model.tendency_config, model.tendency_columns, model.reference
    s, s0 = perturbed(model, state, SEED + 1)
    aux = M.diagnose(model, s, T_guess=s.diagnostics["T_warm"])
    _, _, u, v, w, scalars, _, thb = M.tendency_kernel_args(model, s, aux, DT, s0, ALPHA)[:8]
    entries, lines = [], []

    def entry(name, source, replaces, max_abs, fn, plain, inputs, outputs, reps):
        e = dict(name=name, route="cuda", source=f"breeze_tpu_torch/csrc/{source}",
                 replaces=f"breeze_tpu/pallas_kernels/{replaces}", max_abs_err=max_abs,
                 ms=cuda_ms(fn, reps), plain_ms=cuda_ms(plain, 3),
                 **bound(name, inputs, outputs, g.shape, points))
        entries.append(e)
        lines.append(f"{name} max abs err {max_abs:.3e}, kernel {e['ms']:.3f} ms, plain "
                     f"{e['plain_ms']:.3f} ms, bound {e['bound_ms']:.3f} ms ({e['bound_by']})")

    # the column-momentum kernel on the noisy state's velocity windows;
    # TestFusedMomentum's limit, rtol = atol = 5e-4 (row 0 of dw is the wall's)
    margs = (u, v, w, cols.colc, cols.colf, cols.invdzc, cols.invdzf, cfg.inv_dx, cfg.inv_dy)
    got = momentum.momentum_div_cols(*margs)
    torch.cuda.synchronize()
    ref = momentum.momentum_div_cols_plain(*margs)
    max_abs = check_allclose("momentum_div_cols", [("du", got[0], ref[0]), ("dv", got[1], ref[1]),
                                                   ("dw", got[2][1:], ref[2][1:])], 5e-4, 5e-4)
    rel = max(rel_to_max(a[1:], b[1:])[1] for a, b in zip(got, ref))
    del ref
    entry("momentum_div_cols", "momentum.cu", "momentum.py:309", max_abs,
          lambda: momentum.momentum_div_cols(*margs),
          lambda: momentum.momentum_div_cols_plain(*margs), flat(margs), got, 20)
    info = momentum.cols_kernel_info()
    lines[-1] += (f", largest-value-relative {rel:.2e}; {info['registers']} registers, "
                  f"{info['local_bytes']} B local, {info['smem_bytes']} B shared a block, "
                  f"{info['blocks_per_sm']} block(s) per SM; " + cols_design(g.shape))
    del got

    # the closure kernel on the moist windows with θᵥ; TestClosureKernel's
    # limit, 2e-4 of each output's largest value (row 0 of G_w is the wall's)
    cargs = (cfg, cols, u, v, w, thb, scalars)
    got = closure.closure_tendencies(*cargs)
    torch.cuda.synchronize()
    pairs = [(n, a[1:] if n == "G_w" else a, b[1:] if n == "G_w" else b)
             for n, a, b in zip(("G_u", "G_v", "G_w", "G_theta", "G_qt"), got,
                                closure.closure_tendencies_plain(*cargs))]
    max_abs = check_rel("closure", pairs, 2e-4)
    rel = max(rel_to_max(a, b)[1] for _, a, b in pairs)
    del pairs
    entry("closure", "closure.cu", "closure.py:298", max_abs,
          lambda: closure.closure_tendencies(*cargs),
          lambda: closure.closure_tendencies_plain(*cargs),
          flat(u, v, w, thb, scalars, cols.colc, cols.colf, cols.invdzc_e, cols.invdzf_e,
               cols.cd2_e), got, 10)
    lines[-1] += f", largest-value-relative {rel:.2e}"
    del got, cargs, margs, u, v, w, scalars, thb

    # the projection kernels on the third stage's predicted momenta and its
    # φ, at Δt = αΔt = 2/3 s; TestFusedProjection's limit, rtol = atol = 2e-5
    ns = M.stage_update(model, s, s0, DT, ALPHA, aux=aux)
    del aux
    ru, rv, rw = fl.enforce_wall_normals(g, ns.rho_u, ns.rho_v, ns.rho_w)
    del ns
    dargs = (ru, rv, rw, cols.invdzc, cfg.inv_dx, cfg.inv_dy)
    div = projection.divergence(*dargs)
    torch.cuda.synchronize()
    max_abs = check_allclose("divergence", [("delta", div, projection.divergence_plain(*dargs))],
                             2e-5, 2e-5)
    entry("divergence", "projection.cu", "projection.py:86", max_abs,
          lambda: projection.divergence(*dargs), lambda: projection.divergence_plain(*dargs),
          flat(ru, rv, rw, cols.invdzc), [div], 20)
    dt = ALPHA * DT
    phi = model.solver.solve(div, dt)
    gargs = (phi, ru, rv, rw, ref_state.rho_c, ref_state.rho_f[: g.nz], cols.invdzf,
             cfg.inv_dx, cfg.inv_dy, dt)
    got = projection.gradient_correct(*gargs)
    torch.cuda.synchronize()
    max_abs = check_allclose("gradient_correct",
                             zip(("rho_u", "rho_v", "rho_w"), got,
                                 projection.gradient_correct_plain(*gargs)), 2e-5, 2e-5)
    if bool(got[2][0].any()):
        raise AssertionError("gradient_correct left the bottom face of rho_w unpinned")
    entry("gradient_correct", "projection.cu", "projection.py:181", max_abs,
          lambda: projection.gradient_correct(*gargs),
          lambda: projection.gradient_correct_plain(*gargs),
          flat(gargs[:7]), got, 20)
    print(f"[19/{PHASES}] anelastic route kernels at 256^3 BOMEX shapes, each against its "
          "plain version: " + "; ".join(lines))
    return entries


def k2_design(carries, damping: bool) -> str:
    """The field passes a substep of K2's two launches by design (each
    launch's fields read and written once, the neighbours' Δ(ρθ)′ and θᴸ
    from L2) and the floor they give: in float32 K1's four outputs, Cᴸ, θᴸ
    at the faces, G_ρw, the three sums in and out; with the thermal damping
    θᴸ, and Δ(ρθ)′ written and read; in the storage type ρ′, (ρθ)′, ρw′ in,
    the five carries out and ρw′ read again by E for its sum
    (csrc/acoustic_split.cu)."""
    n, c = carries[0].numel(), carries[0].element_size()
    moved = n * (4 * (13 + (3 if damping else 0)) + 9 * c)
    return (f"design {moved / (4 * n):.2f} float32 field passes, {moved / 1e9:.3f} GB, floor "
            f"{1e3 * moved / HBM_BYTES_PER_S:.3f} ms")


def phase_split_parity(device, registers: dict) -> list[dict]:
    """The K1/K2 pair at 256×256×128 on phase 7's stage: each kernel against
    its plain version on the stage's first ungated substep (K2 on the plain
    K1's outputs, so that both see the same inputs), a 7-substep stage
    through the pair against the plain pair, and the same stage through
    K3 in turns with the pair (K3, pair, pair, K3); float32 carries, then
    bfloat16.  One entry per kernel, the float32 instance's numbers with
    the bfloat16 instance as its variant."""
    model = bubble.bubble_model(SIZE_C, device=device)
    g = model.grid
    points = g.nx * g.ny * g.nz
    s = noisy_bubble(model, SEED + 2)
    aux = C.compressible_diagnose(model, s)
    caches = C.stage_caches(model, s, aux)
    G = C.slow_tendencies(model, s, aux)
    del aux, s
    rng = np.random.default_rng(SEED + 3)
    noise = [torch.as_tensor(rng.normal(0.0, 1e-3, g.shape), dtype=g.dtype, device=g.device)
             for _ in range(5)]
    noise[3][0] = 0.0
    zero = torch.zeros_like(noise[0])
    cfg, cols = model.acoustic_config, model.z_columns
    n_tau = 7
    dtau = DT_C / n_tau
    results, lines = {"acoustic_k1": [], "acoustic_k2": []}, []
    for store, label in ((torch.float32, ""), (torch.bfloat16, "[bf16]")):
        carries = tuple(p.to(store) for p in noise)
        k1_args = (cfg, cols, caches, G, carries, dtau, 1.0)
        got = acoustic_split.acoustic_k1(*k1_args)
        torch.cuda.synchronize()
        k1_ref = acoustic_split.acoustic_k1_plain(*k1_args)
        # float32 FMA contraction in a pointwise stencil: 1e-5 of each
        # output's largest value (the carries are read exactly, either type)
        k1_err = check_rel(f"acoustic_k1{label}", zip(("rho_u", "rho_v", "rho_star",
                                                        "rho_theta_star"), got, k1_ref), 1e-5)
        k2_args = (cfg, cols, caches, G.rho_w, carries, k1_ref, dtau)
        k2_out = acoustic_split.acoustic_k2(*k2_args)
        torch.cuda.synchronize()
        # the sweep's two divides against the plain ones and FMA
        # contraction: 5e-5, the TPU kernel's test's limit; bfloat16 outputs
        # may round the other way across a rounding boundary: 3e-2
        limit = 5e-5 if store == torch.float32 else 3e-2
        pairs = list(zip(C_NAMES, k2_out, acoustic_split.acoustic_k2_plain(*k2_args)))
        k2_err = check_rel(f"acoustic_k2{label}", pairs, limit)
        k2_rel = max(rel_to_max(a, b)[1] for _, a, b in pairs)
        pert = acoustic.Perturbations(*carries, zero, zero, zero)
        stage = (cfg, cols, caches, G, pert, dtau, n_tau, True)
        got = acoustic_split.acoustic_substeps_split(*stage)
        torch.cuda.synchronize()
        pairs = list(zip(acoustic.Perturbations._fields, got,
                         acoustic_split.acoustic_substeps_split_plain(*stage)))
        stage_err = check_rel(f"K1/K2 stage{label}", pairs, limit)
        stage_rel = max(rel_to_max(a, b)[1] for _, a, b in pairs)
        del got, pairs
        # K2 as the split loop runs it, adding to the stage's sums in place,
        # and the plain K2 with the three adds the plain loop makes
        sums = [torch.zeros(g.shape, dtype=g.dtype, device=g.device) for _ in range(3)]

        def k2_sums_plain():
            for acc, c in zip(sums, acoustic_split.acoustic_k2_plain(*k2_args)[1:4]):
                acc.add_(c.to(acc.dtype))

        times = {"k1": cuda_ms(lambda: acoustic_split.acoustic_k1(*k1_args), 20),
                 "k2": cuda_ms(lambda: acoustic_split.acoustic_k2_sums(*k2_args, sums, sums),
                               20),
                 "k2_without_sums": cuda_ms(lambda: acoustic_split.acoustic_k2(*k2_args), 20),
                 "k1_plain": cuda_ms(lambda: acoustic_split.acoustic_k1_plain(*k1_args), 3),
                 "k2_plain": cuda_ms(k2_sums_plain, 1)}
        # the A/B in turns: K3, pair, pair, K3
        k3_fn = lambda: acoustic.acoustic_substeps(*stage)
        pair_fn = lambda: acoustic_split.acoustic_substeps_split(*stage)
        ab = [cuda_ms(fn, 5) for fn in (k3_fn, pair_fn, pair_fn, k3_fn)]
        k3_ms, pair_ms = 0.5 * (ab[0] + ab[3]), 0.5 * (ab[1] + ab[2])
        k1_inputs = flat(carries, caches.C_L, caches.theta_L, caches.theta_L_zf, G.rho_u,
                         G.rho_v, G.rho, G.rho_theta, cols.inv_dzc)
        k2_inputs = flat(k1_ref, carries[0], carries[3], carries[4], G.rho_w, caches.C_L,
                         caches.theta_L, caches.theta_L_zf, cols.inv_dzc, cols.inv_dzf)
        stage_ms = {"pair": pair_ms, "k3": k3_ms, "turns": ab,
                    "pair_per_substep": pair_ms / n_tau, "k3_per_substep": k3_ms / n_tau}
        for name, err, ms, plain_ms, bnd in (
                ("acoustic_k1", k1_err, times["k1"], times["k1_plain"],
                 bound("acoustic_k1", k1_inputs, k1_ref, g.shape, points)),
                ("acoustic_k2", k2_err, times["k2"], times["k2_plain"],
                 bound("acoustic_k2", k2_inputs + sums, [*k2_out, *sums], g.shape, points))):
            results[name].append(dict(case="bf16" if label else "float32", max_abs_err=err,
                                      ms=ms, plain_ms=plain_ms,
                                      registers=registers.get(name + label),
                                      stage_ms=stage_ms, stage_max_abs_err=stage_err,
                                      **bnd))
        results["acoustic_k2"][-1]["ms_without_sums"] = times["k2_without_sums"]
        info = acoustic_split.k2_kernel_info(g.nz, store == torch.bfloat16)
        lines.append(
            f"{'bfloat16' if label else 'float32'} carries: K1 {times['k1']:.3f} ms (plain "
            f"{times['k1_plain']:.3f}, bound {results['acoustic_k1'][-1]['bound_ms']:.3f}, "
            f"max abs err {k1_err:.3e}, {registers.get('acoustic_k1' + label)}), K2 "
            f"{times['k2']:.3f} ms with the stage's sums, {times['k2_without_sums']:.3f} "
            f"without (plain with the sums {times['k2_plain']:.3f}, bound with them "
            f"{results['acoustic_k2'][-1]['bound_ms']:.3f}, max abs err {k2_err:.3e}, relative "
            f"{k2_rel:.2e}; {k2_design(carries, bool(cfg.damping))}; column kernel "
            f"{info['registers']} registers, "
            f"{info['local_bytes']} B local, {info['smem_bytes']} B shared a block, "
            f"{info['blocks_per_sm']} block(s) per SM; E {registers.get('acoustic_k2e' + label)}"
            f"); 7-substep stage max abs "
            f"err {stage_err:.3e}, relative {stage_rel:.2e} (limit {limit}); stage in turns "
            "K3/pair/pair/K3 "
            + "/".join(f"{t:.3f}" for t in ab)
            + f" ms: pair {pair_ms / n_tau:.3f}, K3 {k3_ms / n_tau:.3f} ms per substep, "
            f"{14 * pair_ms / n_tau:.2f} and {14 * k3_ms / n_tau:.2f} ms per step")
        del carries, pert, stage, k1_args, k2_args, k1_ref, k2_out, sums
    print(f"[23/{PHASES}] the K1/K2 pair at 256x256x128 on phase 7's stage, against its "
          "plain versions and K3: " + "; ".join(lines))
    del model, caches, G, noise
    torch.cuda.empty_cache()
    entries = []
    for name, replaces in (("acoustic_k1", "acoustic.py:182"), ("acoustic_k2", "acoustic.py:364")):
        main, variant = results[name]
        main.pop("case")
        entries.append(dict(name=name, route="cuda",
                            source="breeze_tpu_torch/csrc/acoustic_split.cu",
                            replaces=f"breeze_tpu/pallas_kernels/{replaces}", **main,
                            variants=[variant]))
    return entries


def compare_states(what: str, got, ref, limit: float) -> str:
    """Each field of ``got`` within ``limit`` of ``ref``'s largest value;
    returns the distances."""
    parts = []
    for name in C_NAMES:
        err, rel = rel_to_max(getattr(got, name), getattr(ref, name))
        parts.append(f"{name} {rel:.2e}")
        if not rel < limit:
            raise AssertionError(f"{what}, {name}: rel {rel:.3e} (limit {limit})")
    return ", ".join(parts)


def main() -> int:
    name, smi = phase_device()
    registers = phase_build()
    device = torch.device("cuda", 0)
    model = bomex.bomex_model(SIZE, dtype=torch.float32, device=device)
    noise = 0.1 * np.random.default_rng(SEED).standard_normal(model.grid.shape)
    state = bomex.bomex_state(model, noise)
    entries = phase_parity(model, state)
    phase_small_reference("bomex", 4)
    bomex_per_step, state = phase_slice(model, state, smi, "bomex", 5)
    counts = {k: v * STEPS for k, v in bomex_per_step.items()}
    phase_breakdown(model, state, smi)
    del model, state
    model = bubble.bubble_model(SIZE_C, dtype=torch.float32, device=device)
    entries += phase_compressible_parity(model)
    phase_compressible_small()
    c_counts, state = phase_compressible_slice(model, bubble.bubble_state(model), smi)
    phase_compressible_breakdown(model, state, smi)
    counts.update({k: v for k, v in c_counts.items() if k != "fix_negative"})
    bubble_k3_state = state   # phase 25 holds the split path's state to it
    del model, state
    torch.cuda.empty_cache()
    entries.append(phase_terrain_parity(device, registers))
    phase_terrain_small()
    model = ridge.ridge_model(SIZE_C, device=device)
    r_counts, state = phase_compressible_slice(model, ridge.ridge_state(model), smi, 13,
                                               "bubble over the ridge", RIDGE_DRIFT_BOUND)
    phase_compressible_breakdown(model, state, smi, 14, "ridge")
    counts["acoustic_substeps_terrain"] = r_counts["acoustic_substeps"]
    del model, state
    torch.cuda.empty_cache()
    # launches per step of every kernel on each path
    per_step = {"bomex": bomex_per_step,
                "bubble": {k: v / STEPS for k, v in c_counts.items()},
                "ridge": {k: v / STEPS for k, v in r_counts.items()}}
    entries += phase_branch_parity(device, registers)
    phase_moist_small()
    for path, (kw, gates) in MOIST_PATHS.items():
        model = bubble.bubble_model(SIZE_C, device=device, **kw)
        p_counts, state = phase_compressible_slice(model, bubble.bubble_state(model), smi, 17,
                                                   path.replace("_", " ") + " bubble", gates)
        per_step[path] = {k: v / STEPS for k, v in p_counts.items()}
        if path == "moist_rhoe_direct":
            rhoe = model, state
        del model, state
        torch.cuda.empty_cache()
    phase_compressible_breakdown(*rhoe, smi, 18, "moist rho-e + direct")
    counts["acoustic_substeps_rhoe_direct"] = per_step["moist_rhoe_direct"][
        "acoustic_substeps"] * STEPS
    counts["acoustic_substeps_bf16"] = per_step["bf16"]["acoustic_substeps"] * STEPS
    del rhoe
    torch.cuda.empty_cache()

    model = bomex.bomex_model(SIZE, device=device)
    entries += phase_route_parity(model, bomex.bomex_state(model, noise))
    del model
    torch.cuda.empty_cache()
    phase_small_reference("bomex_beta", 20)
    model = bomex.bomex_model(SIZE, device=device, coriolis=bomex.BETA_PLANE)
    per_step["bomex_beta"], state = phase_slice(model, bomex.bomex_state(model, noise), smi,
                                                "bomex_beta", 21)
    phase_breakdown(model, state, smi, 22, "bomex_beta step")
    del model, state
    torch.cuda.empty_cache()

    entries += phase_split_parity(device, registers)
    phase_compressible_small(24, per_substep_kernels=True)
    for path, (kw, gates) in SPLIT_PATHS.items():
        model = bubble.bubble_model(SIZE_C, device=device, **kw)
        what = ("bf16" if path == "bf16_split" else "dry") + " bubble through K1/K2"
        s_counts, state = phase_compressible_slice(model, bubble.bubble_state(model), smi, 25,
                                                   what, gates)
        per_step[path] = {k: v / STEPS for k, v in s_counts.items()}
        if path == "bubble_split":
            print(f"[25/{PHASES}] through K3 (phases 9, 17): dry bubble "
                  f"{STEP_MS['dry bubble']:.2f} ms/step, bf16 bubble {STEP_MS['bf16 bubble']:.2f}"
                  f" ms/step; the dry split path's state after {WARMUP + STEPS} steps "
                  f"against the K3 path's (phase 9), each field against its largest value "
                  f"(limit {SPLIT_VS_K3_LIMIT}): "
                  + compare_states("split against K3", state, bubble_k3_state,
                                   SPLIT_VS_K3_LIMIT))
            phase_compressible_breakdown(model, state, smi, 26, "split bubble")
            counts["acoustic_k1"] = s_counts["acoustic_k1"]
            counts["acoustic_k2"] = s_counts["acoustic_k2"]
        del model, state
        torch.cuda.empty_cache()
    del bubble_k3_state
    for kernel in ("momentum_div_cols", "closure"):
        counts[kernel] = per_step["bomex_beta"][kernel] * STEPS
    # the acoustic wrapper counts its instances together; each acoustic entry
    # measures the instance that one path's model runs
    acoustic_instance = {"bubble": "acoustic_substeps", "ridge": "acoustic_substeps_terrain",
                         "moist_theta": "acoustic_substeps",
                         "moist_rhoe_direct": "acoustic_substeps_rhoe_direct",
                         "bf16": "acoustic_substeps_bf16"}

    def launches_per_step(kernel, path):
        if kernel.startswith("acoustic_substeps"):
            runs = acoustic_instance.get(path) == kernel
            return per_step[path].get("acoustic_substeps", 0) if runs else 0
        return per_step[path].get(kernel, 0)

    kernel_registers = {"fused_tendency": ("fused_tendency",),
                        "fix_negative": ("fix_negative",),
                        "momentum_div": ("momentum_div",), "div_rho_u_c": ("div_rho_u_c",),
                        "acoustic_substeps": ("acoustic_substep[flat]",
                                              "acoustic_pivot[flat]", "acoustic_close"),
                        "acoustic_substeps_terrain": ("acoustic_substep[terrain]",
                                                      "acoustic_pivot[terrain]",
                                                      "acoustic_close"),
                        "acoustic_substeps_rhoe_direct": ("acoustic_substep[crho]",
                                                          "acoustic_pivot[crho]",
                                                          "acoustic_close"),
                        "acoustic_substeps_bf16": ("acoustic_substep[bf16]",
                                                   "acoustic_pivot[flat]",
                                                   "acoustic_close[bf16]"),
                        "momentum_div_cols": ("momentum_div_cols",),
                        "closure": ("closure_nu", "closure_tendencies"),
                        "divergence": ("divergence",),
                        "gradient_correct": ("gradient_correct",),
                        "acoustic_k1": ("acoustic_k1", "acoustic_k1[bf16]"),
                        "acoustic_k2": ("acoustic_k2", "acoustic_k2[bf16]", "acoustic_k2e",
                                        "acoustic_k2e[bf16]")}
    for entry in entries:
        kernel = entry["name"]
        entry["launches"] = int(counts[kernel])
        entry["registers"] = {k: registers.get(k) for k in kernel_registers[kernel]}
        entry["launches_per_step"] = {path: launches_per_step(kernel, path)
                                      for path in per_step}
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
