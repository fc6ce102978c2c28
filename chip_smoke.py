#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``breeze_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root with one card visible:

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. the device: ``torch.cuda`` must be available; the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``breeze_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version at the 256³ BOMEX shapes
   (the tendency kernel on a state with noise on every prognostic, its G
   and its increment each measured against their own size), with both
   times;
4. a small BOMEX run through the kernels against the same run through the
   plain versions on the CPU;
5. the slice: 256³ BOMEX (``bench.py``'s configuration, random θ noise from
   a fixed seed), 2 warm-up and 10 timed SSP-RK3 steps at Δt = 1 s, with the
   launch counts, finiteness and the ∫ρθΔz / ∫ρqᵗΔz drift checked;
6. a per-layer breakdown of one more step.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import breeze_tpu_torch as bt
from breeze_tpu_torch import bomex
from breeze_tpu_torch import model as M
from breeze_tpu_torch.kernels import _build, columnar, tendency
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
    print(f"[1/6] device: {name}, {torch.cuda.device_count()} visible, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.library()
    report, entry = [], ""
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = next((k for k in ("fused_tendency", "smagorinsky_nu",
                                      "fix_negative") if k in line), "?")
        elif "spill stores" in line:
            spills = line.split(",")[1].strip()
        elif "Used" in line and "registers" in line and entry:
            regs = line.split("Used")[1].split(",")[0].strip()
            report.append(f"{entry}: {regs}, {spills}")
    print(f"[2/6] built kernels in {time.perf_counter() - t0:.1f} s; "
          + "; ".join(report))


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
    entries = [dict(name="fused_tendency", route="cuda",
                    source="breeze_tpu_torch/csrc/tendency.cu",
                    replaces="breeze_tpu/pallas_kernels/tendency.py:360",
                    max_abs_err=max_abs, ms=t_kernel, plain_ms=t_plain)]
    print(f"[3/6] fused_tendency 256^3 stage, noise on every prognostic: max abs "
          f"err of G {max_abs:.3e}; G-relative {worst['G']:.2e}, "
          f"increment-relative {worst['increment']:.2e} (limit 1e-5); "
          f"kernel {t_kernel:.3f} ms, plain {t_plain:.3f} ms")
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
                        max_abs_err=max_abs, ms=t_kernel, plain_ms=t_plain))
    print(f"[3/6] fix_negative 256^3: max abs err {max_abs:.3e}; kernel "
          f"{t_kernel:.3f} ms, plain {t_plain:.3f} ms (uniform Δz); "
          f"{times[1][0]:.3f} / {times[1][1]:.3f} ms (stretched)")
    return entries


def phase_small_reference() -> None:
    """Two BOMEX steps at 64×32×32 through the CUDA kernels against the same
    steps through the plain versions on the CPU."""
    size, nz_ny_nx = (64, 32, 32), (32, 32, 64)
    noise = 0.1 * np.random.default_rng(SEED).standard_normal(nz_ny_nx)
    runs = {}
    for device in ("cuda", "cpu"):
        model = bomex.bomex_model(size, dtype=torch.float32, device=device)
        state = bomex.bomex_state(model, noise)
        for _ in range(2):
            state = bt.ssp_rk3_step(model, state, DT)
        runs[device] = state
    # the projection couples the momenta, so each momentum component is
    # measured against the largest momentum; scalars against themselves
    cpu = {k: getattr(runs["cuda"], k).cpu() for k in NAMES}
    ref = {k: getattr(runs["cpu"], k) for k in NAMES}
    mom_scale = max(float(ref[k].abs().max()) for k in NAMES[:3])
    worst = []
    for name in NAMES:
        err = float((cpu[name].double() - ref[name].double()).abs().max())
        scale = mom_scale if name in NAMES[:3] else float(ref[name].abs().max())
        worst.append(f"{name} {err / scale:.1e}")
        # float32 reassociation between the kernel and the plain version,
        # carried through six stages and projections
        if not err / scale < 1e-5:
            raise AssertionError(f"64x32x32 after 2 steps, {name}: abs {err:.3e} "
                                 f"rel {err / scale:.3e}")
    print("[4/6] 64x32x32 BOMEX, 2 steps, CUDA vs CPU plain (state-relative): "
          + ", ".join(worst))


def phase_slice(model, state, label: str) -> tuple[dict, object]:
    totals0 = column_totals(model, state)
    for _ in range(WARMUP):
        state = bt.ssp_rk3_step(model, state, DT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tendency.launches = 0
    columnar.launches = 0
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = bt.ssp_rk3_step(model, state, DT)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = {"fused_tendency": tendency.launches, "fix_negative": columnar.launches}
    if counts["fused_tendency"] != 3 * STEPS or counts["fix_negative"] < STEPS:
        raise AssertionError(f"the main path missed its kernels: {counts}")
    for name in NAMES:
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{name} is not finite after {WARMUP + STEPS} steps")
    totals1 = column_totals(model, state)
    drift = {k: abs(totals1[k] - totals0[k]) / abs(totals0[k]) for k in totals0}
    for k, bound in DRIFT_BOUND.items():
        if not drift[k] < bound:
            raise AssertionError(f"∫{k}Δz drifted by {drift[k]:.3e} (bound {bound})")
    ms = 1e3 * elapsed / STEPS
    points = SIZE[0] * SIZE[1] * SIZE[2]
    print(f"[5/6] 256^3 BOMEX: {ms:.2f} ms/step, {points / (ms * 1e-3):.4e} points/s "
          f"on {label}; launches {counts}; drift θ {drift['rho_theta']:.2e} "
          f"qt {drift['rho_qt']:.2e}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, state


def phase_breakdown(model, state, label: str) -> None:
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
    print(f"[6/6] one step by layer on {label}, ms (synchronized): "
          + ", ".join(f"{k} {v:.2f}" for k, v in spans.items())
          + f"; total {total:.2f}")


def main() -> int:
    name, smi = phase_device()
    phase_build()
    device = torch.device("cuda", 0)
    model = bomex.bomex_model(SIZE, dtype=torch.float32, device=device)
    noise = 0.1 * np.random.default_rng(SEED).standard_normal(model.grid.shape)
    state = bomex.bomex_state(model, noise)
    entries = phase_parity(model, state)
    phase_small_reference()
    counts, state = phase_slice(model, state, smi)
    phase_breakdown(model, state, smi)
    for entry in entries:
        entry["launches"] = counts[entry["name"]]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
