"""Where the device time of one step goes, by kind of work.

Run on a machine with one NVIDIA GPU, from the repository root:

    python3 -m breeze_tpu_torch.profile_step [--case CASE] [--trace FILE]

It builds the 256³ BOMEX model (anelastic, SSP-RK3 at Δt = 1 s; ``bomex``,
or ``bomex_beta`` on its β-plane), the 256×256×128 dry bubble
(compressible, WS-RK3 at Δt = 0.5 s; ``bubble``, or ``bubble_split``
through the per-substep acoustic pair K1/K2), that bubble over the ridge
(σ-coordinates, ``ridge.py``) or the moist bubble in ρe with direct
damping, runs three warm-up steps, times two steps without the profiler (host clock ending in a synchronize), then traces
as many again with ``torch.profiler``.  From the trace's device events
(kernels, copies, sets) it prints the device time and launches per step of
each kind of work, and the device's busy share against the unprofiled and
the profiled wall time.  ``--trace`` keeps the Chrome trace.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from . import bomex, bubble, ridge
from .dynamics.compressible import DirectDivergenceDamping, acoustic_rk3_step
from .timesteppers import ssp_rk3_step

STEPS = 2
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OWN_KERNELS = ("fused_tendency_kernel", "fix_negative_kernel",
               "momentum_div_cols_kernel", "momentum_div_kernel", "div_rho_u_c_kernel",
               "acoustic_substep_kernel", "acoustic_pivot_kernel", "acoustic_close_kernel",
               "acoustic_k1_kernel", "acoustic_k2_kernel", "acoustic_k2e_kernel",
               "closure_nu_kernel",
               "closure_tendencies_kernel", "divergence_kernel", "gradient_correct_kernel")
BOMEX_ROUTES = {"bomex": {}, "bomex_beta": dict(coriolis=bomex.BETA_PLANE)}


def kind(event: dict) -> str:
    """The kind of device work a trace event is."""
    name = event["name"]
    for own in OWN_KERNELS:
        if own in name:
            return own
    if event["cat"] != "kernel":
        return event["cat"]
    lower = name.lower()
    if "fft" in lower:
        return "cuFFT"
    if "complex" in lower:
        return "complex64 elementwise (Thomas loop)"
    if "cat" in lower or "copy" in lower:
        return "cat / copy (window pads)"
    return "float32 elementwise and reductions"


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--case", choices=(*BOMEX_ROUTES, "bubble", "bubble_split", "ridge",
                                           "moist"),
                        default="bomex")
    parser.add_argument("--trace", help="keep the Chrome trace here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    if args.case in BOMEX_ROUTES:
        size, label = (256, 256, 256), f"256^3 {args.case}"
        model = bomex.bomex_model(size, device="cuda", **BOMEX_ROUTES[args.case])
        noise = 0.1 * np.random.default_rng(1).standard_normal(model.grid.shape)
        state = bomex.bomex_state(model, noise)
        step = lambda s: ssp_rk3_step(model, s, 1.0)
    else:
        size = (256, 256, 128)
        if args.case in ("bubble", "bubble_split"):
            split = args.case == "bubble_split"
            label = "256x256x128 dry bubble" + (" through K1/K2" if split else "")
            model = bubble.bubble_model(size, device="cuda", per_substep_kernels=split)
        elif args.case == "moist":
            label = "256x256x128 moist bubble in rho-e with direct damping"
            model = bubble.bubble_model(size, device="cuda", moist=True,
                                        formulation="static_energy",
                                        damping=DirectDivergenceDamping(0.1))
        else:
            label = "256x256x128 bubble over the ridge"
            model = ridge.ridge_model(size, device="cuda")
        state = bubble.bubble_state(model)
        step = lambda s: acoustic_rk3_step(model, s, 0.5)
    for _ in range(3):
        state = step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = step(state)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / STEPS

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state = step(state)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not events:
        raise SystemExit("profile_step: the trace holds no device events")

    per_kind = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        per_kind[kind(e)][0] += e["dur"] / 1e3 / STEPS
        per_kind[kind(e)][1] += 1 / STEPS
    device_ms = sum(ms for ms, _ in per_kind.values())
    print(f"{smi}; {label}, {STEPS} steps")
    print(f"unprofiled wall {wall_ms:.2f} ms/step, profiled wall {traced_ms:.2f} ms/step, "
          f"device {device_ms:.2f} ms/step in {sum(c for _, c in per_kind.values()):.0f} "
          f"launches/step")
    print(f"device busy {device_ms / wall_ms:.3f} of the unprofiled step, "
          f"{device_ms / traced_ms:.3f} of the profiled one")
    for name, (ms, count) in sorted(per_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"{ms:10.3f} ms/step {count:8.0f} launches/step  {name}")


if __name__ == "__main__":
    main()
