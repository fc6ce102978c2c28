"""Where the device time of one 256³ BOMEX step goes, by kind of work.

Run on a machine with one NVIDIA GPU, from the repository root:

    python3 -m breeze_tpu_torch.profile_step [--trace FILE]

It builds the 256³ BOMEX model, runs three warm-up steps, times two steps
without the profiler (host clock ending in a synchronize), then traces
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

from . import bomex
from .timesteppers import ssp_rk3_step

SIZE, STEPS = 256, 2
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OWN_KERNELS = ("fused_tendency_kernel", "smagorinsky_nu_kernel", "fix_negative_kernel")


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
    parser.add_argument("--trace", help="keep the Chrome trace here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    model = bomex.bomex_model((SIZE,) * 3, dtype=torch.float32, device="cuda")
    noise = 0.1 * np.random.default_rng(1).standard_normal(model.grid.shape)
    state = bomex.bomex_state(model, noise)
    for _ in range(3):
        state = ssp_rk3_step(model, state, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = ssp_rk3_step(model, state, 1.0)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / STEPS

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state = ssp_rk3_step(model, state, 1.0)
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
    print(f"{smi}; {SIZE}^3 BOMEX, {STEPS} steps")
    print(f"unprofiled wall {wall_ms:.2f} ms/step, profiled wall {traced_ms:.2f} ms/step, "
          f"device {device_ms:.2f} ms/step in {sum(c for _, c in per_kind.values()):.0f} "
          f"launches/step")
    print(f"device busy {device_ms / wall_ms:.3f} of the unprofiled step, "
          f"{device_ms / traced_ms:.3f} of the profiled one")
    for name, (ms, count) in sorted(per_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"{ms:10.3f} ms/step {count:8.0f} launches/step  {name}")


if __name__ == "__main__":
    main()
