"""The least time an H100 could take for each TPU kernel the port has not
ported yet, at the shapes of the path that would run it.

    python3 -m breeze_tpu_torch.kernel_bounds

The bound is reckoned as ``chip_smoke.py`` reckons it for the ported
kernels: the larger of the bytes the function must move (each full-field
input read once, each output written once, float32; the (nz,) columns and
scalars are negligible and left out) over 3.35 TB/s, and its float32
operations (per output point, counted from the Pallas sources) over
67 TFLOP/s.  Arithmetic on shapes alone: it needs no card and runs
anywhere.
"""

from __future__ import annotations

HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
BUBBLE = (256, 256, 128)

#: (row in PERF.md, kernel, path and shape, full-field inputs, outputs,
#: float32 operations per output point)
KERNELS = (
    (10, "acoustic.py:182 _run_k1 (one substep)",
     "compressible 256x256x128 bubble, split pair", BUBBLE, 12, 4,
     46),    # A 12, B 34
    (11, "acoustic.py:364 _run_k2 (one substep)",
     "compressible 256x256x128 bubble, split pair", BUBBLE, 11, 5,
     61),    # C 35, D 10, E 16
)


def bound(shape, fields_in: int, fields_out: int, ops: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of one launch at ``shape`` (nx, ny, nz)."""
    points = shape[0] * shape[1] * shape[2]
    t_bytes = 1e3 * 4 * points * (fields_in + fields_out) / HBM_BYTES_PER_S
    t_ops = 1e3 * ops * points / F32_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main() -> None:
    print("| # | TPU kernel | path, shape (x, y, z) | in + out fields | ops/point "
          "| bound ms (by) |")
    print("| --- | --- | --- | --- | --- | --- |")
    for row, name, path, shape, n_in, n_out, ops in KERNELS:
        ms, by = bound(shape, n_in, n_out, ops)
        print(f"| {row} | {name} | {path}, {shape} | {n_in} + {n_out} | {ops} "
              f"| {ms:.3f} ({by}) |")


if __name__ == "__main__":
    main()
