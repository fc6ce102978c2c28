// Negative-moisture vertical borrowing for sm_90a, one thread per (y, x)
// column.
//
// Replaces breeze_tpu/pallas_kernels/columnar.py::fix_negative_moisture_pallas.
// The Python wrapper and the plain PyTorch version are in
// breeze_tpu_torch/kernels/columnar.py.
//
// In m = rho_q * dz units the top-to-bottom recurrence
//   new = m[k] + carry,  out[k] = max(new, 0),  carry = min(new, 0)
// runs in registers; the bottom level then absorbs the carry and borrows
// min(needed, available) from level 1.  Bound: device memory, one read and
// one write of the field; neighbouring threads take neighbouring x, so each
// level's load and store is coalesced.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__global__ void fix_negative_kernel(const float* __restrict__ rq,
                                    const float* __restrict__ dz,
                                    float* __restrict__ out,
                                    int nz, int ny, int nx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (i >= nx) return;
  const size_t plane = (size_t)ny * nx;
  const size_t col = (size_t)j * nx + i;
  if (nz == 1) {
    out[col] = rq[col];
    return;
  }
  float carry = 0.0f, lvl1 = 0.0f;
  for (int k = nz - 1; k >= 1; --k) {
    const float dzk = __ldg(dz + k);
    const float nw = rq[k * plane + col] * dzk + carry;
    const float o = fmaxf(nw, 0.0f);
    carry = fminf(nw, 0.0f);
    if (k == 1) {
      lvl1 = o;
    } else {
      out[k * plane + col] = o / dzk;
    }
  }
  const float m0 = rq[col] * __ldg(dz) + carry;
  const float take = m0 < 0.0f ? fminf(-m0, fmaxf(lvl1, 0.0f)) : 0.0f;
  out[col] = (m0 + take) / __ldg(dz);
  out[plane + col] = (lvl1 - take) / __ldg(dz + 1);
}

}  // namespace

extern "C" int breeze_fix_negative(const void* rq, const void* dz, void* out,
                                   int nz, int ny, int nx, void* stream) {
  const dim3 block(128, 1, 1);
  const dim3 grid((nx + block.x - 1) / block.x, ny, 1);
  fix_negative_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rq), static_cast<const float*>(dz),
      static_cast<float*>(out), nz, ny, nx);
  return static_cast<int>(cudaGetLastError());
}
