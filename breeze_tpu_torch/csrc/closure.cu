// The Smagorinsky-Lilly closure as a pass of its own, for sm_90a: the stress
// and diffusive-flux divergences, one thread per output point.
//
// Replaces breeze_tpu/pallas_kernels/closure.py::closure_tendencies_pallas
// (the pl.pallas_call in _run, body _smag_block), the split form of the
// fused tendency kernel's closure epilogue.  The Python wrapper and the plain
// PyTorch version are in breeze_tpu_torch/kernels/closure.py; the device
// code is smagorinsky.cuh, which the fused tendency kernel includes too.
//
// Inputs: u, v, w, θᵥ (or θ), θ and (moist) qᵗ as windows padded by HALO in z
// and y; the padded columns ρᵣ at centers and faces, the closure's 1/Δz at
// centers and faces and (CΔ)².  Outputs G_u, G_v, G_w, G_θ, (G_qᵗ)
// (nz, ny, nx); row 0 of G_w reads below-wall data, which the wall
// condition overwrites.
//
// Bound: device memory at 256³.  Six windows read and five fields written
// (~740 MB) take ~0.22 ms at 3.35 TB/s; the ~390 float32 operations per
// point take ~0.10 ms at 67 TFLOP/s.  Two launches, as the fused kernel:
// pass 1 writes ν at centers, pass 2 reads it (the z-wall mirror is a clamp
// of the level) and writes the tendencies.  The 4-point ν averages and the
// strains are recomputed per output; tiling through shared memory is left
// for later.

#include "smagorinsky.cuh"

namespace {

struct CloArgs {
  const float *u, *v, *w, *thb, *th, *qt;
  const float *colc, *colf, *invdzc_e, *invdzf_e, *cd2_e;
  float* out[5];
  float* nu;
  int nz, ny, nx, K, buoy_corr;
  float inv_dx, inv_dy, prandtl, inv_prandtl, g_acc;
};

__global__ void __launch_bounds__(256) closure_nu_kernel(CloArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int nyp = a.ny + 2 * HALO;
  const Win U{a.u, nyp, a.nx}, V{a.v, nyp, a.nx}, W{a.w, nyp, a.nx}, TB{a.thb, nyp, a.nx};
  const Col izc{a.invdzc_e}, izf{a.invdzf_e}, cd2{a.cd2_e};
  a.nu[((size_t)k * a.ny + j) * a.nx + i] = smagorinsky_nu(
      U, V, W, TB, izc, izf, cd2, k, j, i, a.nz, a.inv_dx, a.inv_dy, a.buoy_corr, a.g_acc,
      a.prandtl);
}

__global__ void __launch_bounds__(256) closure_tendencies_kernel(CloArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int nyp = a.ny + 2 * HALO;
  const Win U{a.u, nyp, a.nx}, V{a.v, nyp, a.nx}, W{a.w, nyp, a.nx};
  const Col colc{a.colc}, colf{a.colf}, izc_e{a.invdzc_e}, izf_e{a.invdzf_e};
  const float* scal[2] = {a.th, a.qt};
  float g[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  smagorinsky_tendencies(U, V, W, scal, a.K, a.nu, colc, colf, izc_e, izf_e, k, j, i,
                         a.nz, a.ny, a.nx, a.inv_dx, a.inv_dy, a.inv_prandtl, g);
  const size_t p = ((size_t)k * a.ny + j) * a.nx + i;
  for (int n = 0; n < 3 + a.K; ++n) a.out[n][p] = g[n];
}

}  // namespace

extern "C" {

// ptrs: u, v, w, thb, th, qt, colc, colf, invdzc_e, invdzf_e, cd2_e, out[5],
// nu; ints: nz, ny, nx, K, buoy_corr; floats: inv_dx, inv_dy, prandtl,
// 1/prandtl, g (see kernels/closure.py).
int breeze_closure_tendencies(const void* const* ptrs, const int* ints,
                              const float* floats, void* stream) {
  CloArgs a;
  int n = 0;
  const float** in[] = {&a.u, &a.v, &a.w, &a.thb, &a.th, &a.qt, &a.colc, &a.colf,
                        &a.invdzc_e, &a.invdzf_e, &a.cd2_e};
  for (const float** dst : in) *dst = static_cast<const float*>(ptrs[n++]);
  for (int m = 0; m < 5; ++m) a.out[m] = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  a.nu = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2]; a.K = ints[3]; a.buoy_corr = ints[4];
  a.inv_dx = floats[0]; a.inv_dy = floats[1]; a.prandtl = floats[2];
  a.inv_prandtl = floats[3]; a.g_acc = floats[4];

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8, 1);
  const dim3 grid((a.nx + block.x - 1) / block.x, (a.ny + block.y - 1) / block.y, a.nz);
  closure_nu_kernel<<<grid, block, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  closure_tendencies_kernel<<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
