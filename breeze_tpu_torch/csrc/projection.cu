// The anelastic pressure projection's two stencil passes for sm_90a, one
// thread per output point: the divergence δ = ∇·(ρu) and the gradient
// correction ρu ← ρu − Δt ρᵣ∇φ.
//
// Replaces breeze_tpu/pallas_kernels/projection.py::divergence_pallas (the
// pl.pallas_call in _run_div, body _make_div) and gradient_correct_pallas
// (the pl.pallas_call in _run_grad, body _make_grad).  The Python wrappers
// and the plain PyTorch versions are in breeze_tpu_torch/kernels/projection.py.
//
// Layout: unpadded (z, y, x) float32 fields with x contiguous; x and y are
// periodic (a modular index), so no padded window is built.  The divergence
// takes the top face's ρw flux as zero (the implicit upper wall face); the
// correction takes ∂zφ at face k from centers k−1 and k, applies ρᵣ at each
// component's location and pins the bottom face of ρw to zero.  Δt is a
// runtime argument, so one build serves every stage's αΔt.  The output is
// out of place, as in the reference.
//
// Bound: device memory, pure streaming.  At 256³ the divergence reads three
// fields and writes one (~268 MB, ~0.080 ms at 3.35 TB/s; 8 operations per
// point), the correction reads four and writes three (~470 MB, ~0.140 ms;
// 12 operations per point).  Neighbour reads at x+1, y+1 and z+1 (or −1)
// hit L1 and L2; x fastest keeps every read coalesced.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

struct DivArgs {
  const float *ru, *rv, *rw, *invdzc;
  float* out;
  int nz, ny, nx;
  float inv_dx, inv_dy;
};

struct GradArgs {
  const float *phi, *ru, *rv, *rw, *rhoc, *rhof, *invdzf;
  float *ru_o, *rv_o, *rw_o;
  int nz, ny, nx;
  float inv_dx, inv_dy, dt;
};

__global__ void __launch_bounds__(256) divergence_kernel(DivArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const size_t plane = (size_t)a.ny * a.nx;
  const size_t row = (size_t)k * plane + (size_t)j * a.nx;
  const size_t p = row + i;
  const int ip = i + 1 == a.nx ? 0 : i + 1;
  const int jp = j + 1 == a.ny ? 0 : j + 1;
  const float rw_top = k + 1 < a.nz ? __ldg(a.rw + p + plane) : 0.0f;
  const float dx_part = (__ldg(a.ru + row + ip) - __ldg(a.ru + p)) * a.inv_dx;
  const float dy_part = (__ldg(a.rv + (size_t)k * plane + (size_t)jp * a.nx + i)
                         - __ldg(a.rv + p)) * a.inv_dy;
  const float dz_part = (rw_top - __ldg(a.rw + p)) * __ldg(a.invdzc + k);
  a.out[p] = dx_part + dy_part + dz_part;
}

__global__ void __launch_bounds__(256) gradient_correct_kernel(GradArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const size_t plane = (size_t)a.ny * a.nx;
  const size_t row = (size_t)k * plane + (size_t)j * a.nx;
  const size_t p = row + i;
  const int im = i == 0 ? a.nx - 1 : i - 1;
  const int jm = j == 0 ? a.ny - 1 : j - 1;
  const float phi_c = __ldg(a.phi + p);
  const float rhoc = __ldg(a.rhoc + k);
  a.ru_o[p] = __ldg(a.ru + p) - a.dt * rhoc * (phi_c - __ldg(a.phi + row + im)) * a.inv_dx;
  a.rv_o[p] = __ldg(a.rv + p)
              - a.dt * rhoc * (phi_c - __ldg(a.phi + (size_t)k * plane + (size_t)jm * a.nx + i))
                * a.inv_dy;
  // bottom wall: face 0 pinned to zero
  a.rw_o[p] = k == 0 ? 0.0f
                     : __ldg(a.rw + p) - a.dt * __ldg(a.rhof + k)
                                           * ((phi_c - __ldg(a.phi + p - plane))
                                              * __ldg(a.invdzf + k));
}

dim3 grid_of(int nz, int ny, int nx, dim3 block) {
  return dim3((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y, nz);
}

}  // namespace

extern "C" {

// ptrs: ru, rv, rw, invdzc, out; ints: nz, ny, nx; floats: inv_dx, inv_dy
// (see kernels/projection.py).
int breeze_divergence(const void* const* ptrs, const int* ints, const float* floats,
                      void* stream) {
  DivArgs a;
  const float** in[] = {&a.ru, &a.rv, &a.rw, &a.invdzc};
  int n = 0;
  for (const float** dst : in) *dst = static_cast<const float*>(ptrs[n++]);
  a.out = static_cast<float*>(const_cast<void*>(ptrs[n]));
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2];
  a.inv_dx = floats[0]; a.inv_dy = floats[1];
  const dim3 block(32, 8, 1);
  divergence_kernel<<<grid_of(a.nz, a.ny, a.nx, block), block, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: phi, ru, rv, rw, rhoc, rhof, invdzf, ru_o, rv_o, rw_o; ints: nz, ny,
// nx; floats: inv_dx, inv_dy, dt (see kernels/projection.py).
int breeze_gradient_correct(const void* const* ptrs, const int* ints, const float* floats,
                            void* stream) {
  GradArgs a;
  const float** in[] = {&a.phi, &a.ru, &a.rv, &a.rw, &a.rhoc, &a.rhof, &a.invdzf};
  int n = 0;
  for (const float** dst : in) *dst = static_cast<const float*>(ptrs[n++]);
  float** out[] = {&a.ru_o, &a.rv_o, &a.rw_o};
  for (float** dst : out) *dst = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2];
  a.inv_dx = floats[0]; a.inv_dy = floats[1]; a.dt = floats[2];
  const dim3 block(32, 8, 1);
  gradient_correct_kernel<<<grid_of(a.nz, a.ny, a.nx, block), block, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
