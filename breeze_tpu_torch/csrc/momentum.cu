// WENO5 momentum flux divergences ∇·(ρU⊗u) for sm_90a, one thread per
// output point.
//
// Replaces breeze_tpu/pallas_kernels/momentum.py::momentum_div_pallas (the
// pl.pallas_call in _run, body momentum_divs) and, as the COLS instance,
// momentum_div_pallas_cols (the pl.pallas_call in _run_cols).  The Python
// wrappers and the plain PyTorch versions are in
// breeze_tpu_torch/kernels/momentum.py; the arithmetic is momentum_divs in
// weno.cuh, which the fused tendency kernel shares.
//
// Inputs: the velocities u, v, w as windows padded by HALO in z and y, and
// 1/Δz at centers and faces (nz,); then either the momenta ρu, ρv, ρw as
// windows of the same shape, or (COLS) the padded reference density columns
// at centers and faces (nz + 2·HALO,), from which the anelastic momenta
// ρᵣ(z)·u are formed in registers.  The face column is mirrored about the
// wall faces, so that it times the odd-reflected w pad gives the
// odd-reflected ρw pad.  Outputs du, dv, dw (nz, ny, nx), the divergences
// (not their negatives).
//
// Bound: device memory and arithmetic about equally at 256×256×128.  Six
// padded windows read and three fields written (~316 MB) take ~0.094 ms at
// 3.35 TB/s; the ~675 float32 operations per point that nine interface
// reconstructions need take ~0.085 ms at 67 TFLOP/s.  This kernel computes
// each interface twice (once for each cell beside it), so arithmetic is what
// limits it.  The design takes the TPU kernel's stencil-select upwinding and
// nothing of its (8, 128) blocking: threads run x fastest so that the window
// reads coalesce and the 5-wide stencils hit L1; periodic x is a modular
// index, so x needs no pad.  The COLS instance reads three windows instead
// of six (~213 MB at 256³, ~0.064 ms), so at 256³ its bound is arithmetic,
// ~684 operations per point, ~0.171 ms.

#include "weno.cuh"

namespace {

struct MomArgs {
  const float *ru, *rv, *rw, *u, *v, *w, *invdzc, *invdzf;
  const float *colc, *colf;
  float *du, *dv, *dw;
  int nz, ny, nx;
  float inv_dx, inv_dy;
};

template <bool COLS>
__device__ __forceinline__ void momentum_div_point(const MomArgs& a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int nyp = a.ny + 2 * HALO;
  const Win U{a.u, nyp, a.nx}, V{a.v, nyp, a.nx}, W{a.w, nyp, a.nx};
  float du, dv, dw;
  if (COLS) {
    const Col colc{a.colc}, colf{a.colf};
    auto RU = [&](int kk, int jj, int ii) { return U(kk, jj, ii) * colc(kk); };
    auto RV = [&](int kk, int jj, int ii) { return V(kk, jj, ii) * colc(kk); };
    auto RW = [&](int kk, int jj, int ii) { return W(kk, jj, ii) * colf(kk); };
    momentum_divs(RU, RV, RW, U, V, W, k, j, i, a.inv_dx, a.inv_dy,
                  __ldg(a.invdzc + k), __ldg(a.invdzf + k), du, dv, dw);
  } else {
    const Win RU{a.ru, nyp, a.nx}, RV{a.rv, nyp, a.nx}, RW{a.rw, nyp, a.nx};
    momentum_divs(RU, RV, RW, U, V, W, k, j, i, a.inv_dx, a.inv_dy,
                  __ldg(a.invdzc + k), __ldg(a.invdzf + k), du, dv, dw);
  }
  const size_t p = ((size_t)k * a.ny + j) * a.nx + i;
  a.du[p] = du;
  a.dv[p] = dv;
  a.dw[p] = dw;
}

__global__ void __launch_bounds__(256) momentum_div_kernel(MomArgs a) {
  momentum_div_point<false>(a);
}

__global__ void __launch_bounds__(256) momentum_div_cols_kernel(MomArgs a) {
  momentum_div_point<true>(a);
}

}  // namespace

extern "C" {

// ptrs: ru, rv, rw, u, v, w, invdzc, invdzf, colc, colf, du, dv, dw (the
// momenta null with cols, the columns null without); ints: nz, ny, nx, cols;
// floats: inv_dx, inv_dy (see kernels/momentum.py).
int breeze_momentum_div(const void* const* ptrs, const int* ints,
                        const float* floats, void* stream) {
  MomArgs a;
  const float** in[] = {&a.ru, &a.rv, &a.rw, &a.u, &a.v, &a.w, &a.invdzc, &a.invdzf,
                        &a.colc, &a.colf};
  int n = 0;
  for (const float** dst : in) *dst = static_cast<const float*>(ptrs[n++]);
  float** out[] = {&a.du, &a.dv, &a.dw};
  for (float** dst : out) *dst = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2];
  a.inv_dx = floats[0]; a.inv_dy = floats[1];
  const dim3 block(32, 8, 1);
  const dim3 grid((a.nx + block.x - 1) / block.x, (a.ny + block.y - 1) / block.y, a.nz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[3]) {
    momentum_div_cols_kernel<<<grid, block, 0, s>>>(a);
  } else {
    momentum_div_kernel<<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
