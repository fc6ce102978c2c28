// Scalar WENO5 flux divergence −∇·(ρuc) for sm_90a, one thread per output
// point.
//
// Replaces breeze_tpu/pallas_kernels/advection.py::div_rho_u_c_pallas (the
// pl.pallas_call in _run, body _make_kernel), with its bounds-preserving
// clip as a flag.  The Python wrapper and the plain PyTorch version are in
// breeze_tpu_torch/kernels/advection.py.
//
// Inputs: the advected scalar c, the velocities u, v, w and the density ρ
// as windows padded by HALO in z and y, and 1/Δz at centers (nz,).  The
// mass flux at a face is the two-cell mean of ρ times the face velocity.
// Weights are max-normalized with a 1e-9 floor; the normalization takes an
// exact reciprocal where the TPU kernel took an approximate one (the scale
// cancels in the final ratio, so only the floor sees the difference).
//
// Bound: device memory at 256×256×128.  Five padded windows read and one
// field written (~213 MB) take ~0.064 ms at 3.35 TB/s; the ~256 float32
// operations per point of three interface reconstructions take ~0.032 ms at
// 67 TFLOP/s, twice that as this kernel computes each interface once for
// each cell beside it.  Layout and indexing as momentum.cu.

#include "weno.cuh"

namespace {

struct AdvArgs {
  const float *c, *u, *v, *w, *rho, *invdz;
  float* out;
  int nz, ny, nx, bounds;
  float inv_dx, inv_dy;
};

// The interface value from the six cells around it (offsets -2..3 from the
// left cell), upwind by the sign of the mass flux, optionally clipped to
// the hull of the two adjacent cells.
__device__ __forceinline__ float face_value(const float q[6], float mf, int bounds) {
  float out = weno_sel<true>(q, mf);
  if (bounds) out = fminf(fmaxf(out, fminf(q[2], q[3])), fmaxf(q[2], q[3]));
  return out;
}

__global__ void __launch_bounds__(256) div_rho_u_c_kernel(AdvArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int nyp = a.ny + 2 * HALO;
  const Win C{a.c, nyp, a.nx}, U{a.u, nyp, a.nx}, V{a.v, nyp, a.nx};
  const Win W{a.w, nyp, a.nx}, R{a.rho, nyp, a.nx};
  float q[6];
  auto fx = [&](int xf) {
    float mf = 0.5f * (R(k, j, xf) + R(k, j, xf - 1)) * U(k, j, xf);
    for (int o = -2; o <= 3; ++o) q[o + 2] = C(k, j, xf + o - 1);
    return mf * face_value(q, mf, a.bounds);
  };
  auto fy = [&](int yf) {
    float mf = 0.5f * (R(k, yf - 1, i) + R(k, yf, i)) * V(k, yf, i);
    for (int o = -2; o <= 3; ++o) q[o + 2] = C(k, yf + o - 1, i);
    return mf * face_value(q, mf, a.bounds);
  };
  auto fz = [&](int kf) {
    float mf = 0.5f * (R(kf - 1, j, i) + R(kf, j, i)) * W(kf, j, i);
    for (int o = -2; o <= 3; ++o) q[o + 2] = C(kf + o - 1, j, i);
    return mf * face_value(q, mf, a.bounds);
  };
  float acc = (fx(i + 1) - fx(i)) * a.inv_dx;
  acc = acc + (fy(j + 1) - fy(j)) * a.inv_dy;
  acc = acc + (fz(k + 1) - fz(k)) * __ldg(a.invdz + k);
  a.out[((size_t)k * a.ny + j) * a.nx + i] = -acc;
}

}  // namespace

extern "C" {

// ptrs: c, u, v, w, rho, invdz, out; ints: nz, ny, nx, bounds;
// floats: inv_dx, inv_dy (see kernels/advection.py).
int breeze_div_rho_u_c(const void* const* ptrs, const int* ints,
                       const float* floats, void* stream) {
  AdvArgs a;
  const float** in[] = {&a.c, &a.u, &a.v, &a.w, &a.rho, &a.invdz};
  int n = 0;
  for (const float** dst : in) *dst = static_cast<const float*>(ptrs[n++]);
  a.out = static_cast<float*>(const_cast<void*>(ptrs[n]));
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2]; a.bounds = ints[3];
  a.inv_dx = floats[0]; a.inv_dy = floats[1];
  const dim3 block(32, 8, 1);
  const dim3 grid((a.nx + block.x - 1) / block.x, (a.ny + block.y - 1) / block.y, a.nz);
  div_rho_u_c_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
