// Fused anelastic stage for sm_90a: WENO5 momentum and scalar advection,
// FPlane Coriolis, buoyancy, the Smagorinsky-Lilly epilogue, column-linear
// forcings and the SSP-RK3 blend, one thread per output point.
//
// Replaces breeze_tpu/pallas_kernels/tendency.py::fused_tendency_pallas
// (with closure.py::_smag_block).  The Python wrapper and the plain PyTorch
// version with the same formulas are in breeze_tpu_torch/kernels/tendency.py.
//
// Layout: fields are (z, y, x) float32 with x contiguous.  The windows u, v,
// w, theta, qt, b, thb are padded by HALO in z and y (z walls by mirror /
// odd reflection, y periodic); x is unpadded and indexed modulo nx.
//
// Bound: arithmetic (about thirty WENO5 reconstructions and the closure per
// point against ~17 fields of traffic).  Pass 1 writes the eddy viscosity nu
// at centers; pass 2 reads it (z clamped = the wall mirror) and writes the
// 3+K blended prognostics.  The closure's device code is smagorinsky.cuh,
// which the closure kernel (closure.cu) shares.

#include "smagorinsky.cuh"

namespace {

struct TendArgs {
  const float *u, *v, *w, *th, *qt, *b, *thb;
  const float *colc, *colf, *invdzc, *invdzf;
  const float *invdzc_e, *invdzf_e, *cd2_e;
  const float *fadd[5], *fdamp[5];
  const float *cur[5], *prev[5];
  float *out[5];
  float *nu;
  int nz, ny, nx, K, has_cor, has_clo, buoy_corr;
  float inv_dx, inv_dy, f_cor, prandtl, inv_prandtl, g_acc, alpha, dt, oma;
};

// ---- pass 1: eddy viscosity at centers -----------------------------------
__global__ void __launch_bounds__(256) smagorinsky_nu_kernel(TendArgs a) {
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

// ---- pass 2: tendencies and the blend --------------------------------------
__global__ void __launch_bounds__(256) fused_tendency_kernel(TendArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int nx = a.nx, ny = a.ny, nz = a.nz, nyp = ny + 2 * HALO;
  const Win U{a.u, nyp, nx}, V{a.v, nyp, nx}, W{a.w, nyp, nx}, B{a.b, nyp, nx};
  const Col colc{a.colc}, colf{a.colf};
  const float idx = a.inv_dx, idy = a.inv_dy;
  const float izc = __ldg(a.invdzc + k), izf = __ldg(a.invdzf + k);

  auto RU = [&](int kk, int jj, int ii) { return U(kk, jj, ii) * colc(kk); };
  auto RV = [&](int kk, int jj, int ii) { return V(kk, jj, ii) * colc(kk); };
  auto RW = [&](int kk, int jj, int ii) { return W(kk, jj, ii) * colf(kk); };
  float du, dv, dw;
  momentum_divs(RU, RV, RW, U, V, W, k, j, i, idx, idy, izc, izf, du, dv, dw);

  float g[5];
  g[0] = -du;
  g[1] = -dv;
  if (a.has_cor) {
    const float rv_u = 0.25f * (RV(k, j, i) + RV(k, j + 1, i) + RV(k, j, i - 1) + RV(k, j + 1, i - 1));
    const float ru_v = 0.25f * (RU(k, j, i) + RU(k, j, i + 1) + RU(k, j - 1, i) + RU(k, j - 1, i + 1));
    g[0] = g[0] + a.f_cor * rv_u;
    g[1] = g[1] - a.f_cor * ru_v;
  }
  g[2] = -dw + 0.5f * (B(k - 1, j, i) + B(k, j, i));

  // ---- scalars: shared mass fluxes, max-normalized weights ----------------
  float q[6];
  const float* scal[2] = {a.th, a.qt};
  for (int s = 0; s < a.K; ++s) {
    const Win C{scal[s], nyp, nx};
    auto fc_x = [&](int xf) {
      float mf = RU(k, j, xf);
      for (int o = -2; o <= 3; ++o) q[o + 2] = C(k, j, xf + o - 1);
      return mf * weno_sel<true>(q, mf);
    };
    auto fc_y = [&](int yf) {
      float mf = RV(k, yf, i);
      for (int o = -2; o <= 3; ++o) q[o + 2] = C(k, yf + o - 1, i);
      return mf * weno_sel<true>(q, mf);
    };
    auto fc_z = [&](int kf) {
      float mf = 0.5f * (colc(kf - 1) + colc(kf)) * W(kf, j, i);
      for (int o = -2; o <= 3; ++o) q[o + 2] = C(kf + o - 1, j, i);
      return mf * weno_sel<true>(q, mf);
    };
    float acc = (fc_x(i + 1) - fc_x(i)) * idx;
    acc = acc + (fc_y(j + 1) - fc_y(j)) * idy;
    acc = acc + (fc_z(k + 1) - fc_z(k)) * izc;
    g[3 + s] = -acc;
  }

  // ---- Smagorinsky-Lilly epilogue ----------------------------------------
  if (a.has_clo) {
    const Col izc_e{a.invdzc_e}, izf_e{a.invdzf_e};
    smagorinsky_tendencies(U, V, W, scal, a.K, a.nu, colc, colf, izc_e, izf_e, k, j, i,
                           nz, ny, nx, idx, idy, a.inv_prandtl, g);
  }

  // ---- forcing columns and the SSP-RK3 blend ------------------------------
  const size_t p = ((size_t)k * ny + j) * nx + i;
  const float rho_field[3] = {RU(k, j, i), RV(k, j, i), RW(k, j, i)};
  for (int n = 0; n < 3 + a.K; ++n) {
    float gn = g[n];
    if (a.fadd[n]) gn = gn + __ldg(a.fadd[n] + k);
    if (a.fdamp[n]) {
      if (n < 3) {
        gn = gn - __ldg(a.fdamp[n] + k) * rho_field[n];
      } else {
        gn = gn - __ldg(a.fdamp[n] + k) * Win{scal[n - 3], nyp, nx}(k, j, i) * colc(k);
      }
    }
    a.out[n][p] = a.oma * __ldg(a.prev[n] + p) + a.alpha * (__ldg(a.cur[n] + p) + a.dt * gn);
  }
}

}  // namespace

extern "C" {

const char* breeze_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ptrs, ints and floats in the order of TendArgs (see kernels/tendency.py).
int breeze_fused_tendency(const void* const* ptrs, const int* ints,
                          const float* floats, void* stream) {
  TendArgs a;
  int n = 0;
  const float** in[] = {&a.u, &a.v, &a.w, &a.th, &a.qt, &a.b, &a.thb,
                        &a.colc, &a.colf, &a.invdzc, &a.invdzf,
                        &a.invdzc_e, &a.invdzf_e, &a.cd2_e};
  for (const float** dst : in) *dst = static_cast<const float*>(ptrs[n++]);
  for (int m = 0; m < 5; ++m) a.fadd[m] = static_cast<const float*>(ptrs[n++]);
  for (int m = 0; m < 5; ++m) a.fdamp[m] = static_cast<const float*>(ptrs[n++]);
  for (int m = 0; m < 5; ++m) a.cur[m] = static_cast<const float*>(ptrs[n++]);
  for (int m = 0; m < 5; ++m) a.prev[m] = static_cast<const float*>(ptrs[n++]);
  for (int m = 0; m < 5; ++m) a.out[m] = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  a.nu = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2]; a.K = ints[3];
  a.has_cor = ints[4]; a.has_clo = ints[5]; a.buoy_corr = ints[6];
  a.inv_dx = floats[0]; a.inv_dy = floats[1]; a.f_cor = floats[2];
  a.prandtl = floats[3]; a.inv_prandtl = floats[4]; a.g_acc = floats[5];
  a.alpha = floats[6]; a.dt = floats[7]; a.oma = floats[8];

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8, 1);
  const dim3 grid((a.nx + block.x - 1) / block.x, (a.ny + block.y - 1) / block.y, a.nz);
  if (a.has_clo) {
    smagorinsky_nu_kernel<<<grid, block, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_tendency_kernel<<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
