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
// 3+K blended prognostics.

#include <cuda_runtime.h>
#include <stddef.h>

#define HALO 3
#define F32(x) ((float)(x))

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

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// Padded window: k, j interior coordinates in [-HALO, n + HALO); i wraps.
struct Win {
  const float* p;
  int nyp, nx;
  __device__ __forceinline__ float operator()(int k, int j, int i) const {
    return __ldg(p + ((size_t)(k + HALO) * nyp + (j + HALO)) * nx + wrap(i, nx));
  }
};

// Padded column: k in [-HALO, nz + HALO).
struct Col {
  const float* p;
  __device__ __forceinline__ float operator()(int k) const { return __ldg(p + k + HALO); }
};

__device__ __forceinline__ float sq(float x) { return x * x; }

// WENO5-JS with common-denominator weights; NORM max-normalizes them with a
// 1e-9 floor (scalars), momentum skips it (bounded velocities).
template <bool NORM>
__device__ __forceinline__ float weno5(float qm2, float qm1, float q0, float q1, float q2) {
  const float s6 = F32(1.0 / 6.0), c13 = F32(13.0 / 12.0);
  float p0 = (2.0f * qm2 - 7.0f * qm1 + 11.0f * q0) * s6;
  float p1 = (-qm1 + 5.0f * q0 + 2.0f * q1) * s6;
  float p2 = (2.0f * q0 + 5.0f * q1 - q2) * s6;
  float b0 = c13 * sq(qm2 - 2.0f * qm1 + q0) + 0.25f * sq(qm2 - 4.0f * qm1 + 3.0f * q0);
  float b1 = c13 * sq(qm1 - 2.0f * q0 + q1) + 0.25f * sq(qm1 - q1);
  float b2 = c13 * sq(q0 - 2.0f * q1 + q2) + 0.25f * sq(3.0f * q0 - 4.0f * q1 + q2);
  float e0 = b0 + F32(1e-6), e1 = b1 + F32(1e-6), e2 = b2 + F32(1e-6);
  if (NORM) {
    float inv_m = 1.0f / fmaxf(e0, fmaxf(e1, e2));
    e0 = fmaxf(e0 * inv_m, F32(1e-9));
    e1 = fmaxf(e1 * inv_m, F32(1e-9));
    e2 = fmaxf(e2 * inv_m, F32(1e-9));
  }
  float a0 = F32(0.1) * sq(e1 * e2);
  float a1 = F32(0.6) * sq(e0 * e2);
  float a2 = F32(0.3) * sq(e0 * e1);
  return (a0 * p0 + a1 * p1 + a2 * p2) / (a0 + a1 + a2);
}

// Upwind WENO5 at an interface; c[0..5] are the cells at offsets -2..3 from
// the interface's left cell.  sign >= 0 takes the left-biased stencil, else
// the mirrored one cell(1 - o).
template <bool NORM>
__device__ __forceinline__ float weno_sel(const float c[6], float sign) {
  if (sign >= 0.0f) return weno5<NORM>(c[0], c[1], c[2], c[3], c[4]);
  return weno5<NORM>(c[5], c[4], c[3], c[2], c[1]);
}

// ---- pass 1: eddy viscosity at centers -----------------------------------
__global__ void __launch_bounds__(256) smagorinsky_nu_kernel(TendArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int nyp = a.ny + 2 * HALO;
  const Win U{a.u, nyp, a.nx}, V{a.v, nyp, a.nx}, W{a.w, nyp, a.nx}, TB{a.thb, nyp, a.nx};
  const Col izc{a.invdzc_e}, izf{a.invdzf_e}, cd2{a.cd2_e};
  const float idx = a.inv_dx, idy = a.inv_dy;

  auto S12 = [&](int kk, int jf, int xf) {
    return 0.5f * ((U(kk, jf, xf) - U(kk, jf - 1, xf)) * idy
                   + (V(kk, jf, xf) - V(kk, jf, xf - 1)) * idx);
  };
  auto S13 = [&](int kf, int jj, int xf) {
    return 0.5f * ((U(kf, jj, xf) - U(kf - 1, jj, xf)) * izf(kf)
                   + (W(kf, jj, xf) - W(kf, jj, xf - 1)) * idx);
  };
  auto S23 = [&](int kf, int yf, int ii) {
    return 0.5f * ((V(kf, yf, ii) - V(kf - 1, yf, ii)) * izf(kf)
                   + (W(kf, yf, ii) - W(kf, yf - 1, ii)) * idy);
  };
  const float S11 = (U(k, j, i + 1) - U(k, j, i)) * idx;
  const float S22 = (V(k, j + 1, i) - V(k, j, i)) * idy;
  const float S33 = (W(k + 1, j, i) - W(k, j, i)) * izc(k);
  const float S12c = 0.25f * (S12(k, j, i) + S12(k, j + 1, i) + S12(k, j, i + 1) + S12(k, j + 1, i + 1));
  const float S13c = 0.25f * (S13(k, j, i) + S13(k + 1, j, i) + S13(k, j, i + 1) + S13(k + 1, j, i + 1));
  const float S23c = 0.25f * (S23(k, j, i) + S23(k, j + 1, i) + S23(k + 1, j, i) + S23(k + 1, j + 1, i));
  const float S2 = 2.0f * (S11 * S11 + S22 * S22 + S33 * S33
                           + 2.0f * (S12c * S12c + S13c * S13c + S23c * S23c));
  float abs_S = sqrtf(S2);
  if (a.buoy_corr) {
    auto dth_f = [&](int kf) { return (TB(kf, j, i) - TB(kf - 1, j, i)) * izf(kf); };
    // the reference's top cell copies its lower-face gradient
    const float dth = (k == a.nz - 1) ? dth_f(k) : 0.5f * (dth_f(k) + dth_f(k + 1));
    const float N2 = a.g_acc / fmaxf(TB(k, j, i), 1.0f) * dth;
    const float Ri = N2 / fmaxf(S2, F32(1e-20));
    abs_S = abs_S * sqrtf(fmaxf(0.0f, 1.0f - Ri / a.prandtl));
  }
  a.nu[((size_t)k * a.ny + j) * a.nx + i] = cd2(k) * abs_S;
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
  float q[6];

  // ---- u at (zc, yc, xf) ---------------------------------------------------
  auto fu_x = [&](int c) {       // x-center c
    float mf = 0.5f * (RU(k, j, c) + RU(k, j, c + 1));
    for (int o = -2; o <= 3; ++o) q[o + 2] = U(k, j, c + o);
    return mf * weno_sel<false>(q, mf);
  };
  auto fu_y = [&](int jf) {      // (yf, xf) corner
    float mf = 0.5f * (RV(k, jf, i) + RV(k, jf, i - 1));
    for (int o = -2; o <= 3; ++o) q[o + 2] = U(k, jf + o - 1, i);
    return mf * weno_sel<false>(q, mf);
  };
  auto fu_z = [&](int kf) {      // (zf, xf) edge
    float mf = 0.5f * (RW(kf, j, i) + RW(kf, j, i - 1));
    for (int o = -2; o <= 3; ++o) q[o + 2] = U(kf + o - 1, j, i);
    return mf * weno_sel<false>(q, mf);
  };
  float du = (fu_x(i) - fu_x(i - 1)) * idx;
  du = du + (fu_y(j + 1) - fu_y(j)) * idy;
  du = du + (fu_z(k + 1) - fu_z(k)) * izc;

  // ---- v at (zc, yf, xc) ---------------------------------------------------
  auto fv_x = [&](int xf) {
    float mf = 0.5f * (RU(k, j, xf) + RU(k, j - 1, xf));
    for (int o = -2; o <= 3; ++o) q[o + 2] = V(k, j, xf + o - 1);
    return mf * weno_sel<false>(q, mf);
  };
  auto fv_y = [&](int c) {       // y-center c
    float mf = 0.5f * (RV(k, c, i) + RV(k, c + 1, i));
    for (int o = -2; o <= 3; ++o) q[o + 2] = V(k, c + o, i);
    return mf * weno_sel<false>(q, mf);
  };
  auto fv_z = [&](int kf) {
    float mf = 0.5f * (RW(kf, j, i) + RW(kf, j - 1, i));
    for (int o = -2; o <= 3; ++o) q[o + 2] = V(kf + o - 1, j, i);
    return mf * weno_sel<false>(q, mf);
  };
  float dv = (fv_x(i + 1) - fv_x(i)) * idx;
  dv = dv + (fv_y(j) - fv_y(j - 1)) * idy;
  dv = dv + (fv_z(k + 1) - fv_z(k)) * izc;

  // ---- w at (zf, yc, xc) ---------------------------------------------------
  auto fw_x = [&](int xf) {
    float mf = 0.5f * (RU(k, j, xf) + RU(k - 1, j, xf));
    for (int o = -2; o <= 3; ++o) q[o + 2] = W(k, j, xf + o - 1);
    return mf * weno_sel<false>(q, mf);
  };
  auto fw_y = [&](int yf) {
    float mf = 0.5f * (RV(k, yf, i) + RV(k - 1, yf, i));
    for (int o = -2; o <= 3; ++o) q[o + 2] = W(k, yf + o - 1, i);
    return mf * weno_sel<false>(q, mf);
  };
  auto fw_z = [&](int c) {       // z-center c
    float mf = 0.5f * (RW(c, j, i) + RW(c + 1, j, i));
    for (int o = -2; o <= 3; ++o) q[o + 2] = W(c + o, j, i);
    return mf * weno_sel<false>(q, mf);
  };
  float dw = (fw_x(i + 1) - fw_x(i)) * idx;
  dw = dw + (fw_y(j + 1) - fw_y(j)) * idy;
  dw = dw + (fw_z(k) - fw_z(k - 1)) * izf;

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
    auto NU = [&](int kk, int jj, int ii) {   // z clamped = the wall mirror
      kk = kk < 0 ? 0 : (kk > nz - 1 ? nz - 1 : kk);
      return __ldg(a.nu + ((size_t)kk * ny + wrap(jj, ny)) * nx + wrap(ii, nx));
    };
    auto KAP = [&](int kk, int jj, int ii) { return NU(kk, jj, ii) * a.inv_prandtl; };
    auto S11 = [&](int kk, int jj, int ii) { return (U(kk, jj, ii + 1) - U(kk, jj, ii)) * idx; };
    auto S22 = [&](int kk, int jj, int ii) { return (V(kk, jj + 1, ii) - V(kk, jj, ii)) * idy; };
    auto S33 = [&](int kk, int jj, int ii) { return (W(kk + 1, jj, ii) - W(kk, jj, ii)) * izc_e(kk); };
    auto S12 = [&](int kk, int jf, int xf) {
      return 0.5f * ((U(kk, jf, xf) - U(kk, jf - 1, xf)) * idy
                     + (V(kk, jf, xf) - V(kk, jf, xf - 1)) * idx);
    };
    auto S13 = [&](int kf, int jj, int xf) {
      return 0.5f * ((U(kf, jj, xf) - U(kf - 1, jj, xf)) * izf_e(kf)
                     + (W(kf, jj, xf) - W(kf, jj, xf - 1)) * idx);
    };
    auto S23 = [&](int kf, int yf, int ii) {
      return 0.5f * ((V(kf, yf, ii) - V(kf - 1, yf, ii)) * izf_e(kf)
                     + (W(kf, yf, ii) - W(kf, yf - 1, ii)) * idy);
    };
    auto T11 = [&](int ii) { return -2.0f * (colc(k) * NU(k, j, ii)) * S11(k, j, ii); };
    auto T22 = [&](int jj) { return -2.0f * (colc(k) * NU(k, jj, i)) * S22(k, jj, i); };
    auto T33 = [&](int kk) { return -2.0f * (colc(kk) * NU(kk, j, i)) * S33(kk, j, i); };
    auto T12 = [&](int yf, int xf) {
      const float nxy = 0.25f * (NU(k, yf, xf) + NU(k, yf, xf - 1) + NU(k, yf - 1, xf) + NU(k, yf - 1, xf - 1));
      return -2.0f * colc(k) * nxy * S12(k, yf, xf);
    };
    auto T13 = [&](int kf, int xf) {
      const float nxz = 0.25f * (NU(kf, j, xf) + NU(kf, j, xf - 1) + NU(kf - 1, j, xf) + NU(kf - 1, j, xf - 1));
      return -2.0f * colf(kf) * nxz * S13(kf, j, xf);
    };
    auto T23 = [&](int kf, int yf) {
      const float nyz = 0.25f * (NU(kf, yf, i) + NU(kf, yf - 1, i) + NU(kf - 1, yf, i) + NU(kf - 1, yf - 1, i));
      return -2.0f * colf(kf) * nyz * S23(kf, yf, i);
    };
    const float ize = izc_e(k), ife = izf_e(k);
    g[0] = g[0] + -((T11(i) - T11(i - 1)) * idx + (T12(j + 1, i) - T12(j, i)) * idy
                    + (T13(k + 1, i) - T13(k, i)) * ize);
    g[1] = g[1] + -((T12(j, i + 1) - T12(j, i)) * idx + (T22(j) - T22(j - 1)) * idy
                    + (T23(k + 1, j) - T23(k, j)) * ize);
    g[2] = g[2] + -((T13(k, i + 1) - T13(k, i)) * idx + (T23(k, j + 1) - T23(k, j)) * idy
                    + (T33(k) - T33(k - 1)) * ife);
    for (int s = 0; s < a.K; ++s) {
      const Win C{scal[s], nyp, nx};
      auto Fz = [&](int kf) {
        return colf(kf) * 0.5f * (KAP(kf - 1, j, i) + KAP(kf, j, i))
               * (C(kf, j, i) - C(kf - 1, j, i)) * izf_e(kf);
      };
      auto Fy = [&](int yf) {
        return colc(k) * 0.5f * (KAP(k, yf - 1, i) + KAP(k, yf, i))
               * (C(k, yf, i) - C(k, yf - 1, i)) * idy;
      };
      auto Fx = [&](int xf) {
        return colc(k) * 0.5f * (KAP(k, j, xf) + KAP(k, j, xf - 1))
               * (C(k, j, xf) - C(k, j, xf - 1)) * idx;
      };
      g[3 + s] = g[3 + s] + ((Fx(i + 1) - Fx(i)) * idx + (Fy(j + 1) - Fy(j)) * idy
                             + (Fz(k + 1) - Fz(k)) * ize);
    }
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
