// WENO5 building blocks shared by the stencil kernels (tendency.cu,
// momentum.cu, advection.cu): padded-window access, the upwind-selected
// WENO5-JS reconstruction and the nine momentum flux divergences.
//
// The plain PyTorch side of the same arithmetic is
// breeze_tpu_torch/kernels/weno.py and kernels/momentum.py.
//
// Layout: fields are (z, y, x) float32 with x contiguous.  Windows are
// padded by HALO in z and y (z walls by mirror / odd reflection, y
// periodic); x is unpadded and indexed modulo nx.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#define HALO 3
#define F32(x) ((float)(x))

namespace {

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

// The nine WENO5 momentum flux divergences ∇·(ρU⊗u) at the point (k, j, i):
// du at (zc, yc, xf), dv at (zc, yf, xc), dw at (zf, yc, xc).  RU, RV, RW
// give the advecting momenta at padded coordinates, U, V, W the advected
// velocities; weights are un-normalized (velocities are bounded).  izc and
// izf are 1/Δz at center k and at face k.  Row k = 0 of dw reads below-wall
// pad data, which the wall condition overwrites.
template <class MU, class MV, class MW>
__device__ __forceinline__ void momentum_divs(const MU& RU, const MV& RV, const MW& RW,
                                              const Win& U, const Win& V, const Win& W,
                                              int k, int j, int i, float idx, float idy,
                                              float izc, float izf,
                                              float& du_out, float& dv_out, float& dw_out) {
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

  du_out = du;
  dv_out = dv;
  dw_out = dw;
}

}  // namespace
