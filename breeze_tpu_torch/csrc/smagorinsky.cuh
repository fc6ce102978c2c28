// The Smagorinsky-Lilly closure's device code, shared by the fused tendency
// kernel's epilogue (tendency.cu) and the closure kernel (closure.cu): the
// eddy viscosity at a center, and the stress and diffusive-flux
// divergences at a point given ν at centers.
//
// The plain PyTorch side of the same arithmetic is
// breeze_tpu_torch/kernels/closure.py::closure_tendencies_plain.
//
// The formulas read their fields through accessors A(k, j, i) in interior
// coordinates: Win (a padded window in device memory, closure.cu) or the
// fused kernel's shared-memory planes (tendency.cu), so both kernels
// evaluate one set of expressions.
//
// Layout as weno.cuh: windows padded by HALO in z and y, x periodic; the
// columns are padded by HALO too.  closure.cu stores ν unpadded (nz, ny,
// nx); its z-wall mirror (row -1 ← row 0, row nz ← row nz-1) is a clamp of
// the level.

#pragma once

#include "weno.cuh"

namespace {

// ν = (CΔ)²|S|ς at center (k, j, i): the six strains, |S|² with the
// off-diagonals averaged to centers, and with buoy_corr Lilly's ς from the
// θᵥ window TB.  izc, izf are the closure's padded 1/Δz columns, cd2 (CΔ)².
template <class A, class AT>
__device__ __forceinline__ float smagorinsky_nu(const A& U, const A& V, const A& W,
                                                const AT& TB, const Col& izc, const Col& izf,
                                                const Col& cd2, int k, int j, int i, int nz,
                                                float idx, float idy, int buoy_corr,
                                                float g_acc, float prandtl) {
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
  if (buoy_corr) {
    auto dth_f = [&](int kf) { return (TB(kf, j, i) - TB(kf - 1, j, i)) * izf(kf); };
    // the reference's top cell copies its lower-face gradient
    const float dth = (k == nz - 1) ? dth_f(k) : 0.5f * (dth_f(k) + dth_f(k + 1));
    const float N2 = g_acc / fmaxf(TB(k, j, i), 1.0f) * dth;
    const float Ri = N2 / fmaxf(S2, F32(1e-20));
    abs_S = abs_S * sqrtf(fmaxf(0.0f, 1.0f - Ri / prandtl));
  }
  return cd2(k) * abs_S;
}

// Adds the closure's tendencies at (k, j, i) to g: the stress divergences
// to g[0] (u at xf), g[1] (v at yf), g[2] (w at zf), the diffusive flux
// divergences of the K scalars scal(0..K) to g[3..3+K).  NU(k, j, i) gives
// ν at centers k-1..k+1, mirrored at the z walls; colc and colf are the
// padded reference densities at centers and faces.
template <class A, class SC, class NUF>
__device__ __forceinline__ void smagorinsky_divergences(
    const A& U, const A& V, const A& W, const SC& scal, int K, const NUF& NU,
    const Col& colc, const Col& colf, const Col& izc_e, const Col& izf_e,
    int k, int j, int i, float idx, float idy, float inv_prandtl, float g[5]) {
  auto KAP = [&](int kk, int jj, int ii) { return NU(kk, jj, ii) * inv_prandtl; };
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
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s >= K) break;
    const auto C = scal(s);
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

// smagorinsky_divergences on the padded windows of scal[0..K) and on ν
// stored unpadded (nz, ny, nx) in device memory (the closure kernel).
__device__ __forceinline__ void smagorinsky_tendencies(
    const Win& U, const Win& V, const Win& W, const float* const scal[2], int K,
    const float* nu, const Col& colc, const Col& colf, const Col& izc_e, const Col& izf_e,
    int k, int j, int i, int nz, int ny, int nx, float idx, float idy, float inv_prandtl,
    float g[5]) {
  const int nyp = ny + 2 * HALO;
  auto NU = [&](int kk, int jj, int ii) {   // z clamped = the wall mirror
    kk = kk < 0 ? 0 : (kk > nz - 1 ? nz - 1 : kk);
    return __ldg(nu + ((size_t)kk * ny + wrap(jj, ny)) * nx + wrap(ii, nx));
  };
  auto C = [&](int s) { return Win{scal[s], nyp, nx}; };
  smagorinsky_divergences(U, V, W, C, K, NU, colc, colf, izc_e, izf_e, k, j, i, idx, idy,
                          inv_prandtl, g);
}

}  // namespace
