// The z-marching tile of the WENO5 momentum kernels, shared by the fused
// tendency kernel (tendency.cu) and the column-momentum kernel
// (momentum.cu): the tile of columns, the ring of planes in shared memory
// that cp.async fills a level ahead, and the momentum face fluxes with
// ρᵣ multiplied in as each face's mass flux is formed.
//
// A block of NT threads owns a TX × TY tile of columns, one thread a
// column, and marches up a chunk of levels.  Each field's ring holds NSLOT
// planes (levels k-3 .. k+3, the tile plus its HALO-point halo, x wrapped
// at the domain edge).  Each x and y face flux of a level is computed once
// into shared memory (XF and YF floats a field), each z face flux carried
// in a register from level k to k+1: 9 reconstructions a point for the
// three momenta.  The arithmetic is weno.cuh's momentum_divs, one face at a
// time; its plain PyTorch side is kernels/momentum.py::momentum_div_plain.

#pragma once

#include "weno.cuh"

namespace {

constexpr int TX = 32, TY = 16, NT = TX * TY;
constexpr int PW = TX + 2 * HALO, PLANE = PW * (TY + 2 * HALO);  // a field's plane
constexpr int NSLOT = 7;                                          // levels k-3 .. k+3
constexpr int XF = TY * (TX + 1), YF = (TY + 1) * TX;             // face fluxes a level

__device__ __forceinline__ int slot7(int s) {
  return s < 0 ? s + NSLOT : (s >= NSLOT ? s - NSLOT : s);
}

// A field's ring of planes seen from (k, j, i): p is the field's slot 0 at
// (j, i), sk the slot of level k; reads levels k-3 .. k+3.
struct Ring {
  const float* p;
  int k, j, i, sk;
  __device__ __forceinline__ float operator()(int kk, int jj, int ii) const {
    return p[slot7(sk + (kk - k)) * PLANE + (jj - j) * PW + (ii - i)];
  }
};

struct Tile {
  const float* sm;
  int i0, j0;
  __device__ __forceinline__ Ring ring(int f, int k, int sk, int j, int i) const {
    return Ring{sm + f * NSLOT * PLANE + (j - j0 + HALO) * PW + (i - i0 + HALO), k, j, i, sk};
  }
};

// weno_sel without a branch: the upwind cells are selected first, so a warp
// whose faces differ in sign runs one reconstruction, not both (the same
// arithmetic on the same cells; 2.10 against 2.16 ms a 256³ stage on an
// H100, PERF.md).
template <bool NORM>
__device__ __forceinline__ float weno_up(const float c[6], float sign) {
  const bool up = sign >= 0.0f;
  return weno5<NORM>(up ? c[0] : c[5], up ? c[1] : c[4], up ? c[2] : c[3], up ? c[3] : c[2],
                     up ? c[4] : c[1]);
}

// ---- face fluxes (weno.cuh's momentum_divs, one face each) ----------------
// ck, ckm: ρᵣ at centers k and k-1.  x: on row j of level k, at x-center c
// (u) or x-face x (the others); y: on column i, at y-face y or y-center c (v).
__device__ __forceinline__ float flux_xu(const Ring& U, int k, int j, int c, float ck) {
  float q[6];
  const float mf = 0.5f * (U(k, j, c) * ck + U(k, j, c + 1) * ck);
  for (int o = -2; o <= 3; ++o) q[o + 2] = U(k, j, c + o);
  return mf * weno_up<false>(q, mf);
}
__device__ __forceinline__ float flux_xv(const Ring& U, const Ring& V, int k, int j, int x,
                                         float ck) {
  float q[6];
  const float mf = 0.5f * (U(k, j, x) * ck + U(k, j - 1, x) * ck);
  for (int o = -2; o <= 3; ++o) q[o + 2] = V(k, j, x + o - 1);
  return mf * weno_up<false>(q, mf);
}
__device__ __forceinline__ float flux_xw(const Ring& U, const Ring& W, int k, int j, int x,
                                         float ck, float ckm) {
  float q[6];
  const float mf = 0.5f * (U(k, j, x) * ck + U(k - 1, j, x) * ckm);
  for (int o = -2; o <= 3; ++o) q[o + 2] = W(k, j, x + o - 1);
  return mf * weno_up<false>(q, mf);
}
__device__ __forceinline__ float flux_yu(const Ring& U, const Ring& V, int k, int y, int i,
                                         float ck) {
  float q[6];
  const float mf = 0.5f * (V(k, y, i) * ck + V(k, y, i - 1) * ck);
  for (int o = -2; o <= 3; ++o) q[o + 2] = U(k, y + o - 1, i);
  return mf * weno_up<false>(q, mf);
}
__device__ __forceinline__ float flux_yv(const Ring& V, int k, int c, int i, float ck) {
  float q[6];
  const float mf = 0.5f * (V(k, c, i) * ck + V(k, c + 1, i) * ck);
  for (int o = -2; o <= 3; ++o) q[o + 2] = V(k, c + o, i);
  return mf * weno_up<false>(q, mf);
}
__device__ __forceinline__ float flux_yw(const Ring& V, const Ring& W, int k, int y, int i,
                                         float ck, float ckm) {
  float q[6];
  const float mf = 0.5f * (V(k, y, i) * ck + V(k - 1, y, i) * ckm);
  for (int o = -2; o <= 3; ++o) q[o + 2] = W(k, y + o - 1, i);
  return mf * weno_up<false>(q, mf);
}
// z, on the thread's own column: u and v at face kf, w at center c (ρᵣ at
// faces colf).
__device__ __forceinline__ float flux_zu(const Ring& U, const Ring& W, int kf, int j, int i,
                                         float cf) {
  float q[6];
  const float mf = 0.5f * (W(kf, j, i) * cf + W(kf, j, i - 1) * cf);
  for (int o = -2; o <= 3; ++o) q[o + 2] = U(kf + o - 1, j, i);
  return mf * weno_up<false>(q, mf);
}
__device__ __forceinline__ float flux_zv(const Ring& V, const Ring& W, int kf, int j, int i,
                                         float cf) {
  float q[6];
  const float mf = 0.5f * (W(kf, j, i) * cf + W(kf, j - 1, i) * cf);
  for (int o = -2; o <= 3; ++o) q[o + 2] = V(kf + o - 1, j, i);
  return mf * weno_up<false>(q, mf);
}
__device__ __forceinline__ float flux_zw(const Ring& W, int c, int j, int i, float cf0,
                                         float cf1) {
  float q[6];
  const float mf = 0.5f * (W(c, j, i) * cf0 + W(c + 1, j, i) * cf1);
  for (int o = -2; o <= 3; ++o) q[o + 2] = W(c + o, j, i);
  return mf * weno_up<false>(q, mf);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copies of level kk's planes of the fields src(0) .. src(nf-1),
// nf <= NF (the tile's nyt+6 rows and nxt+6 columns; x wrapped, y and z from
// the windows' pads, each (nz+6, ny+6, nx)) into their slot, as one group.
template <int NF, class Src>
__device__ __forceinline__ void load_level(float* sm, const Src& src, int nf, int kk, int i0,
                                           int j0, int nxt, int nyt, int ny, int nx) {
  const int nxl = nxt + 2 * HALO, n = nxl * (nyt + 2 * HALO);
  const int nyp = ny + 2 * HALO;
  float* dst0 = sm + (kk + 3 * NSLOT) % NSLOT * PLANE;
  for (int e = threadIdx.y * TX + threadIdx.x; e < n; e += NT) {
    const int r = e / nxl, c = e - r * nxl;
    const size_t off =
        ((size_t)(kk + HALO) * nyp + (j0 + r)) * nx + wrap(i0 - HALO + c, nx);
    float* dst = dst0 + r * PW + c;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      if (f < nf) cp_async4(dst + f * NSLOT * PLANE, src(f) + off);
    }
  }
  cp_async_commit();
}

}  // namespace
