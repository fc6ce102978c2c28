// Fused anelastic stage for sm_90a: WENO5 momentum and scalar advection,
// FPlane Coriolis, buoyancy, the Smagorinsky-Lilly epilogue, column-linear
// forcings and the SSP-RK3 blend, in one launch.
//
// Replaces breeze_tpu/pallas_kernels/tendency.py::fused_tendency_pallas
// (with closure.py::_smag_block).  The Python wrapper and the plain PyTorch
// version with the same formulas are in breeze_tpu_torch/kernels/tendency.py.
//
// Layout: fields are (z, y, x) float32 with x contiguous.  The windows u, v,
// w, theta, qt, b, thb are padded by HALO in z and y (z walls by mirror /
// odd reflection, y periodic); x is unpadded and periodic.
//
// Bound: float32 operations.  Each output point needs 9 momentum and K
// scalar WENO5 face fluxes (each ~75 operations with its mass flux), ν and
// the closure (~390), ~1600 operations against ~17 fields of traffic: 0.40
// ms at 67 TFLOP/s against 0.27 ms of bytes at 256³.
//
// Design: 2.5-D blocking.  A block of 512 threads owns a TX × TY = 32 × 16
// tile of columns, one thread a column, and marches up a chunk of levels (the
// wrapper's z chunk):
// - a ring of NSLOT = 7 planes per field (levels k-3 .. k+3, the tile plus
//   its 3-point halo, x wrapped at the domain edge) sits in shared memory;
//   the plane of level k+4 is copied in with cp.async into the slot of
//   level k-3 while level k computes, and the blend's inputs (s, s⁰, b) are
//   read at the start of the level so that their latency hides too;
// - each x and y face flux of the level is computed once, by one thread, into
//   shared memory, and every output point takes differences of stored
//   fluxes.  The tile's one extra face per row and column goes to its own
//   warp per field (warp f the y-faces, warp 3+K+f the x-faces), and the
//   second round of the ν halo to the last warps, so that no warp carries
//   two extra pieces of work into the barrier;
// - the z face flux is carried in a register from level k to level k+1 (and
//   seeded at the chunk's first level), so each face is reconstructed once:
//   9 + 3K reconstructions per point, 15 with K = 2;
// - ν is computed one level ahead for the tile plus a 1-point halo into a
//   ring of three ν planes in shared memory (its z-wall mirror: the ring
//   holds ν of the clamped level), so the epilogue reads ν at k-1..k+1
//   without a second launch or a round trip through device memory;
// - ρᵣ multiplies each value as the mass flux of a face is formed.
// What holds it back: instruction issue and its latency.  The ~169 KB of
// shared memory (BOMEX) fits one block, 16 warps, per SM; the closure's
// stresses are still evaluated per output point (each T twice, as the
// reference's block does); a level has two barriers.
// The closure's device code is smagorinsky.cuh, which the closure kernel
// (closure.cu) shares; the tile, the ring and the momentum face fluxes are
// momentum_tile.cuh, which the column-momentum kernel (momentum.cu) shares.

#include "momentum_tile.cuh"
#include "smagorinsky.cuh"

namespace {

// one warp a tile row; warps enough for one extra face of each field in x and y
static_assert(TX == 32 && TY >= 10, "the extra faces take a warp each");
constexpr int NW = TX + 2, NUPLANE = NW * (TY + 2);               // ν with a 1-point halo

struct TendArgs {
  const float *u, *v, *w, *th, *qt, *b, *thb;
  const float *colc, *colf, *invdzc, *invdzf;
  const float *invdzc_e, *invdzf_e, *cd2_e;
  const float *fadd[5], *fdamp[5];
  const float *cur[5], *prev[5];
  float *out[5];
  int nz, ny, nx, K, has_cor, has_clo, buoy_corr, zchunk;
  float inv_dx, inv_dy, f_cor, prandtl, inv_prandtl, g_acc, alpha, dt, oma;
};

// The shared-memory fields: u, v, w, the K scalars, and θᵥ where Lilly's
// correction reads a window other than θ.
struct Layout {
  int nf, tb;              // fields in the ring; the field index of θᵥ
  int nu, flux, floats;    // float offsets of the ν ring and the fluxes; the total
};

__host__ __device__ inline Layout layout(int K, int has_clo, int tb_distinct) {
  Layout l;
  l.nf = 3 + K + (has_clo && tb_distinct ? 1 : 0);
  l.tb = has_clo && tb_distinct ? 3 + K : 3;
  l.nu = l.nf * NSLOT * PLANE;
  l.flux = l.nu + (has_clo ? 3 * NUPLANE : 0);
  l.floats = l.flux + (3 + K) * (XF + YF);
  return l;
}

// The ring of three ν planes seen from (k, j, i); s3 is the slot of level k.
struct NuRing {
  const float* p;
  int k, j, i, s3;
  __device__ __forceinline__ float operator()(int kk, int jj, int ii) const {
    int s = s3 + (kk - k);
    s = s < 0 ? s + 3 : (s >= 3 ? s - 3 : s);
    return p[s * NUPLANE + (jj - j) * NW + (ii - i)];
  }
};

// ---- the scalars' face fluxes (momentum_tile.cuh has the momenta's) -------
__device__ __forceinline__ float flux_xc(const Ring& U, const Ring& C, int k, int j, int x,
                                         float ck) {
  float q[6];
  const float mf = U(k, j, x) * ck;
  for (int o = -2; o <= 3; ++o) q[o + 2] = C(k, j, x + o - 1);
  return mf * weno_up<true>(q, mf);
}
__device__ __forceinline__ float flux_yc(const Ring& V, const Ring& C, int k, int y, int i,
                                         float ck) {
  float q[6];
  const float mf = V(k, y, i) * ck;
  for (int o = -2; o <= 3; ++o) q[o + 2] = C(k, y + o - 1, i);
  return mf * weno_up<true>(q, mf);
}
// z, on the thread's own column, at face kf (ρᵣ at centers colc).
__device__ __forceinline__ float flux_zc(const Ring& W, const Ring& C, int kf, int j, int i,
                                         float cc0, float cc1) {
  float q[6];
  const float mf = 0.5f * (cc0 + cc1) * W(kf, j, i);
  for (int o = -2; o <= 3; ++o) q[o + 2] = C(kf + o - 1, j, i);
  return mf * weno_up<true>(q, mf);
}

__global__ void __launch_bounds__(NT, 1) fused_tendency_kernel(TendArgs a) {
  extern __shared__ float sm[];
  const int K = a.K, nx = a.nx, ny = a.ny, nz = a.nz, nyp = ny + 2 * HALO;
  const int ti = threadIdx.x, tj = threadIdx.y, tid = tj * TX + ti;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int k0 = blockIdx.z * a.zchunk, k1 = min(k0 + a.zchunk, nz);
  const int nxt = min(TX, nx - i0), nyt = min(TY, ny - j0);
  const int i = i0 + ti, j = j0 + tj;
  const bool valid = ti < nxt && tj < nyt;
  const Layout l = layout(K, a.has_clo, a.thb != a.th);
  const Tile t{sm, i0, j0};
  float* nus = sm + l.nu;
  float* FX = sm + l.flux;              // (3+K) × TY × (TX+1)
  float* FY = FX + (3 + K) * XF;        // (3+K) × (TY+1) × TX
  const Col colc{a.colc}, colf{a.colf}, izc_e{a.invdzc_e}, izf_e{a.invdzf_e}, cd2{a.cd2_e};
  const Win B{a.b, nyp, nx};
  const float idx = a.inv_dx, idy = a.inv_dy;
  // the ring's fields: u, v, w, θ, then qᵗ (K = 2) and θᵥ
  const auto field = [&](int f) {
    return f == 0 ? a.u : f == 1 ? a.v : f == 2 ? a.w : f == 3 ? a.th
           : f == 4 && a.K == 2 ? a.qt : a.thb;
  };
  const auto load = [&](int kk) {
    load_level<6>(sm, field, l.nf, kk, i0, j0, nxt, nyt, a.ny, a.nx);
  };

  // ν at level kk (clamped: the wall mirror) for the tile and its 1-point
  // halo into ν slot s3
  auto nu_level = [&](int kk, int s3) {
    const int kc = kk < 0 ? 0 : (kk > nz - 1 ? nz - 1 : kk);
    const int skc = kc % NSLOT, w = nxt + 2;
    const int n = (nyt + 2) * w;
    for (int round = 0; round * NT < n; ++round) {
      // later rounds from the last warp down: the first warps take the extra faces
      const int p = round * NT + (round == 0 ? tid : NT - 1 - tid);
      if (p >= n) continue;
      const int r = p / w, c = p - r * w, jj = j0 - 1 + r, ii = i0 - 1 + c;
      const Ring U = t.ring(0, kc, skc, jj, ii), V = t.ring(1, kc, skc, jj, ii),
                 W = t.ring(2, kc, skc, jj, ii), TB = t.ring(l.tb, kc, skc, jj, ii);
      nus[s3 * NUPLANE + r * NW + c] = smagorinsky_nu(
          U, V, W, TB, izc_e, izf_e, cd2, kc, jj, ii, nz, idx, idy, a.buoy_corr, a.g_acc,
          a.prandtl);
    }
  };

  // ---- the chunk's first planes, ν below it and the z-flux carries --------
  for (int kk = k0 - 3; kk <= k0 + 3; ++kk) load(kk);
  cp_async_wait_all();
  __syncthreads();
  int sk = k0 % NSLOT, s3 = k0 % 3;
  if (a.has_clo) {
    nu_level(k0 - 1, (s3 + 2) % 3);
    nu_level(k0, s3);
  }
  float cu = 0.0f, cv = 0.0f, cw = 0.0f, cc[2] = {0.0f, 0.0f}, bprev = 0.0f;
  if (valid) {
    const Ring U = t.ring(0, k0, sk, j, i), V = t.ring(1, k0, sk, j, i),
               W = t.ring(2, k0, sk, j, i);
    cu = flux_zu(U, W, k0, j, i, colf(k0));
    cv = flux_zv(V, W, k0, j, i, colf(k0));
    cw = flux_zw(W, k0 - 1, j, i, colf(k0 - 1), colf(k0));
#pragma unroll
    for (int s = 0; s < 2; ++s)
      if (s < K)
        cc[s] = flux_zc(W, t.ring(3 + s, k0, sk, j, i), k0, j, i, colc(k0 - 1), colc(k0));
    bprev = B(k0 - 1, j, i);
  }
  __syncthreads();   // slot k0-3 is free for level k0+4

  for (int k = k0; k < k1; ++k) {
    if (k + 4 <= k1 + 2) load(k + 4);
    // the blend's inputs, read now so that their latency hides under the fluxes
    const size_t p = ((size_t)k * ny + j) * nx + i;
    float cur[5], prev[5], bk = 0.0f;
#pragma unroll
    for (int n = 0; n < 5; ++n) {
      if (valid && n < 3 + K) {
        cur[n] = __ldg(a.cur[n] + p);
        prev[n] = __ldg(a.prev[n] + p);
      }
    }
    if (valid) bk = B(k, j, i);
    const float ck = colc(k), ckm = colc(k - 1);
    if (a.has_clo) nu_level(k + 1, s3 == 2 ? 0 : s3 + 1);

    // ---- x and y face fluxes, each once: the thread's own ... ------------
    float fzu = 0.0f, fzv = 0.0f, fzw = 0.0f, fzc[2] = {0.0f, 0.0f};
    if (valid) {
      const Ring U = t.ring(0, k, sk, j, i), V = t.ring(1, k, sk, j, i),
                 W = t.ring(2, k, sk, j, i);
      FX[0 * XF + tj * (TX + 1) + ti + 1] = flux_xu(U, k, j, i, ck);
      FX[1 * XF + tj * (TX + 1) + ti] = flux_xv(U, V, k, j, i, ck);
      FX[2 * XF + tj * (TX + 1) + ti] = flux_xw(U, W, k, j, i, ck, ckm);
      FY[0 * YF + tj * TX + ti] = flux_yu(U, V, k, j, i, ck);
      FY[1 * YF + (tj + 1) * TX + ti] = flux_yv(V, k, j, i, ck);
      FY[2 * YF + tj * TX + ti] = flux_yw(V, W, k, j, i, ck, ckm);
      fzu = flux_zu(U, W, k + 1, j, i, colf(k + 1));
      fzv = flux_zv(V, W, k + 1, j, i, colf(k + 1));
      fzw = flux_zw(W, k, j, i, colf(k), colf(k + 1));
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s < K) {
          const Ring C = t.ring(3 + s, k, sk, j, i);
          FX[(3 + s) * XF + tj * (TX + 1) + ti] = flux_xc(U, C, k, j, i, ck);
          FY[(3 + s) * YF + tj * TX + ti] = flux_yc(V, C, k, j, i, ck);
          fzc[s] = flux_zc(W, C, k + 1, j, i, colc(k), colc(k + 1));
        }
      }
    }
    // ... and the extra face each row and column needs: warp f < 3+K takes
    // field f's y-face past the tile's last row (v: the y-center before its
    // first), for every column; warp 3+K+f field f's x-face past its last
    // column (u: the x-center before its first), for every row
    if (tj < 3 + K) {
      if (ti < nxt) {
        const int ii = i0 + ti, f = tj, y = f == 1 ? j0 - 1 : j0 + nyt;
        const Ring U = t.ring(0, k, sk, y, ii), V = t.ring(1, k, sk, y, ii);
        float fl;
        if (f == 0) fl = flux_yu(U, V, k, y, ii, ck);
        else if (f == 1) fl = flux_yv(V, k, y, ii, ck);
        else if (f == 2) fl = flux_yw(V, t.ring(2, k, sk, y, ii), k, y, ii, ck, ckm);
        else fl = flux_yc(V, t.ring(f, k, sk, y, ii), k, y, ii, ck);
        FY[f * YF + (f == 1 ? 0 : nyt) * TX + ti] = fl;
      }
    } else if (ti < TY) {
      const int f = tj - (3 + K), r = ti;
      if (f < 3 + K && r < nyt) {
        const int jj = j0 + r, x = f == 0 ? i0 - 1 : i0 + nxt;
        const Ring U = t.ring(0, k, sk, jj, x);
        float fl;
        if (f == 0) fl = flux_xu(U, k, jj, x, ck);
        else if (f == 1) fl = flux_xv(U, t.ring(1, k, sk, jj, x), k, jj, x, ck);
        else if (f == 2) fl = flux_xw(U, t.ring(2, k, sk, jj, x), k, jj, x, ck, ckm);
        else fl = flux_xc(U, t.ring(f, k, sk, jj, x), k, jj, x, ck);
        FX[f * XF + r * (TX + 1) + (f == 0 ? 0 : nxt)] = fl;
      }
    }
    __syncthreads();

    if (valid) {
      const Ring U = t.ring(0, k, sk, j, i), V = t.ring(1, k, sk, j, i),
                 W = t.ring(2, k, sk, j, i);
      const float izc = __ldg(a.invdzc + k), izf = __ldg(a.invdzf + k);
      const float* fx = FX + tj * (TX + 1) + ti;
      const float* fy = FY + tj * TX + ti;
      float du = (fx[0 * XF + 1] - fx[0 * XF]) * idx;
      du = du + (fy[0 * YF + TX] - fy[0 * YF]) * idy;
      du = du + (fzu - cu) * izc;
      float dv = (fx[1 * XF + 1] - fx[1 * XF]) * idx;
      dv = dv + (fy[1 * YF + TX] - fy[1 * YF]) * idy;
      dv = dv + (fzv - cv) * izc;
      float dw = (fx[2 * XF + 1] - fx[2 * XF]) * idx;
      dw = dw + (fy[2 * YF + TX] - fy[2 * YF]) * idy;
      dw = dw + (fzw - cw) * izf;
      cu = fzu;
      cv = fzv;
      cw = fzw;

      float g[5];
      g[0] = -du;
      g[1] = -dv;
      if (a.has_cor) {
        const float rv_u = 0.25f * (V(k, j, i) * ck + V(k, j + 1, i) * ck + V(k, j, i - 1) * ck
                                    + V(k, j + 1, i - 1) * ck);
        const float ru_v = 0.25f * (U(k, j, i) * ck + U(k, j, i + 1) * ck + U(k, j - 1, i) * ck
                                    + U(k, j - 1, i + 1) * ck);
        g[0] = g[0] + a.f_cor * rv_u;
        g[1] = g[1] - a.f_cor * ru_v;
      }
      g[2] = -dw + 0.5f * (bprev + bk);
      bprev = bk;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s < K) {
          float acc = (fx[(3 + s) * XF + 1] - fx[(3 + s) * XF]) * idx;
          acc = acc + (fy[(3 + s) * YF + TX] - fy[(3 + s) * YF]) * idy;
          acc = acc + (fzc[s] - cc[s]) * izc;
          cc[s] = fzc[s];
          g[3 + s] = -acc;
        }
      }

      // ---- Smagorinsky-Lilly epilogue ------------------------------------
      if (a.has_clo) {
        const NuRing NU{nus + (tj + 1) * NW + (ti + 1), k, j, i, s3};
        auto scal = [&](int s) { return t.ring(3 + s, k, sk, j, i); };
        smagorinsky_divergences(U, V, W, scal, K, NU, colc, colf, izc_e, izf_e, k, j, i, idx,
                                idy, a.inv_prandtl, g);
      }

      // ---- forcing columns and the SSP-RK3 blend ---------------------------
      const float rho_field[3] = {U(k, j, i) * ck, V(k, j, i) * ck, W(k, j, i) * colf(k)};
#pragma unroll
      for (int n = 0; n < 5; ++n) {
        if (n < 3 + K) {
          float gn = g[n];
          if (a.fadd[n]) gn = gn + __ldg(a.fadd[n] + k);
          if (a.fdamp[n]) {
            if (n < 3) {
              gn = gn - __ldg(a.fdamp[n] + k) * rho_field[n];
            } else {
              gn = gn - __ldg(a.fdamp[n] + k) * t.ring(n, k, sk, j, i)(k, j, i) * ck;
            }
          }
          a.out[n][p] = a.oma * prev[n] + a.alpha * (cur[n] + a.dt * gn);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    sk = sk == NSLOT - 1 ? 0 : sk + 1;
    s3 = s3 == 2 ? 0 : s3 + 1;
  }
}

size_t smem_bytes(int K, int has_clo, int tb_distinct) {
  return sizeof(float) * layout(K, has_clo, tb_distinct).floats;
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
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2]; a.K = ints[3];
  a.has_cor = ints[4]; a.has_clo = ints[5]; a.buoy_corr = ints[6]; a.zchunk = ints[7];
  a.inv_dx = floats[0]; a.inv_dy = floats[1]; a.f_cor = floats[2];
  a.prandtl = floats[3]; a.inv_prandtl = floats[4]; a.g_acc = floats[5];
  a.alpha = floats[6]; a.dt = floats[7]; a.oma = floats[8];

  const size_t smem = smem_bytes(a.K, a.has_clo, a.thb != a.th);
  cudaError_t err = cudaFuncSetAttribute(fused_tendency_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TX, TY, 1);
  const dim3 grid((a.nx + TX - 1) / TX, (a.ny + TY - 1) / TY,
                  (a.nz + a.zchunk - 1) / a.zchunk);
  fused_tendency_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's resources for K scalars, with or without the closure and a
// θᵥ window of its own: out = {shared bytes a block, blocks resident per
// SM, registers a thread, local (spill) bytes a thread}.
int breeze_fused_tendency_info(const int* ints, int* out) {
  const size_t smem = smem_bytes(ints[0], ints[1], ints[2]);
  cudaError_t err = cudaFuncSetAttribute(fused_tendency_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_tendency_kernel, NT,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fused_tendency_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(smem);
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
