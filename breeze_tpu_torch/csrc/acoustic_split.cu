// The per-substep acoustic kernel pair K1/K2 of the split-explicit
// compressible core, for sm_90a.
//
// Replaces breeze_tpu/pallas_kernels/acoustic.py::_run_k1 (body _make_k1)
// and ::_run_k2 (body _make_k2), the pair acoustic_substep_loop_pallas runs
// per substep in place of K3 when BREEZE_TPU_PALLAS_ACOUSTIC_SPLIT is set.
// Its envelope: flat terrain, ρθ, no or thermal divergence damping, no
// sponge, float32 or bfloat16 carries.  The Python wrappers, the plain
// PyTorch versions and the substep loop are in
// breeze_tpu_torch/kernels/acoustic_split.py.
//
// K1, one substep's A and B: the perturbation pressure gradient of
// p′ = Cᴸ(ρθ)′ (gated off by pgf = 0 on a stage's first substep), the
// forward ρu′, ρv′, the new horizontal divergences of ρu′ and θᴸρu′ and the
// explicit (1−ω) part of the vertical ones, giving the predictors ρ′★,
// (ρθ)′★.  One thread per (z, y, x) point, x fastest.  B needs the new ρu′ at
// face i+1 and ρv′ at face j+1: each is pointwise in the previous substep's
// fields, so the thread computes them from p′ at the two columns beside the
// face rather than reading its neighbour's output.  ρw′ at the top wall face
// nz is zero, θᴸ at the faces repeated there (the TPU kernel's padded row).
// Its four outputs are float32 whatever the carries' type.
//
// K2, one substep's C, D and E: the off-centred Crank-Nicolson tridiagonal
// for ρw′ with its coefficients rebuilt from Cᴸ, θᴸ at the faces and 1/Δz
// (the bottom face a Dirichlet row ρw′ = 0, the top face's coupling
// dropped), the recovery of ρ′ and (ρθ)′, and Klemp's thermal damping of
// ρu′, ρv′ from D = ((ρθ)′new − (ρθ)′)/θᴸ, which needs D at x−1 and y−1.
// On the card K2 also adds the stored ρu′, ρv′, ρw′ to the stage's float32
// sums (the TPU driver loop adds them outside, acoustic.py:1126-1128).  Its
// five outputs are in the carries' storage type; D uses the stored (ρθ)′
// carry, widened.  Two launches:
//
// - acoustic_k2_kernel, C and D, as acoustic.cu's substep kernel solves its
//   column: a block owns 32 consecutive x at one y over all nz levels, 512
//   threads in 16 groups of levels, two blocks to an SM, each group
//   marching its run of levels.  The column never leaves the chip: Cᴸ, θᴸ at
//   the faces, ρ′★, (ρθ)′★, the previous (ρθ)′, the right-hand side and c′
//   sit in seven arrays of nz × 32 floats in shared memory (114,688 bytes at
//   nz = 128).  A group first loads its run into them, several levels'
//   loads in flight at once, then works from shared memory.  The pivots'
//   recurrence c′ₖ = upₖ/(diₖ − loₖc′ₖ₋₁) is projective, so each group
//   reduces its run to a 2 × 2 matrix, one thread a column chains the runs'
//   matrices to c′ under each run, and each group then divides its way up
//   its run from there, as the plain version divides by its pivot, with the
//   forward substitution carried as an affine map of d′ under the run; the
//   two substitutions are then chained over the runs as in acoustic.cu.  It
//   writes ρw′, ρ′, (ρθ)′ and Δ(ρθ)′ = (ρθ)′new − (ρθ)′ (float32), and
//   reads nothing from device memory after its loads.
// - acoustic_k2e_kernel, E, one thread a point: ρu′, ρv′ after A damped
//   from D = Δ(ρθ)′/θᴸ at x, x−1 and y−1 (the neighbours from L2), rounded
//   once to the storage type, and the three stored momenta added to their
//   sums.
//
// Why E is a launch of its own: E's D at x−1 and y−1 comes from other
// columns.  A block that solved them again would hold a second row of
// columns (y−1) and one more column (x−1): 66 columns × 7 arrays × 128
// levels × 4 bytes = 236 KB, over the 227 KB a block may have, and twice
// the solves for 32 owned columns.  The second launch instead costs D
// written and read back, 2 field passes, and E reads the stored ρw′ again
// for its sum, 1 more.
//
// Bound: device memory.  K1 reads 12 fields and writes 4 against 46 float32
// operations a point.  K2 with the sums must read 14 fields (K1's four, ρw′,
// ρ′, (ρθ)′, G_ρw, Cᴸ, θᴸ, θᴸ at the faces, three sums) and write 8, 22
// field passes (0.74 GB at 256×256×128 in float32, 0.220 ms at 3.35 TB/s),
// against ~64 operations a point.  The design moves 25: the column kernel
// reads 8 and writes 4 (Δ(ρθ)′ among them), E reads 8 (Δ(ρθ)′, θᴸ and the
// stored ρw′ among them) and writes 5; a run's first level reads ρ′ under
// it again, from L2.  With the stage's sums folded in, the three in-place
// adds a substep the loop made before (9 field passes, 3 launches) are
// gone.  Neither kernel keeps anything on chip across substeps; the port's
// K3 counterpart (acoustic.cu) cuts after D instead of after B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "carry.cuh"

namespace {

template <typename T>
struct K1Args {
  const T *ru, *rv, *rw, *rho, *rt;          // carries of the previous substep
  const float *cl, *th, *thzf;               // Cᴸ, θᴸ, θᴸ at z-faces
  const float *gru, *grv, *grho, *grt;       // slow tendencies
  const float* invdzc;                       // (nz,)
  float *ru_new, *rv_new, *rhos, *rts;       // outputs, float32
  int nz, ny, nx;
  float inv_dx, inv_dy, dtau, pgf, dtau_om1;
};

template <typename T>
__global__ void __launch_bounds__(256) acoustic_k1_kernel(K1Args<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int nx = a.nx, ny = a.ny;
  const size_t plane = (size_t)ny * nx;
  const size_t row = (size_t)k * plane + (size_t)j * nx;
  const size_t p = row + i;
  const size_t pxm = row + (i == 0 ? nx - 1 : i - 1);
  const size_t pxp = row + (i == nx - 1 ? 0 : i + 1);
  const size_t pym = (size_t)k * plane + (size_t)(j == 0 ? ny - 1 : j - 1) * nx + i;
  const size_t pyp = (size_t)k * plane + (size_t)(j == ny - 1 ? 0 : j + 1) * nx + i;
  const float dtau = a.dtau, pgf = a.pgf, idx = a.inv_dx, idy = a.inv_dy;
  auto pressure = [&](size_t q) { return __ldg(a.cl + q) * ld(a.rt + q); };

  // A: the new ρu′ at faces i, i+1 and ρv′ at faces j, j+1
  const float pp = pressure(p);
  const float pp_xm = pressure(pxm), pp_xp = pressure(pxp);
  const float pp_ym = pressure(pym), pp_yp = pressure(pyp);
  const float ru0 = ld(a.ru + p) + dtau * (__ldg(a.gru + p) - pgf * ((pp - pp_xm) * idx));
  const float ru1 = ld(a.ru + pxp) + dtau * (__ldg(a.gru + pxp) - pgf * ((pp_xp - pp) * idx));
  const float rv0 = ld(a.rv + p) + dtau * (__ldg(a.grv + p) - pgf * ((pp - pp_ym) * idy));
  const float rv1 = ld(a.rv + pyp) + dtau * (__ldg(a.grv + pyp) - pgf * ((pp_yp - pp) * idy));

  // B: the horizontal divergences of ρu′ and θᴸρu′ (θᴸ averaged to the faces)
  const float th0 = __ldg(a.th + p);
  const float fx0 = 0.5f * (th0 + __ldg(a.th + pxm)) * ru0;
  const float fx1 = 0.5f * (__ldg(a.th + pxp) + th0) * ru1;
  const float fy0 = 0.5f * (th0 + __ldg(a.th + pym)) * rv0;
  const float fy1 = 0.5f * (__ldg(a.th + pyp) + th0) * rv1;
  const float div_h = (ru1 - ru0) * idx + (rv1 - rv0) * idy;
  const float div_ht = (fx1 - fx0) * idx + (fy1 - fy0) * idy;
  // the explicit vertical part: ρw′ on faces k and k+1 (zero at the top)
  const bool top = k == a.nz - 1;
  const float izc = __ldg(a.invdzc + k);
  const float rw0 = ld(a.rw + p), rw1 = top ? 0.f : ld(a.rw + p + plane);
  const float thf0 = __ldg(a.thzf + p), thf1 = top ? thf0 : __ldg(a.thzf + p + plane);
  const float dzdiv = (rw1 - rw0) * izc;
  const float dzdiv_t = (thf1 * rw1 - thf0 * rw0) * izc;
  a.ru_new[p] = ru0;
  a.rv_new[p] = rv0;
  a.rhos[p] = ld(a.rho + p) + dtau * (__ldg(a.grho + p) - div_h) - a.dtau_om1 * dzdiv;
  a.rts[p] = ld(a.rt + p) + dtau * (__ldg(a.grt + p) - div_ht) - a.dtau_om1 * dzdiv_t;
}

// K2's column kernel: a block owns K2_TILE consecutive x at one y over all
// nz levels, one lane a column, in K2_GROUPS groups of levels (two blocks
// to an SM); K2_SLABS arrays of nz × K2_TILE floats in shared memory.
constexpr int K2_TILE = 32, K2_GROUPS = 16, K2_THREADS = K2_TILE * K2_GROUPS, K2_SLABS = 7;
// A group's run of levels is at least 4 long: a run's map of the pivots (4
// floats) waits in the c′ slots of its first 4 levels for the chain.
constexpr int K2_MIN_RUN = 4;

__host__ __device__ constexpr int k2_run(int nz) {
  return (nz + K2_GROUPS - 1) / K2_GROUPS > K2_MIN_RUN ? (nz + K2_GROUPS - 1) / K2_GROUPS
                                                       : K2_MIN_RUN;
}

size_t k2_smem(int nz) { return sizeof(float) * K2_SLABS * K2_TILE * (size_t)nz; }

template <typename T>
struct K2Args {
  const float *rhos, *rts, *ru_new, *rv_new;   // K1's outputs
  const T *rw, *rho, *rt;                      // carries of the previous substep
  const float *grw, *cl, *th, *thzf;
  const float *invdzc, *invdzf;                // (nz,)
  const float *sru_in, *srv_in, *srw_in;       // the stage's sums so far (null: none)
  T *ru_out, *rv_out, *rw_out, *rho_out, *rt_out;
  float* dd;                                   // Δ(ρθ)′ for E's D (null: no damping)
  float *sru, *srv, *srw;                      // the new sums (may alias the sums so far)
  int nz, ny, nx;
  float dtau, omega, od2, half_g_od2, g_dtau, om_dtau, fac_x, fac_y;
};

template <typename T>
__global__ void __launch_bounds__(K2_THREADS, 2) acoustic_k2_kernel(K2Args<T> a) {
  extern __shared__ float smem[];
  constexpr int tx = K2_TILE;
  const int lane = threadIdx.x, grp = threadIdx.y;
  const int nz = a.nz, ny = a.ny, nx = a.nx;
  const int i = blockIdx.x * tx + lane, j = blockIdx.y;
  const int run = k2_run(nz);
  const int k0 = grp * run, k1 = min(k0 + run, nz);   // this thread's levels
  const int kb = max(k0, 1);                           // its first face of the solve
  const bool col = i < nx, mine = col && k0 < k1;
  const int slab = nz * tx;
  float* s_d = smem;             // C's right-hand side → β → d′ → γ → ρw′
  float* s_cl = s_d + slab;      // Cᴸ → α → δ
  float* s_cp = s_cl + slab;     // the runs' maps of the pivots, then c′
  float* s_thf = s_cp + slab;    // θᴸ at z-faces
  float* s_rho = s_thf + slab;   // ρ′★
  float* s_rt = s_rho + slab;    // (ρθ)′★
  float* s_rtp = s_rt + slab;    // (ρθ)′ of the previous substep
  const int plane = ny * nx, c0 = j * nx + i;
  const float dtau = a.dtau, om = a.omega, om1 = 1.0f - a.omega;
  // C's right-hand side on face k > 0 into s_d from shared memory: level k's
  // ρ′ (staged in s_d, returned) and w = ρw′ + ΔτG_ρw (staged in s_cp), and
  // ρ′★, (ρθ)′★, Cᴸ and the previous (ρθ)′ at k and k−1; rho_b is ρ′ at k−1
  auto rhs = [&](int k, float rho_b) {
    const int s = k * tx + lane, sb = s - tx;
    const float izf = __ldg(a.invdzf + k), rho_p = s_d[s];
    const float ct = s_cl[s] * s_rtp[s], cs = s_cl[s] * s_rt[s];
    const float ct_b = s_cl[sb] * s_rtp[sb], cs_b = s_cl[sb] * s_rt[sb];
    s_d[s] = s_cp[s]
             - a.g_dtau * (om1 * (0.5f * (rho_p + rho_b)) + om * (0.5f * (s_rho[s] + s_rho[sb])))
             - dtau * (om1 * ((ct - ct_b) * izf) + om * ((cs - cs_b) * izf));
    return rho_p;
  };
  // the couplings of face k ≥ 1 to the faces below (lo) and above (up) and
  // its diagonal, from level k−1's Cᴸ, θᴸ at its face and 1/Δz (b) and
  // level k's from shared memory; b then holds level k's
  auto couplings = [&](int k, float (&b)[3], float& lo, float& di, float& up) {
    const int s = k * tx + lane;
    const float clk = s_cl[s], thf = s_thf[s], izc = __ldg(a.invdzc + k);
    const float izf = __ldg(a.invdzf + k);
    const float thf_a = k < nz - 1 ? s_thf[s + tx] : thf;
    lo = a.half_g_od2 * b[2] - a.od2 * izf * b[0] * b[1] * b[2];
    di = 1.0f - a.half_g_od2 * (b[2] - izc) + a.od2 * izf * thf * (clk * izc + b[0] * b[2]);
    up = -a.half_g_od2 * izc - a.od2 * izf * clk * thf_a * izc;
    b[0] = clk;
    b[1] = thf;
    b[2] = izc;
  };

  // ---- 1: each group up its run: its loads into shared memory, unrolled so
  // that several levels' loads are in flight together (ρ′ staged in s_d, ρw′
  // + ΔτG_ρw in s_cp), then C's right-hand side above the run's first face --
  if (mine) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const int o = k * plane + c0, s = k * tx + lane;
      s_cl[s] = __ldg(a.cl + o);
      s_thf[s] = __ldg(a.thzf + o);
      s_rho[s] = __ldg(a.rhos + o);
      s_rt[s] = __ldg(a.rts + o);
      s_rtp[s] = ld(a.rt + o);
      s_d[s] = ld(a.rho + o);
      s_cp[s] = ld(a.rw + o) + dtau * __ldg(a.grw + o);
    }
    float rho_b = s_d[k0 * tx + lane];
    for (int k = k0 + 1; k < k1; ++k) rho_b = rhs(k, rho_b);
  }
  __syncthreads();

  // ---- 2: the run's first face from the level under it, and the run's map
  // of the pivots.  c′ₖ = upₖ/(diₖ − loₖc′ₖ₋₁) is c′ = P/Q with (P, Q)ₖ =
  // (upₖQ, diₖQ − loₖP)ₖ₋₁, linear in (P, Q): a run's recurrence is the
  // product M of its 2 × 2 matrices ----------------------------------------
  float under[3] = {0.f, 0.f, 0.f};   // level kb−1's Cᴸ, θᴸ, 1/Δz, kept for pass 4
  if (mine) {
    const int sb = (kb - 1) * tx + lane;
    under[0] = s_cl[sb];
    under[1] = s_thf[sb];
    under[2] = __ldg(a.invdzc + kb - 1);
    if (k0 > 0) {   // ρ′ under the run is the right-hand side there now: read it again
      rhs(k0, ld(a.rho + (k0 - 1) * plane + c0));
    } else {
      s_d[lane] = 0.f;   // row 0, the wall's Dirichlet row: c′ = d′ = 0
    }
    float m00 = 1.f, m01 = 0.f, m10 = 0.f, m11 = 1.f, b[3] = {under[0], under[1], under[2]};
    for (int k = kb; k < k1; ++k) {
      float lo, di, up;
      couplings(k, b, lo, di, up);
      const float n00 = up * m10, n01 = up * m11;
      m10 = di * m10 - lo * m00;
      m11 = di * m11 - lo * m01;
      m00 = n00;
      m01 = n01;
    }
    if (k1 < nz) {   // every run but the last, whose map nothing reads
      const int s = k0 * tx + lane;
      s_cp[s] = m00;
      s_cp[s + tx] = m01;
      s_cp[s + 2 * tx] = m10;
      s_cp[s + 3 * tx] = m11;
    }
  }
  __syncthreads();

  // ---- 3: one thread a column chains the maps: c′ under each run, into the
  // run's first c′ slot ---------------------------------------------------------
  if (grp == 0 && col) {
    float x = 0.f;   // row 0's c′
    int r = 0;
    for (; (r + 1) * run < nz; ++r) {
      const int s = r * run * tx + lane;
      const float m00 = s_cp[s], m01 = s_cp[s + tx], m10 = s_cp[s + 2 * tx],
                  m11 = s_cp[s + 3 * tx];
      if (r > 0) s_cp[s] = x;
      x = (m00 * x + m01) / (m10 * x + m11);
    }
    if (r > 0) s_cp[r * run * tx + lane] = x;
  }
  __syncthreads();

  // ---- 4: each group up its run: the pivots, dividing by them as the plain
  // version does, and the forward substitution as an affine map of d′
  // under the run, d′ₖ = βₖ + αₖ·d′(under); row 0's is d′ = 0 --------------------
  if (mine) {
    float cp = 0.f, be = 0.f, al = 0.f;
    if (k0 > 0) {
      cp = s_cp[k0 * tx + lane];
      al = 1.f;
    } else {
      s_cp[lane] = 0.f;
      s_cl[lane] = 0.f;
    }
    for (int k = kb; k < k1; ++k) {
      const int s = k * tx + lane;
      float lo, di, up;
      couplings(k, under, lo, di, up);
      const float den = di - lo * cp;
      cp = up / den;
      be = (s_d[s] - lo * be) / den;
      al = -(lo * al) / den;
      s_cp[s] = cp;
      s_d[s] = be;
      s_cl[s] = al;
    }
  }
  __syncthreads();

  // ---- C's two substitutions, each split over the runs as in acoustic.cu:
  // within a run d′ₖ = βₖ + αₖ·(d′ under the run) going up and xₖ = γₖ +
  // δₖ·(x over the run) going down; one thread a column joins the runs,
  // finishing each run's end level and leaving the value under (over) the
  // run in its α (δ) slot there -------------------------------------------------
  if (grp == 0 && col) {
    float dp = 0.f;   // d′ under the first run
    for (int r = 0; r * run < nz; ++r) {
      const int s0 = r * run * tx + lane, s1 = (min((r + 1) * run, nz) - 1) * tx + lane;
      const float d1 = s_d[s1] + s_cl[s1] * dp;
      s_d[s0] += s_cl[s0] * dp;
      s_cl[s0] = dp;
      dp = d1;
    }
  }
  __syncthreads();
  if (mine) {
    const float below = s_cl[k0 * tx + lane];
    for (int k = k0 + 1; k < k1; ++k) {
      const int s = k * tx + lane;
      s_d[s] += s_cl[s] * below;
    }
    float ga = 0.f, de = 1.f;   // γ, δ into s_d, s_cl (row 0's c′ is 0: its value stays)
    for (int k = k1 - 1; k >= k0; --k) {
      const int s = k * tx + lane;
      const float c = s_cp[s];
      ga = s_d[s] - c * ga;
      de = -c * de;
      s_d[s] = ga;
      s_cl[s] = de;
    }
  }
  __syncthreads();
  if (grp == 0 && col) {
    float x = 0.f;   // over the top run: the top face's coupling is dropped
    for (int r = (nz - 1) / run; r >= 0; --r) {
      const int s0 = r * run * tx + lane, s1 = (min((r + 1) * run, nz) - 1) * tx + lane;
      const float x0 = s_d[s0] + s_cl[s0] * x;
      s_d[s1] += s_cl[s1] * x;
      s_cl[s1] = x;
      x = x0;
    }
  }
  __syncthreads();

  // ---- D: the recovery, the carries and Δ(ρθ)′ for E's D -------------------
  if (mine) {
    const float above = s_cl[(k1 - 1) * tx + lane];   // ρw′ on the face over the run
    for (int k = k0; k < k1 - 1; ++k) {
      const int s = k * tx + lane;
      s_d[s] += s_cl[s] * above;
    }
    for (int k = k0; k < k1; ++k) {
      const int s = k * tx + lane, o = k * plane + c0;
      const bool top = k == nz - 1;
      const float x = s_d[s], x_a = top ? 0.f : k + 1 < k1 ? s_d[s + tx] : above;
      const float thw = s_thf[s] * x, thw_a = top ? 0.f : s_thf[s + tx] * x_a;
      const float izc = __ldg(a.invdzc + k);
      const float rho_new = s_rho[s] - a.om_dtau * (x_a - x) * izc;
      const float rt_new = s_rt[s] - a.om_dtau * (thw_a - thw) * izc;
      st(a.rw_out + o, x);
      st(a.rho_out + o, rho_new);
      st(a.rt_out + o, rt_new);
      if (a.dd) a.dd[o] = rt_new - s_rtp[s];
    }
  }
}

// K2's E: ρu′, ρv′ after A damped from D = Δ(ρθ)′/θᴸ at x, x−1 and y−1
// (thermal), rounded to the storage type; the three stored momenta added
// to their sums.  One thread a point.
template <typename T>
__global__ void __launch_bounds__(256) acoustic_k2e_kernel(K2Args<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int nx = a.nx, ny = a.ny;
  const size_t row = (size_t)k * ny;
  const size_t p = (row + j) * nx + i;
  float ru = __ldg(a.ru_new + p), rv = __ldg(a.rv_new + p);
  if (a.dd) {
    const size_t pxm = (row + j) * nx + (i == 0 ? nx - 1 : i - 1);
    const size_t pym = (row + (j == 0 ? ny - 1 : j - 1)) * nx + i;
    auto D = [&](size_t q) { return __ldg(a.dd + q) / __ldg(a.th + q); };
    const float d0 = D(p);
    ru = ru - a.fac_x * (d0 - D(pxm));
    rv = rv - a.fac_y * (d0 - D(pym));
  }
  ru = st(a.ru_out + p, ru);
  rv = st(a.rv_out + p, rv);
  if (a.sru) {
    a.sru[p] = a.sru_in[p] + ru;
    a.srv[p] = a.srv_in[p] + rv;
    a.srw[p] = a.srw_in[p] + ld(a.rw_out + p);
  }
}

template <typename T>
int launch_k1(const void* const* ptrs, const int* ints, const float* floats, cudaStream_t s) {
  K1Args<T> a;
  int n = 0;
  const T** carries[] = {&a.ru, &a.rv, &a.rw, &a.rho, &a.rt};
  for (const T** dst : carries) *dst = static_cast<const T*>(ptrs[n++]);
  const float** in[] = {&a.cl, &a.th, &a.thzf, &a.gru, &a.grv, &a.grho, &a.grt, &a.invdzc};
  for (const float** dst : in) *dst = static_cast<const float*>(ptrs[n++]);
  float** out[] = {&a.ru_new, &a.rv_new, &a.rhos, &a.rts};
  for (float** dst : out) *dst = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2];
  a.inv_dx = floats[0]; a.inv_dy = floats[1]; a.dtau = floats[2]; a.pgf = floats[3];
  a.dtau_om1 = floats[4];
  const dim3 block(32, 8, 1);
  const dim3 grid((a.nx + 31) / 32, (a.ny + 7) / 8, a.nz);
  acoustic_k1_kernel<T><<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The column kernel's dynamic shared memory raised to the card's opt-in
// limit a block, once; cudaErrorInvalidValue when nz levels do not fit.
template <typename T>
cudaError_t prepared_k2(int nz) {
  static int max_smem = 0;
  if (max_smem == 0) {
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(acoustic_k2_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return err;
    max_smem = limit;
  }
  return k2_smem(nz) <= (size_t)max_smem ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
int launch_k2(const void* const* ptrs, const int* ints, const float* floats, cudaStream_t s) {
  K2Args<T> a;
  int n = 0;
  const float** k1[] = {&a.rhos, &a.rts, &a.ru_new, &a.rv_new};
  for (const float** dst : k1) *dst = static_cast<const float*>(ptrs[n++]);
  const T** carries[] = {&a.rw, &a.rho, &a.rt};
  for (const T** dst : carries) *dst = static_cast<const T*>(ptrs[n++]);
  const float** in[] = {&a.grw, &a.cl, &a.th, &a.thzf, &a.invdzc, &a.invdzf,
                        &a.sru_in, &a.srv_in, &a.srw_in};
  for (const float** dst : in) *dst = static_cast<const float*>(ptrs[n++]);
  T** out[] = {&a.ru_out, &a.rv_out, &a.rw_out, &a.rho_out, &a.rt_out};
  for (T** dst : out) *dst = static_cast<T*>(const_cast<void*>(ptrs[n++]));
  float** scratch[] = {&a.dd, &a.sru, &a.srv, &a.srw};
  for (float** dst : scratch) *dst = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2];
  float* f[] = {&a.dtau, &a.omega, &a.od2, &a.half_g_od2, &a.g_dtau, &a.om_dtau,
                &a.fac_x, &a.fac_y};
  n = 0;
  for (float* dst : f) *dst = floats[n++];
  // the column kernel indexes the fields with 32-bit offsets
  if ((size_t)a.nz * a.ny * a.nx >= (size_t)1 << 31) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepared_k2<T>(a.nz);
  if (err != cudaSuccess) return static_cast<int>(err);
  acoustic_k2_kernel<T><<<dim3((a.nx + K2_TILE - 1) / K2_TILE, a.ny, 1),
                          dim3(K2_TILE, K2_GROUPS, 1), k2_smem(a.nz), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32, 8, 1);
  acoustic_k2e_kernel<T><<<dim3((a.nx + 31) / 32, (a.ny + 7) / 8, a.nz), block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K2's column kernel's resources for nz levels: out = {shared bytes a
// block, blocks resident per SM, registers a thread, local (spill) bytes a
// thread}.
template <typename T>
int k2_info(int nz, int* out) {
  cudaError_t err = prepared_k2<T>(nz);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, acoustic_k2_kernel<T>, K2_THREADS,
                                                      k2_smem(nz));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, acoustic_k2_kernel<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(k2_smem(nz));
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace

extern "C" {

// K1.  ptrs, in the carries' storage type (bfloat16 when ints[3], else
// float32): ru, rv, rw, rho, rt; in float32: cl, th, thzf, gru, grv, grho,
// grt, invdzc (nz,), then the outputs ru_new, rv_new, rhos, rts;
// ints: nz, ny, nx, bf16; floats: 1/Δx, 1/Δy, Δτ, pgf, Δτ(1−ω).
int breeze_acoustic_k1(const void* const* ptrs, const int* ints, const float* floats,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ints[3] ? launch_k1<__nv_bfloat16>(ptrs, ints, floats, s)
                 : launch_k1<float>(ptrs, ints, floats, s);
}

// K2, two launches: the column kernel (C, D) and E.  ptrs, in float32:
// rhos, rts, ru_new, rv_new (K1's outputs); in the storage type: rw, rho,
// rt; in float32: grw, cl, th, thzf, invdzc (nz,), invdzf (nz,), the
// stage's sums so far sru, srv, srw (null: no sums); in the storage type
// the outputs ru, rv, rw, rho, rt; in float32 D (scratch, (nz, ny, nx);
// null: no damping) and the new sums (may be the sums so far; null with
// them); ints: nz, ny, nx, bf16; floats: Δτ, ω, ω²Δτ², ½gω²Δτ², gΔτ, ωΔτ,
// αΔx/Δτ, αΔy/Δτ.
int breeze_acoustic_k2(const void* const* ptrs, const int* ints, const float* floats,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ints[3] ? launch_k2<__nv_bfloat16>(ptrs, ints, floats, s)
                 : launch_k2<float>(ptrs, ints, floats, s);
}

// K2's column kernel's resources for ints = {nz, bf16}: out as k2_info's.
int breeze_acoustic_k2_info(const int* ints, int* out) {
  return ints[1] ? k2_info<__nv_bfloat16>(ints[0], out) : k2_info<float>(ints[0], out);
}

}  // extern "C"
