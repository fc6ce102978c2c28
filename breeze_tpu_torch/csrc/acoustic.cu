// Acoustic substeps of the split-explicit compressible core for sm_90a.
//
// Replaces breeze_tpu/pallas_kernels/acoustic.py::_run_k3 (body _make_k3,
// entry point acoustic_substep_loop_pallas) on all its branches: flat or
// σ-terrain (LinearDecay or SLEVE), the ρe coupling C_ρ (flat), thermal,
// direct or no divergence damping, with or without the upper Rayleigh
// sponge, float32 or bfloat16 carries.  The Python wrapper and the plain
// PyTorch version (the jnp substep loop of dynamics/compressible.py) are in
// breeze_tpu_torch/kernels/acoustic.py.
//
// One substep advances the perturbations (ρ′, ρu′, ρv′, ρw′, (ρχ)′, χ = θ
// or e) about the stage-entry state:
//   A. forward ρu′, ρv′ under the slow tendencies and the perturbation
//      pressure gradient p′ = Cᴸ(ρχ)′ (+ C_ρρ′ in ρe; gated off on a stage's
//      first substep by pgf = 0); over terrain slope-corrected,
//      ∂x p′ − sx·½(∂z p′ at the two centers beside the face), with
//      ∂z p′ = (1/J)∂ζ p′ moved from ζ-faces to ζ-centers;
//   B. the predictors ρ′★, (ρχ)′★ from the new horizontal divergences;
//      over terrain the fluxes are J-weighted and the divergences ×1/J, and
//      the vertical flux is the contravariant ρw̃′ = ρw′ − S′, with
//      S′ = sx·ℑxz(ρu′) + sy·ℑyz(ρv′) at ζ-faces;
//   C. the off-centred Crank-Nicolson column solve for ρw′ (the top face's
//      coupling dropped; the bottom face ρw′ = 0 when flat, ρw′ = S′ of the
//      new momenta over terrain, the kinematic bottom); 1/J factors on its
//      couplings over terrain; the sponge ωΔτ·r on its diagonal and
//      (1−ω)Δτ·r·ρw′ on its right-hand side (r = rate × ramp at the face);
//      in ρe the C_ρ couplings with unit face weight on its three
//      coefficients and C_ρρ′ in the right-hand side's pressure;
//   D. the recovery of ρ′ and (ρχ)′ (×1/J over terrain);
//   E. the divergence damping of ρu′, ρv′: Klemp's thermal form from
//      D = δτ(ρθ)′/θᴸ, or the direct form +αΔx ∂xδ/θᴸₓ from
//      δ = ∂x(θᴸₓρu′) + ∂y(θᴸᵧρv′) of the new momenta; and the sums of
//      ρu′, ρv′, ρw′ over the substeps.
//
// Bound: device memory.  One 256×256×128 float32 field is 33.5 MB and a
// substep does ~110 float32 operations a point, so only the bytes count.
// The TPU kernel keeps a stage's substeps of a y-strip in VMEM; 227 KB of
// shared memory a block cannot hold one substep's inputs of a useful tile
// (the five carries of one 128-level column alone are 2.5 KB), so a
// substep makes one pass over device memory and the design cuts what each
// pass moves to what it must: its inputs read once, its outputs written
// once, and nothing written only to be read back.  What then holds it
// back is the latency of the march's loads: a group's levels are
// sequential, so the card needs many groups in flight, and registers, not
// shared memory, cap them.  Three launches:
//
// - acoustic_pivot_kernel, once per stage: the tridiagonal's coefficients
//   depend only on the stage's caches and columns, so each column is
//   factored once, into c′ and 1/den (two float32 fields, row 0 the
//   Dirichlet row: c′ = 0, 1/den = 1).  One thread per column marching up.
// - acoustic_substep_kernel, once per substep: A–D, and the previous
//   substep's E folded in.  A block owns 32 consecutive x at one y over all
//   nz levels, 512 threads (384 over terrain), two blocks to an SM: 32
//   lanes across x (so every load coalesces) by groups of levels, each
//   group marching a run with A one row ahead of B and the level below
//   carried in registers (over terrain A starts one row under the run).  A
//   level's global stores follow all its loads.  B's divergence needs the
//   new ρu′ at x+1 and ρv′ at y+1, each pointwise in the previous
//   substep's fields, so the thread computes them itself.  The right-hand
//   side times 1/den, the lower coupling times 1/den, c′, ρ′★, (ρχ)′★, χᴸ at
//   the faces and the previous (ρχ)′ go to shared memory (seven arrays of
//   nz × 32); after a barrier each run's first face takes its level below
//   from there.  The two substitutions (d′ₖ = d·(1/den) − lo·(1/den)·d′ₖ₋₁,
//   then xₖ = d′ₖ − c′ₖxₖ₊₁) are split over the runs: a group reduces its
//   run to an affine map of the value under it (over it, going down), one
//   thread per column chains the runs' maps, and the groups apply them and
//   recover D.  No sweep scratch goes through device memory.
// - acoustic_close_kernel, once per stage: the last substep's E and sums.
//
// E needs D (or δ) at x−1 and y−1, which other blocks produce, so a pass
// stores ρu′, ρv′ after A (float32) and the damping input (D = Δ(ρθ)′/θᴸ
// for the thermal form, δ for the direct form), and the next pass forms the
// damped carries ρu′, ρv′ at the points it reads, rounds each once to the
// storage type, and adds its own to the sums.  One pass per substep moves
// ~28 fields (it reads the carries, the caches, the five slow tendencies,
// the two pivot fields, the damping input and the sums, and writes the
// carries, the damping input and the sums), against ~42 in two launches
// before.  ρu′, ρv′ after A, the damping input, ρ′ and (ρχ)′ are read at
// neighbouring columns, so they ping-pong between two buffers (in the
// wrapper); ρw′ and the sums are read only at their own point and are
// updated in place after a stage's first pass.  The caller's tensors are
// never written.  The arithmetic is float32 and the sums add the rounded
// carries.  The terrain, sponge and C_ρ branches and the carries' storage
// type are template parameters; the four Jacobian factors are read with a
// z-stride of 0 when they are ζ-independent (LinearDecay).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "carry.cuh"

namespace {

template <typename T>
struct AcArgs {
  const T *ru_in, *rv_in;                   // the caller's ρu′, ρv′ (a stage's first pass)
  const T *rt_in, *rho_in;                  // previous substep (read only)
  const T* rw_in;                           // previous substep (may alias rw_out)
  const float *ruw_in, *rvw_in, *dd_in;     // previous pass: ρu′, ρv′ after A, damping input
  const float *cl, *th, *thzf;              // Cᴸ, χᴸ, χᴸ at z-faces
  const float* crho;                        // C_ρ (ρe; null otherwise)
  const float *gru, *grv, *grw, *grho, *grt;
  const float *invdzc, *invdzf;             // (nz,)
  const float *sru_in, *srv_in, *srw_in;    // sums so far (may alias sru, ...)
  T *ru_out, *rv_out;                       // the stage's last ρu′, ρv′ (closing pass)
  T *rt_out, *rho_out, *rw_out;             // this substep
  float *ruw_out, *rvw_out, *dd_out;        // this pass: ρu′, ρv′ after A, damping input
  float *cp, *inv;                          // the pivots c′ and 1/den
  float *sru, *srv, *srw;                   // running sums
  // terrain: 1/J at ζ-centers and ζ-faces, J at x- and y-faces (z-extent 1
  // or nz), the slopes at (ζ-face, x/y-center) and (ζ-center, x/y-face)
  const float *ijc, *ijf, *jxf, *jyf, *sxz, *syz, *sxc, *syc;
  const float* sponge;                      // (nz,) rate × ramp at z-faces
  int nz, ny, nx, damp, terrain, has_sponge, jz, has_crho, bf16, first;
  float inv_dx, inv_dy, dtau, omega, pgf;
  float od2, half_g_od2, g_dtau, dtau_om1, om_dtau, fac_x, fac_y;
};

// damp: the damping's form
constexpr int kThermal = 1, kDirect = 2;
// the substep kernel's columns a block (one warp across x) and its shared
// arrays of nz × kTile, which cap nz at 259 under 227 KB a block
constexpr int kTile = 32, kSlabs = 7;

// The substep kernel's threads a block, two blocks to an SM: 16 groups of
// levels under a cap of 64 registers, or over terrain, whose march keeps
// more in registers, 12 groups under 85.  Occupancy is what hides the
// march's load latency.
constexpr int substep_threads(bool terrain) { return terrain ? 384 : 512; }

// The coefficient columns of one level k: Cᴸ, C_ρ, 1/Δz, 1/J at the
// center, and χᴸ on face k.
struct Level {
  float cl, cr, izc, ijc, thf;
};

template <bool TERRAIN, bool CRHO, typename T>
__device__ __forceinline__ Level level(const AcArgs<T>& a, int k, size_t c0, size_t plane,
                                       size_t jstride) {
  const size_t o = (size_t)k * plane + c0;
  return {__ldg(a.cl + o), CRHO ? __ldg(a.crho + o) : 0.f, __ldg(a.invdzc + k),
          TERRAIN ? __ldg(a.ijc + (size_t)k * jstride + c0) : 1.f, __ldg(a.thzf + o)};
}

// The tridiagonal's coupling of face k to face k−1, from level k−1 (b) and
// face k's 1/Δz and 1/J.
template <bool CRHO, typename T>
__device__ __forceinline__ float lower(const AcArgs<T>& a, const Level& b, float izf, float ijf) {
  float lo = a.half_g_od2 * b.izc * b.ijc - a.od2 * izf * b.cl * b.thf * b.izc * ijf * b.ijc;
  if (CRHO) lo -= a.od2 * izf * b.cr * b.izc * ijf * b.ijc;   // unit face weight
  return lo;
}

// g/t correctly rounded, as the plain version's IEEE divide, without the
// divide's slow-path call (whose registers every instance pays for, the
// damping's form being a run-time flag): 1/t from the hardware reciprocal
// (≤ 2 ulp) refined twice by Newton in double, to ~2⁻⁵², times g, rounded
// once.  The quotient of two floats is never within 2⁻⁴⁹ of a midpoint
// between floats, so that rounding is the IEEE divide's.  t is θᴸₓ:
// positive and far below 2¹²⁶.
__device__ __forceinline__ float div_rn(float g, float t) {
  const double td = t;
  double y = __fdividef(1.0f, t);
  y = fma(fma(-td, y, 1.0), y, y);
  y = fma(fma(-td, y, 1.0), y, y);
  return __double2float_rn(static_cast<double>(g) * y);
}

// A face's momentum after E, from its value after A (w), the damping input
// on the two sides of the face (d0 the cell above in index, d1 below) and
// θᴸ there: −αΔx/Δτ ∂x D (thermal) or +αΔx ∂xδ/θᴸₓ (direct).  Unrounded.
template <typename T>
__device__ __forceinline__ float damped(const AcArgs<T>& a, float w, float d0, float d1,
                                        float t0, float t1, float fac) {
  const float g = fac * (d0 - d1);
  if (a.damp == kDirect) return w + div_rn(g, 0.5f * (t0 + t1));
  return a.damp == kThermal ? w - g : w;
}

// The new (and previous) ρu′ at faces i, i+1 and ρv′ at faces j, j+1 of one
// row of a column.
struct Row {
  float ru0, ru1, rv0, rv1;   // new
  float ou0, ou1, ov0, ov1;   // previous substep, damped and rounded
};

template <bool TERRAIN, bool SPONGE, bool CRHO>
__global__ void __launch_bounds__(128) acoustic_pivot_kernel(AcArgs<float> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= a.nx || j >= a.ny) return;
  const size_t plane = (size_t)a.ny * a.nx, jstride = a.jz ? plane : 0;
  const size_t c0 = (size_t)j * a.nx + i;
  a.cp[c0] = 0.f;    // row 0: the Dirichlet row
  a.inv[c0] = 1.f;
  Level b = level<TERRAIN, CRHO>(a, 0, c0, plane, jstride);
  float cp_b = 0.f;
  for (int k = 1; k < a.nz; ++k) {
    const Level l = level<TERRAIN, CRHO>(a, k, c0, plane, jstride);
    const size_t o = (size_t)k * plane + c0;
    const float izf = __ldg(a.invdzf + k);
    const float ijfk = TERRAIN ? __ldg(a.ijf + (size_t)k * jstride + c0) : 1.f;
    const float thf_a = k == a.nz - 1 ? l.thf : __ldg(a.thzf + o + plane);
    const float lo = lower<CRHO>(a, b, izf, ijfk);
    float di = 1.0f - a.half_g_od2 * (b.izc * b.ijc - l.izc * l.ijc)
               + a.od2 * izf * l.thf * (l.cl * l.izc * l.ijc + b.cl * b.izc * b.ijc) * ijfk;
    float up = -a.half_g_od2 * l.izc * l.ijc - a.od2 * izf * l.cl * thf_a * l.izc * ijfk * l.ijc;
    if (CRHO) {
      di += a.od2 * izf * (l.cr * l.izc * l.ijc + b.cr * b.izc * b.ijc) * ijfk;
      up -= a.od2 * izf * l.cr * l.izc * ijfk * l.ijc;
    }
    if (SPONGE) di += a.om_dtau * __ldg(a.sponge + k);
    const float inv = 1.0f / (di - lo * cp_b);
    cp_b = up * inv;
    a.cp[o] = cp_b;
    a.inv[o] = inv;
    b = l;
  }
}

template <typename T, bool TERRAIN, bool SPONGE, bool CRHO>
__global__ void __launch_bounds__(substep_threads(TERRAIN), 2)
    acoustic_substep_kernel(AcArgs<T> a) {
  extern __shared__ float smem[];
  constexpr int tx = kTile;
  const int lane = threadIdx.x;
  const int nz = a.nz, ny = a.ny, nx = a.nx;
  const int i = blockIdx.x * tx + lane, j = blockIdx.y;
  const int run = (nz + blockDim.y - 1) / blockDim.y;
  const int k0 = threadIdx.y * run, k1 = min(k0 + run, nz);   // this thread's levels
  const bool mine = i < nx && k0 < k1;
  const int slab = nz * tx;
  float* s_b = smem;              // d·(1/den) → d′ → ρw′
  float* s_a = s_b + slab;        // lo·(1/den)
  float* s_c = s_a + slab;        // c′
  float* s_rho = s_c + slab;      // ρ′★
  float* s_rt = s_rho + slab;     // (ρχ)′★
  float* s_thf = s_rt + slab;     // χᴸ at z-faces
  float* s_rtp = s_thf + slab;    // (ρχ)′ of the previous substep
  const int plane = ny * nx;
  const int jstride = a.jz ? plane : 0;   // the Jacobians' z-stride
  const int c0 = j * nx + i;
  const float dtau = a.dtau, om = a.omega, om1 = 1.0f - a.omega;
  // C's right-hand side on face k > 0 and its lower coupling, each ×1/den,
  // into shared memory, from level k's values and level k−1's (_b)
  auto rhs = [&](int k, float rw0, float rho_p, float rhos, float ct, float cs,
                 float rho_b, float rhos_b, float ct_b, float cs_b, const Level& lb, int s) {
    const int o = k * plane + c0;
    const float izf = __ldg(a.invdzf + k);
    const float ijfk = TERRAIN ? __ldg(a.ijf + k * jstride + c0) : 1.f;
    const float dzC = (om1 * ((ct - ct_b) * izf) + om * ((cs - cs_b) * izf)) * ijfk;
    float d = rw0 + dtau * __ldg(a.grw + o)
              - a.g_dtau * (om1 * (0.5f * (rho_p + rho_b)) + om * (0.5f * (rhos + rhos_b)))
              - dtau * dzC;
    if (SPONGE) d -= a.dtau_om1 * __ldg(a.sponge + k) * rw0;
    const float inv = __ldg(a.inv + o);
    s_a[s] = lower<CRHO>(a, lb, izf, ijfk) * inv;
    s_b[s] = d * inv;
  };

  // ---- A, B, the right-hand side: each group up its run of levels ----------
  if (mine) {
    const int im = i == 0 ? nx - 1 : i - 1, ip = i == nx - 1 ? 0 : i + 1;
    const int jm = j == 0 ? ny - 1 : j - 1, jp = j == ny - 1 ? 0 : j + 1;
    // the five columns A reads: 0 own, 1 x−1, 2 x+1, 3 y−1, 4 y+1
    const int col[5] = {c0, j * nx + im, j * nx + ip, jm * nx + i, jp * nx + i};
    const float pgf = a.pgf, idx = a.inv_dx, idy = a.inv_dy;
    // p′ = Cᴸ(ρχ)′ (+ C_ρρ′) of the previous substep at point p
    auto pressure = [&](int p) {
      float v = __ldg(a.cl + p) * ld(a.rt_in + p);
      if (CRHO) v += __ldg(a.crho + p) * ld(a.rho_in + p);
      return v;
    };
    // the previous substep's ρu′ at faces i, i+1 and ρv′ at j, j+1 of row o:
    // the caller's on a stage's first pass, else the previous pass's values
    // after A with E applied, rounded once to the storage type
    auto carries = [&](int o, Row& r) {
      if (a.first) {
        r.ou0 = ld(a.ru_in + o + col[0]);
        r.ou1 = ld(a.ru_in + o + col[2]);
        r.ov0 = ld(a.rv_in + o + col[0]);
        r.ov1 = ld(a.rv_in + o + col[4]);
        return;
      }
      float d[5] = {0.f, 0.f, 0.f, 0.f, 0.f}, t[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 5; ++n) {
        if (a.damp) d[n] = __ldg(a.dd_in + o + col[n]);
        if (a.damp == kDirect) t[n] = __ldg(a.th + o + col[n]);
      }
      r.ou0 = rnd<T>(damped(a, __ldg(a.ruw_in + o + col[0]), d[0], d[1], t[0], t[1], a.fac_x));
      r.ou1 = rnd<T>(damped(a, __ldg(a.ruw_in + o + col[2]), d[2], d[0], t[2], t[0], a.fac_x));
      r.ov0 = rnd<T>(damped(a, __ldg(a.rvw_in + o + col[0]), d[0], d[3], t[0], t[3], a.fac_y));
      r.ov1 = rnd<T>(damped(a, __ldg(a.rvw_in + o + col[4]), d[4], d[0], t[4], t[0], a.fac_y));
    };

    // A, one row at a time, bottom up.  pp: p′ of row m in the five
    // columns; dzf: (1/J)∂ζ p′ on face m (terrain)
    float pp[5], dzf[5];
    auto row_a = [&](int m) {
      const int o = m * plane;
      const bool last = m == nz - 1;
      float pn[5];
      float sl_x0 = 0.f, sl_x1 = 0.f, sl_y0 = 0.f, sl_y1 = 0.f;
#pragma unroll
      for (int n = 0; n < 5; ++n) pn[n] = last ? 0.f : pressure(o + plane + col[n]);
      if (TERRAIN) {
        // (1/J)∂ζ p′ on face m+1 and at center m (the top row duplicated)
        float dc[5];
        const float izf1 = last ? 0.f : __ldg(a.invdzf + m + 1);
#pragma unroll
        for (int n = 0; n < 5; ++n) {
          const float f1 = last ? dzf[n]
                                : (pn[n] - pp[n]) * izf1 * __ldg(a.ijf + (m + 1) * jstride + col[n]);
          dc[n] = 0.5f * (dzf[n] + f1);
          dzf[n] = f1;
        }
        sl_x0 = __ldg(a.sxc + o + col[0]) * (0.5f * (dc[0] + dc[1]));
        sl_x1 = __ldg(a.sxc + o + col[2]) * (0.5f * (dc[2] + dc[0]));
        sl_y0 = __ldg(a.syc + o + col[0]) * (0.5f * (dc[0] + dc[3]));
        sl_y1 = __ldg(a.syc + o + col[4]) * (0.5f * (dc[4] + dc[0]));
      }
      Row r;
      carries(o, r);
      r.ru0 = r.ou0 + dtau * (__ldg(a.gru + o + col[0]) - pgf * ((pp[0] - pp[1]) * idx - sl_x0));
      r.ru1 = r.ou1 + dtau * (__ldg(a.gru + o + col[2]) - pgf * ((pp[2] - pp[0]) * idx - sl_x1));
      r.rv0 = r.ov0 + dtau * (__ldg(a.grv + o + col[0]) - pgf * ((pp[0] - pp[3]) * idy - sl_y0));
      r.rv1 = r.ov1 + dtau * (__ldg(a.grv + o + col[4]) - pgf * ((pp[4] - pp[0]) * idy - sl_y1));
#pragma unroll
      for (int n = 0; n < 5; ++n) pp[n] = pn[n];
      return r;
    };
    // a row of this thread's run: store ρu′, ρv′ after A and add the
    // previous substep's carries to the sums
    auto own_row = [&](int m, const Row& r) {
      if (m < k0 || m >= k1) return;
      const int o = m * plane + c0;
      a.ruw_out[o] = r.ru0;
      a.rvw_out[o] = r.rv0;
      if (!a.first) {
        a.sru[o] = a.sru_in[o] + r.ou0;
        a.srv[o] = a.srv_in[o] + r.ov0;
      }
    };
    // S′ on face m from the momenta of rows m and m−1
    auto slope_part = [&](int m, float u0, float u1, float ub0, float ub1,
                          float v0, float v1, float vb0, float vb1) {
      const int o = m * plane + c0;
      return __ldg(a.sxz + o) * (0.25f * (u0 + u1 + ub0 + ub1))
             + __ldg(a.syz + o) * (0.25f * (v0 + v1 + vb0 + vb1));
    };

    // A starts at the run's first level, over terrain one row under it (S′
    // on face k0 needs row k0−1)
    const int ma = TERRAIN ? max(k0 - 1, 0) : k0;
#pragma unroll
    for (int n = 0; n < 5; ++n) {
      pp[n] = pressure(ma * plane + col[n]);
      dzf[n] = 0.f;   // face 0: p′ is mirrored below the wall
      if (TERRAIN && ma > 0)
        dzf[n] = (pp[n] - pressure((ma - 1) * plane + col[n])) * __ldg(a.invdzf + ma)
                 * __ldg(a.ijf + ma * jstride + col[n]);
    }
    Row cur = row_a(ma);
    own_row(ma, cur);
    float sn = 0.f, so = 0.f;   // S′ of the new and the previous momenta on face k
    if (TERRAIN) {
      Row below = cur;          // face 0: row −1 is row 0
      if (ma < k0) {
        cur = row_a(k0);
        own_row(k0, cur);
      }
      sn = slope_part(k0, cur.ru0, cur.ru1, below.ru0, below.ru1,
                      cur.rv0, cur.rv1, below.rv0, below.rv1);
      so = slope_part(k0, cur.ou0, cur.ou1, below.ou0, below.ou1,
                      cur.ov0, cur.ov1, below.ov0, below.ov1);
    }

    // values of the level below, carried up the run (the run's first face
    // takes them from the run below after a barrier)
    float rho_b = 0.f, rhos_b = 0.f, ct_b = 0.f, cs_b = 0.f;
    Level lb = {0.f, 0.f, 0.f, 1.f, 0.f};
    for (int k = k0; k < k1; ++k) {
      const int o = k * plane;
      const float* th = a.th + o;
      const bool top = k == nz - 1;
      // A one row ahead (over terrain also above the run, for S′ on face
      // k+1, zero on the top wall face).  The level's global stores come
      // after all its loads, which can then be in flight together.
      Row nxt = cur;
      float sn1 = 0.f, so1 = 0.f;
      const bool ahead = !top && (TERRAIN || k + 1 < k1);
      if (ahead) {
        nxt = row_a(k + 1);
        if (TERRAIN) {
          sn1 = slope_part(k + 1, nxt.ru0, nxt.ru1, cur.ru0, cur.ru1,
                           nxt.rv0, nxt.rv1, cur.rv0, cur.rv1);
          so1 = slope_part(k + 1, nxt.ou0, nxt.ou1, cur.ou0, cur.ou1,
                           nxt.ov0, nxt.ov1, cur.ov0, cur.ov1);
        }
      }

      // ---- B: predictors ---------------------------------------------------
      const float th0 = __ldg(th + c0);
      const float thx0 = 0.5f * (th0 + __ldg(th + col[1])), thx1 = 0.5f * (__ldg(th + col[2]) + th0);
      const float thy0 = 0.5f * (th0 + __ldg(th + col[3])), thy1 = 0.5f * (__ldg(th + col[4]) + th0);
      float fu0 = cur.ru0, fu1 = cur.ru1, fv0 = cur.rv0, fv1 = cur.rv1, ijck = 1.f;
      if (TERRAIN) {
        const int oj = k * jstride;
        fu0 *= __ldg(a.jxf + oj + col[0]);
        fu1 *= __ldg(a.jxf + oj + col[2]);
        fv0 *= __ldg(a.jyf + oj + col[0]);
        fv1 *= __ldg(a.jyf + oj + col[4]);
        ijck = __ldg(a.ijc + oj + c0);
      }
      const float div_h = ((fu1 - fu0) * idx + (fv1 - fv0) * idy) * ijck;
      const float div_ht = ((thx1 * fu1 - thx0 * fu0) * idx + (thy1 * fv1 - thy0 * fv0) * idy) * ijck;
      // δ of the new momenta, neither J-weighted nor ×1/J (direct damping)
      const float delta = (thx1 * cur.ru1 - thx0 * cur.ru0) * idx + (thy1 * cur.rv1 - thy0 * cur.rv0) * idy;
      const float thf = __ldg(a.thzf + o + c0);
      const float thf_a = top ? thf : __ldg(a.thzf + o + plane + c0);
      const float rw0 = rd(a.rw_in + o + c0);
      const float rw1 = top ? 0.f : rd(a.rw_in + o + plane + c0);
      const float izc = __ldg(a.invdzc + k);
      // the explicit (1−ω) vertical flux: ρw̃′ = ρw′ − S′ of the previous
      // momenta over terrain, and the ω part of S′ of the new ones
      const float wt0 = rw0 - so, wt1 = top ? 0.f : rw1 - so1;
      const float dzdiv = (wt1 - wt0) * izc;
      const float dzdiv_t = ((top ? 0.f : thf_a * wt1) - thf * wt0) * izc;
      float vert = a.dtau_om1 * dzdiv, vert_t = a.dtau_om1 * dzdiv_t;
      if (TERRAIN) {
        const float dzs = (sn1 - sn) * izc;
        const float dzs_t = ((top ? 0.f : thf_a * sn1) - thf * sn) * izc;
        vert = dtau * ijck * (om1 * dzdiv - om * dzs);
        vert_t = dtau * ijck * (om1 * dzdiv_t - om * dzs_t);
      }
      const float rho_p = ld(a.rho_in + o + c0), rt_p = ld(a.rt_in + o + c0);
      const float rhos = rho_p + dtau * (__ldg(a.grho + o + c0) - div_h) - vert;
      const float rts = rt_p + dtau * (__ldg(a.grt + o + c0) - div_ht) - vert_t;

      // ---- C's right-hand side and lower coupling, ×1/den (row 0 is the
      // bottom face: d′ = 0 on a flat wall, S′ of the new momenta over
      // terrain) --------------------------------------------------------------
      const Level l = {__ldg(a.cl + o + c0), CRHO ? __ldg(a.crho + o + c0) : 0.f, izc, ijck, thf};
      float ct = l.cl * rt_p, cs = l.cl * rts;
      if (CRHO) {
        ct += l.cr * rho_p;
        cs += l.cr * rhos;
      }
      const int s = k * tx + lane;
      if (k == 0) {   // the Dirichlet row
        s_a[s] = 0.f;
        s_b[s] = TERRAIN ? sn : 0.f;
      } else if (k > k0) {
        rhs(k, rw0, rho_p, rhos, ct, cs, rho_b, rhos_b, ct_b, cs_b, lb, s);
      }
      s_c[s] = __ldg(a.cp + o + c0);
      s_rho[s] = rhos;
      s_rt[s] = rts;
      s_thf[s] = thf;
      s_rtp[s] = rt_p;
      if (a.damp == kDirect) a.dd_out[o + c0] = delta;
      if (ahead) own_row(k + 1, nxt);
      rho_b = rho_p; rhos_b = rhos; ct_b = ct; cs_b = cs; lb = l;
      cur = nxt; sn = sn1; so = so1;
    }
  }
  __syncthreads();

  // ---- C: the two substitutions, each split over the groups' runs.  Within
  // a run d′ₖ = βₖ + αₖ·(d′ under the run) going up and xₖ = γₖ + δₖ·(x over
  // the run) going down; one thread per column joins the runs in between,
  // finishing the run's end level and leaving the value under (over) the run
  // in its α (δ) slot there ---------------------------------------------------
  if (mine) {
    if (k0 > 0) {   // the run's first face, from the level under it
      const int s = k0 * tx + lane, sb = s - tx, o = k0 * plane + c0, ob = o - plane;
      const float rho_p = ld(a.rho_in + o), rho_pb = ld(a.rho_in + ob);
      const Level l = level<TERRAIN, CRHO>(a, k0, c0, plane, jstride);
      const Level lb = level<TERRAIN, CRHO>(a, k0 - 1, c0, plane, jstride);
      float ct = l.cl * s_rtp[s], cs = l.cl * s_rt[s];
      float ct_b = lb.cl * s_rtp[sb], cs_b = lb.cl * s_rt[sb];
      if (CRHO) {
        ct += l.cr * rho_p;
        cs += l.cr * s_rho[s];
        ct_b += lb.cr * rho_pb;
        cs_b += lb.cr * s_rho[sb];
      }
      rhs(k0, rd(a.rw_in + o), rho_p, s_rho[s], ct, cs, rho_pb, s_rho[sb], ct_b, cs_b, lb, s);
    }
    float be = 0.f, al = 1.f;   // β, α into s_b, s_a (row 0's lower coupling is 0)
    for (int k = k0; k < k1; ++k) {
      const int s = k * tx + lane;
      const float m = s_a[s];
      be = s_b[s] - m * be;
      al = -m * al;
      s_b[s] = be;
      s_a[s] = al;
    }
  }
  __syncthreads();
  if (threadIdx.y == 0 && i < nx) {
    float dp = 0.f;   // d′ under the first run
    for (int g = 0; g * run < nz; ++g) {
      const int s0 = g * run * tx + lane, s1 = (min((g + 1) * run, nz) - 1) * tx + lane;
      const float d1 = s_b[s1] + s_a[s1] * dp;
      s_b[s0] += s_a[s0] * dp;
      s_a[s0] = dp;
      dp = d1;
    }
  }
  __syncthreads();
  if (mine) {
    const float below = s_a[k0 * tx + lane];
    for (int k = k0 + 1; k < k1; ++k) {
      const int s = k * tx + lane;
      s_b[s] += s_a[s] * below;
    }
    float ga = 0.f, de = 1.f;   // γ, δ into s_b, s_a (row 0's c′ is 0: its Dirichlet value stays)
    for (int k = k1 - 1; k >= k0; --k) {
      const int s = k * tx + lane;
      const float c = s_c[s];
      ga = s_b[s] - c * ga;
      de = -c * de;
      s_b[s] = ga;
      s_a[s] = de;
    }
  }
  __syncthreads();
  if (threadIdx.y == 0 && i < nx) {
    float x = 0.f;   // over the top run: the top face's coupling is dropped
    for (int g = (nz - 1) / run; g >= 0; --g) {
      const int s0 = g * run * tx + lane, s1 = (min((g + 1) * run, nz) - 1) * tx + lane;
      const float x0 = s_b[s0] + s_a[s0] * x;
      s_b[s1] += s_a[s1] * x;
      s_a[s1] = x;
      x = x0;
    }
  }
  __syncthreads();

  // ---- D: recovery (and the thermal damping's input) -----------------------
  if (mine) {
    const float above = s_a[(k1 - 1) * tx + lane];   // ρw′ on the face over the run
    for (int k = k0; k < k1 - 1; ++k) {
      const int s = k * tx + lane;
      s_b[s] += s_a[s] * above;
    }
    for (int k = k0; k < k1; ++k) {
      const int s = k * tx + lane, o = k * plane + c0;
      const bool top = k == nz - 1;
      const float x = s_b[s], x_a = top ? 0.f : k + 1 < k1 ? s_b[s + tx] : above;
      const float thw = s_thf[s] * x, thw_a = top ? 0.f : s_thf[s + tx] * x_a;
      const float izc = __ldg(a.invdzc + k);
      const float ijck = TERRAIN ? __ldg(a.ijc + k * jstride + c0) : 1.f;
      const float rho_new = s_rho[s] - a.om_dtau * ijck * ((x_a - x) * izc);
      const float rt_new = s_rt[s] - a.om_dtau * ijck * ((thw_a - thw) * izc);
      a.srw[o] = a.srw_in[o] + st(a.rw_out + o, x);
      st(a.rho_out + o, rho_new);
      st(a.rt_out + o, rt_new);
      if (a.damp == kThermal) a.dd_out[o] = (rt_new - s_rtp[s]) / __ldg(a.th + o);
    }
  }
}

// The stage's last E: ρu′, ρv′ after A of the last substep damped from its
// damping input, rounded to the storage type, and added to the sums.
template <typename T>
__global__ void __launch_bounds__(256) acoustic_close_kernel(AcArgs<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int nx = a.nx, ny = a.ny;
  const size_t row = (size_t)k * ny;
  const size_t p = (row + j) * nx + i;
  const size_t pxm = (row + j) * nx + (i == 0 ? nx - 1 : i - 1);
  const size_t pym = (row + (j == 0 ? ny - 1 : j - 1)) * nx + i;
  float d0 = 0.f, dxm = 0.f, dym = 0.f, t0 = 0.f, txm = 0.f, tym = 0.f;
  if (a.damp) {
    d0 = __ldg(a.dd_in + p);
    dxm = __ldg(a.dd_in + pxm);
    dym = __ldg(a.dd_in + pym);
  }
  if (a.damp == kDirect) {
    t0 = __ldg(a.th + p);
    txm = __ldg(a.th + pxm);
    tym = __ldg(a.th + pym);
  }
  a.sru[p] = a.sru_in[p] + st(a.ru_out + p, damped(a, __ldg(a.ruw_in + p), d0, dxm, t0, txm, a.fac_x));
  a.srv[p] = a.srv_in[p] + st(a.rv_out + p, damped(a, __ldg(a.rvw_in + p), d0, dym, t0, tym, a.fac_y));
}

template <typename T>
void unpack(AcArgs<T>& a, const void* const* ptrs, const int* ints, const float* floats) {
  int n = 0;
  const T** in_t[] = {&a.ru_in, &a.rv_in, &a.rt_in, &a.rho_in, &a.rw_in};
  for (const T** dst : in_t) *dst = static_cast<const T*>(ptrs[n++]);
  const float** in_f[] = {&a.ruw_in, &a.rvw_in, &a.dd_in, &a.cl, &a.th, &a.thzf, &a.crho,
                          &a.gru, &a.grv, &a.grw, &a.grho, &a.grt, &a.invdzc, &a.invdzf,
                          &a.sru_in, &a.srv_in, &a.srw_in};
  for (const float** dst : in_f) *dst = static_cast<const float*>(ptrs[n++]);
  T** out_t[] = {&a.ru_out, &a.rv_out, &a.rt_out, &a.rho_out, &a.rw_out};
  for (T** dst : out_t) *dst = static_cast<T*>(const_cast<void*>(ptrs[n++]));
  float** out_f[] = {&a.ruw_out, &a.rvw_out, &a.dd_out, &a.cp, &a.inv, &a.sru, &a.srv, &a.srw};
  for (float** dst : out_f) *dst = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  const float** extra[] = {&a.ijc, &a.ijf, &a.jxf, &a.jyf, &a.sxz, &a.syz, &a.sxc, &a.syc,
                           &a.sponge};
  for (const float** dst : extra) *dst = static_cast<const float*>(ptrs[n++]);
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2]; a.damp = ints[3];
  a.terrain = ints[4]; a.has_sponge = ints[5]; a.jz = ints[6];
  a.has_crho = ints[7]; a.bf16 = ints[8]; a.first = ints[9];
  float* f[] = {&a.inv_dx, &a.inv_dy, &a.dtau, &a.omega, &a.pgf, &a.od2,
                &a.half_g_od2, &a.g_dtau, &a.dtau_om1, &a.om_dtau, &a.fac_x, &a.fac_y};
  n = 0;
  for (float* dst : f) *dst = floats[n++];
}

// The branch's instance: terrain, sponge, C_ρ (none over terrain).
template <typename T>
using SubstepKernel = void (*)(AcArgs<T>);

template <typename T>
SubstepKernel<T> substep_kernel(int terrain, int sponge, int crho) {
  switch (terrain * 4 + sponge * 2 + crho) {
    case 0: return acoustic_substep_kernel<T, false, false, false>;
    case 1: return acoustic_substep_kernel<T, false, false, true>;
    case 2: return acoustic_substep_kernel<T, false, true, false>;
    case 3: return acoustic_substep_kernel<T, false, true, true>;
    case 4: return acoustic_substep_kernel<T, true, false, false>;
    case 6: return acoustic_substep_kernel<T, true, true, false>;
    default: return nullptr;   // C_ρ over terrain
  }
}

SubstepKernel<float> pivot_kernel(int terrain, int sponge, int crho) {
  switch (terrain * 4 + sponge * 2 + crho) {
    case 0: return acoustic_pivot_kernel<false, false, false>;
    case 1: return acoustic_pivot_kernel<false, false, true>;
    case 2: return acoustic_pivot_kernel<false, true, false>;
    case 3: return acoustic_pivot_kernel<false, true, true>;
    case 4: return acoustic_pivot_kernel<true, false, false>;
    case 6: return acoustic_pivot_kernel<true, true, false>;
    default: return nullptr;
  }
}

// The substep kernel's shared bytes a block for nz levels.
size_t substep_smem(int nz) { return sizeof(float) * kSlabs * kTile * (size_t)nz; }

// The branch's substep kernel, its dynamic shared memory raised to the
// card's opt-in limit a block once an instance; cudaErrorInvalidValue for
// C_ρ over terrain or when nz levels do not fit under that limit.
template <typename T>
cudaError_t prepared_substep(int terrain, int sponge, int crho, int nz, SubstepKernel<T>* kernel) {
  static int max_smem = 0;
  static bool raised[8] = {};
  *kernel = substep_kernel<T>(terrain, sponge, crho);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  if (max_smem == 0) {
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    max_smem = limit;
  }
  if (substep_smem(nz) > (size_t)max_smem) return cudaErrorInvalidValue;
  const int n = terrain * 4 + sponge * 2 + crho;
  if (!raised[n]) {
    const cudaError_t err = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return err;
    raised[n] = true;
  }
  return cudaSuccess;
}

template <typename T>
int launch_substep(const void* const* ptrs, const int* ints, const float* floats,
                   cudaStream_t s) {
  AcArgs<T> a;
  unpack(a, ptrs, ints, floats);
  // the kernel indexes the fields with 32-bit offsets
  if ((size_t)a.nz * a.ny * a.nx >= (size_t)1 << 31) return static_cast<int>(cudaErrorInvalidValue);
  SubstepKernel<T> kernel = nullptr;
  const cudaError_t err = prepared_substep<T>(a.terrain, a.has_sponge, a.has_crho, a.nz, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.nx + kTile - 1) / kTile, a.ny, 1);
  kernel<<<grid, dim3(kTile, substep_threads(a.terrain) / kTile, 1), substep_smem(a.nz), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ptrs, in the carries' storage type (bfloat16 when ints[8], else float32):
// ru_in, rv_in, rt_in, rho_in, rw_in; in float32: ruw_in, rvw_in, dd_in,
// cl, th, thzf, crho, gru, grv, grw, grho, grt, invdzc, invdzf, sru_in,
// srv_in, srw_in; in the storage type: ru_out, rv_out, rt_out, rho_out,
// rw_out; in float32: ruw_out, rvw_out, dd_out, cp, inv, sru, srv, srw, then
// the terrain's ijc, ijf, jxf, jyf, sxz, syz, sxc, syc and the sponge column
// (null when unused); ints: nz, ny, nx, damp (0 none, 1 thermal, 2 direct),
// terrain, sponge, jz (1: the Jacobians vary with z), crho, bf16, first (a
// stage's first pass); floats in the order of AcArgs from inv_dx (see
// kernels/acoustic.py).  The three entry points take the same arguments.

// The pivots c′ and 1/den of the stage's column solve.
int breeze_acoustic_pivots(const void* const* ptrs, const int* ints, const float* floats,
                           void* stream) {
  AcArgs<float> a;
  unpack(a, ptrs, ints, floats);
  const SubstepKernel<float> kernel = pivot_kernel(a.terrain, a.has_sponge, a.has_crho);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 4, 1);
  const dim3 grid((a.nx + block.x - 1) / block.x, (a.ny + block.y - 1) / block.y, 1);
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One substep: A–D, and the previous substep's E and sums.
int breeze_acoustic_substep(const void* const* ptrs, const int* ints, const float* floats,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ints[8] ? launch_substep<__nv_bfloat16>(ptrs, ints, floats, s)
                 : launch_substep<float>(ptrs, ints, floats, s);
}

// The stage's last E and the sums of ρu′, ρv′.
int breeze_acoustic_close(const void* const* ptrs, const int* ints, const float* floats,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8, 1);
  const dim3 grid((ints[2] + block.x - 1) / block.x, (ints[1] + block.y - 1) / block.y, ints[0]);
  if (ints[8]) {
    AcArgs<__nv_bfloat16> a;
    unpack(a, ptrs, ints, floats);
    acoustic_close_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(a);
  } else {
    AcArgs<float> a;
    unpack(a, ptrs, ints, floats);
    acoustic_close_kernel<float><<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The substep kernel's resources for nz levels, terrain, sponge, C_ρ and
// bfloat16 carries (ints): out = {shared bytes a block, blocks resident
// per SM, registers a thread, local (spill) bytes a thread}.
int breeze_acoustic_info(const int* ints, int* out) {
  const void* kernel = nullptr;
  cudaError_t err;
  if (ints[4]) {
    SubstepKernel<__nv_bfloat16> k = nullptr;
    err = prepared_substep<__nv_bfloat16>(ints[1], ints[2], ints[3], ints[0], &k);
    kernel = reinterpret_cast<const void*>(k);
  } else {
    SubstepKernel<float> k = nullptr;
    err = prepared_substep<float>(ints[1], ints[2], ints[3], ints[0], &k);
    kernel = reinterpret_cast<const void*>(k);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = substep_smem(ints[0]);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      substep_threads(ints[1]), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(smem);
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
