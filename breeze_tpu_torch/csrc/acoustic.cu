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
// Two kernels per substep.  acoustic_column_kernel runs one thread per
// (y, x) column up and down z: A, B and the forward Thomas sweep on the way
// up, the backward sweep and D on the way down.  B's divergence needs the
// new ρu′ at x+1 and ρv′ at y+1; each is pointwise in the previous
// substep's fields, so the thread recomputes it rather than waiting for its
// neighbour.  A is computed one row ahead of B (B at center k needs S′ on
// face k+1, which needs the new momenta of row k+1), and over terrain A's
// slope term needs p′ one row further up: the march carries p′ and
// (1/J)∂ζ p′ of the five columns it reads (its own and the four beside it)
// and the previous row's momenta in registers.  In ρe, p′ reads ρ′ and C_ρ
// in those five columns too.  The terrain, sponge and C_ρ branches and the
// carries' storage type are template parameters; the flat, float32
// instance does the work of the flat kernel alone.  The four Jacobian
// factors are read with a z-stride of 0 when they are ζ-independent
// (LinearDecay), so one code path serves both formulations.  The sweep's
// c′ and d′ go to scratch in device memory laid out (z, y, x), so that
// every level's loads and stores coalesce across x.  acoustic_damp_kernel,
// one thread per point, then does E, which reads D or δ at x−1 and y−1.
// The direct form's δ needs the new momenta at faces i, i+1 and j, j+1,
// exactly what B holds and what C and D leave unchanged, so the column
// kernel writes δ where the thermal form's D would go; forming δ in the
// damp kernel from its neighbours' ρu′ while it writes its own would race.
//
// Buffers: ρu′, ρv′, (ρχ)′ and ρ′ are read at neighbouring columns, so the
// previous substep's values stay in their own buffers (ping-pong in the
// wrapper); ρw′ is read only in its own column, and the sums only at their
// own point.  Those have an input and an output pointer: on a stage's first
// substep the inputs are the caller's tensors, which are never written, and
// after it each input is its output, updated in place.  The inputs that may
// alias outputs are read with plain loads.  ρu′, ρv′ after A (E's input)
// and the predictors ρ′★, (ρχ)′★ (D's input) are float32 work buffers: with
// float32 carries the wrapper passes the carries' output buffers, with
// bfloat16 carries buffers of their own, so that the arithmetic sees the
// unrounded values and each carry is rounded once per substep, as the TPU
// kernel does.  The sums add the rounded carries.
//
// Bound: device memory.  A stage reads its 13 input fields (14 in ρe, and
// over terrain the 8 metric fields) and writes 8 outputs; each substep here
// moves about 20 fields through device memory (28 over terrain), against
// ~110 float32 operations per point (~190 over terrain).  Keeping the
// carries on chip across substeps, as the TPU kernel did in VMEM, is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "carry.cuh"

namespace {

template <typename T>
struct AcArgs {
  const T *ru_in, *rv_in, *rt_in, *rho_in;  // previous substep (read only)
  const T* rw_in;                           // previous substep (may alias rw)
  const float *cl, *th, *thzf;              // Cᴸ, χᴸ, χᴸ at z-faces
  const float* crho;                        // C_ρ (ρe; null otherwise)
  const float *gru, *grv, *grw, *grho, *grt;
  const float *invdzc, *invdzf;             // (nz,)
  const float *sru_in, *srv_in, *srw_in;    // sums so far (may alias sru, ...)
  T *ru_out, *rv_out, *rt_out, *rho_out;    // this substep
  T* rw;
  float *ruw, *rvw;                         // ρu′, ρv′ after A (may alias ru_out, rv_out)
  float *rhos, *rts;                        // ρ′★, (ρχ)′★ (may alias rho_out, rt_out)
  float *cp, *dp, *dd;                      // sweep scratch, damping input D or δ
  float *sru, *srv, *srw;                   // running sums
  // terrain: 1/J at ζ-centers and ζ-faces, J at x- and y-faces (z-extent 1
  // or nz), the slopes at (ζ-face, x/y-center) and (ζ-center, x/y-face)
  const float *ijc, *ijf, *jxf, *jyf, *sxz, *syz, *sxc, *syc;
  const float* sponge;                      // (nz,) rate × ramp at z-faces
  int nz, ny, nx, damp, terrain, has_sponge, jz, has_crho, bf16;
  float inv_dx, inv_dy, dtau, omega, pgf;
  float od2, half_g_od2, g_dtau, dtau_om1, om_dtau, fac_x, fac_y;
};

// damp: the damping's form
constexpr int kThermal = 1, kDirect = 2;

// The new (and previous) ρu′ at faces i, i+1 and ρv′ at faces j, j+1 of one
// row of a column.
struct Row {
  float ru0, ru1, rv0, rv1;   // new
  float ou0, ou1, ov0, ov1;   // previous substep
};

template <typename T, bool TERRAIN, bool SPONGE, bool CRHO>
__global__ void __launch_bounds__(128) acoustic_column_kernel(AcArgs<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= a.nx || j >= a.ny) return;
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const size_t plane = (size_t)ny * nx;
  const size_t jstride = a.jz ? plane : 0;   // the Jacobians' z-stride
  const int im = i == 0 ? nx - 1 : i - 1, ip = i == nx - 1 ? 0 : i + 1;
  const int jm = j == 0 ? ny - 1 : j - 1, jp = j == ny - 1 ? 0 : j + 1;
  const size_t c0 = (size_t)j * nx + i;
  // the five columns A reads: 0 own, 1 x−1, 2 x+1, 3 y−1, 4 y+1
  const size_t col[5] = {c0, (size_t)j * nx + im, (size_t)j * nx + ip,
                         (size_t)jm * nx + i, (size_t)jp * nx + i};
  const float dtau = a.dtau, om = a.omega, om1 = 1.0f - a.omega, pgf = a.pgf;
  const float idx = a.inv_dx, idy = a.inv_dy;
  // p′ = Cᴸ(ρχ)′ (+ C_ρρ′) of the previous substep at point p
  auto pressure = [&](size_t p) {
    float v = __ldg(a.cl + p) * ld(a.rt_in + p);
    if (CRHO) v += __ldg(a.crho + p) * ld(a.rho_in + p);
    return v;
  };

  // ---- A, one row at a time, bottom up ------------------------------------
  // pp: p′ of row m in the five columns; dzf: (1/J)∂ζ p′ on face m (terrain)
  float pp[5], dzf[5];
#pragma unroll
  for (int n = 0; n < 5; ++n) {
    pp[n] = pressure(col[n]);
    dzf[n] = 0.f;   // face 0: p′ is mirrored below the wall
  }
  auto row_a = [&](int m) {
    const size_t o = (size_t)m * plane;
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
    r.ou0 = ld(a.ru_in + o + col[0]);
    r.ou1 = ld(a.ru_in + o + col[2]);
    r.ov0 = ld(a.rv_in + o + col[0]);
    r.ov1 = ld(a.rv_in + o + col[4]);
    r.ru0 = r.ou0 + dtau * (__ldg(a.gru + o + col[0]) - pgf * ((pp[0] - pp[1]) * idx - sl_x0));
    r.ru1 = r.ou1 + dtau * (__ldg(a.gru + o + col[2]) - pgf * ((pp[2] - pp[0]) * idx - sl_x1));
    r.rv0 = r.ov0 + dtau * (__ldg(a.grv + o + col[0]) - pgf * ((pp[0] - pp[3]) * idy - sl_y0));
    r.rv1 = r.ov1 + dtau * (__ldg(a.grv + o + col[4]) - pgf * ((pp[4] - pp[0]) * idy - sl_y1));
    a.ruw[o + c0] = r.ru0;
    a.rvw[o + c0] = r.rv0;
#pragma unroll
    for (int n = 0; n < 5; ++n) pp[n] = pn[n];
    return r;
  };
  // S′ on face m from the momenta of rows m and m−1
  auto slope_part = [&](int m, float u0, float u1, float ub0, float ub1,
                        float v0, float v1, float vb0, float vb1) {
    const size_t o = (size_t)m * plane + c0;
    return __ldg(a.sxz + o) * (0.25f * (u0 + u1 + ub0 + ub1))
           + __ldg(a.syz + o) * (0.25f * (v0 + v1 + vb0 + vb1));
  };

  Row cur = row_a(0);
  float sn = 0.f, so = 0.f;   // S′ of the new and the previous momenta on face k
  if (TERRAIN) {              // face 0: row −1 is row 0
    sn = slope_part(0, cur.ru0, cur.ru1, cur.ru0, cur.ru1, cur.rv0, cur.rv1, cur.rv0, cur.rv1);
    so = slope_part(0, cur.ou0, cur.ou1, cur.ou0, cur.ou1, cur.ov0, cur.ov1, cur.ov0, cur.ov1);
  }

  // values of the level below, carried up the column
  float rho_b = 0.f, rhos_b = 0.f, ct_b = 0.f, cs_b = 0.f, cl_b = 0.f, cr_b = 0.f;
  float izc_b = 0.f, thf_b = 0.f, cp_b = 0.f, dp_b = 0.f, ijc_b = 1.f;
  for (int k = 0; k < nz; ++k) {
    const size_t o = (size_t)k * plane;
    const float* th = a.th + o;
    const bool top = k == nz - 1;
    // A one row ahead, and S′ on face k+1 (zero on the top wall face)
    Row nxt = cur;
    float sn1 = 0.f, so1 = 0.f;
    if (!top) {
      nxt = row_a(k + 1);
      if (TERRAIN) {
        sn1 = slope_part(k + 1, nxt.ru0, nxt.ru1, cur.ru0, cur.ru1,
                         nxt.rv0, nxt.rv1, cur.rv0, cur.rv1);
        so1 = slope_part(k + 1, nxt.ou0, nxt.ou1, cur.ou0, cur.ou1,
                         nxt.ov0, nxt.ov1, cur.ov0, cur.ov1);
      }
    }

    // ---- B: predictors -------------------------------------------------
    const float th0 = __ldg(th + c0);
    const float thx0 = 0.5f * (th0 + __ldg(th + col[1])), thx1 = 0.5f * (__ldg(th + col[2]) + th0);
    const float thy0 = 0.5f * (th0 + __ldg(th + col[3])), thy1 = 0.5f * (__ldg(th + col[4]) + th0);
    float fu0 = cur.ru0, fu1 = cur.ru1, fv0 = cur.rv0, fv1 = cur.rv1, ijck = 1.f;
    if (TERRAIN) {
      const size_t oj = (size_t)k * jstride;
      fu0 *= __ldg(a.jxf + oj + col[0]);
      fu1 *= __ldg(a.jxf + oj + col[2]);
      fv0 *= __ldg(a.jyf + oj + col[0]);
      fv1 *= __ldg(a.jyf + oj + col[4]);
      ijck = __ldg(a.ijc + oj + c0);
    }
    const float div_h = ((fu1 - fu0) * idx + (fv1 - fv0) * idy) * ijck;
    const float div_ht = ((thx1 * fu1 - thx0 * fu0) * idx + (thy1 * fv1 - thy0 * fv0) * idy) * ijck;
    if (a.damp == kDirect)   // δ of the new momenta, neither J-weighted nor ×1/J
      a.dd[o + c0] = (thx1 * cur.ru1 - thx0 * cur.ru0) * idx + (thy1 * cur.rv1 - thy0 * cur.rv0) * idy;
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
    a.rhos[o + c0] = rhos;
    a.rts[o + c0] = rts;

    // ---- C: forward sweep (row 0 is the bottom face: c′ = 0, d′ = 0 on a
    // flat wall, S′ of the new momenta over terrain) ----------------------
    const float clk = __ldg(a.cl + o + c0);
    float ct = clk * rt_p, cs = clk * rts, crk = 0.f;
    if (CRHO) {
      crk = __ldg(a.crho + o + c0);
      ct += crk * rho_p;
      cs += crk * rhos;
    }
    float cp = 0.f, dp = TERRAIN ? sn : 0.f;
    if (k > 0) {
      const float izf = __ldg(a.invdzf + k);
      const float ijfk = TERRAIN ? __ldg(a.ijf + (size_t)k * jstride + c0) : 1.f;
      const float dzC = (om1 * ((ct - ct_b) * izf) + om * ((cs - cs_b) * izf)) * ijfk;
      float d = rw0 + dtau * __ldg(a.grw + o + c0)
                - a.g_dtau * (om1 * (0.5f * (rho_p + rho_b)) + om * (0.5f * (rhos + rhos_b)))
                - dtau * dzC;
      float lo = a.half_g_od2 * izc_b * ijc_b
                 - a.od2 * izf * cl_b * thf_b * izc_b * ijfk * ijc_b;
      float di = 1.0f - a.half_g_od2 * (izc_b * ijc_b - izc * ijck)
                 + a.od2 * izf * thf * (clk * izc * ijck + cl_b * izc_b * ijc_b) * ijfk;
      float up = -a.half_g_od2 * izc * ijck - a.od2 * izf * clk * thf_a * izc * ijfk * ijck;
      if (CRHO) {   // the C_ρ couplings, unit face weight
        lo -= a.od2 * izf * cr_b * izc_b * ijfk * ijc_b;
        di += a.od2 * izf * (crk * izc * ijck + cr_b * izc_b * ijc_b) * ijfk;
        up -= a.od2 * izf * crk * izc * ijfk * ijck;
      }
      if (SPONGE) {
        const float r = __ldg(a.sponge + k);
        di += a.om_dtau * r;
        d -= a.dtau_om1 * r * rw0;
      }
      const float den = di - lo * cp_b;
      cp = up / den;
      dp = (d - lo * dp_b) / den;
    }
    a.cp[o + c0] = cp;
    a.dp[o + c0] = dp;
    rho_b = rho_p; rhos_b = rhos; ct_b = ct; cs_b = cs; cl_b = clk; cr_b = crk;
    izc_b = izc; thf_b = thf; cp_b = cp; dp_b = dp; ijc_b = ijck;
    cur = nxt; sn = sn1; so = so1;
  }

  // ---- C: backward sweep, D: recovery (and the thermal damping's D) -------
  float x_a = 0.f, thw_a = 0.f;   // ρw′ and χᴸρw′ on the face above (top: 0)
  for (int k = nz - 1; k >= 0; --k) {
    const size_t o = (size_t)k * plane + c0;
    float x = a.dp[o];
    if (k < nz - 1) x = x - a.cp[o] * x_a;
    if (!TERRAIN && k == 0) x = 0.f;   // the flat wall; over terrain d′ = S′
    st(a.rw + o, x);
    const float thw = __ldg(a.thzf + o) * x;
    const float izc = __ldg(a.invdzc + k);
    const float ijck = TERRAIN ? __ldg(a.ijc + (size_t)k * jstride + c0) : 1.f;
    const float rho_new = a.rhos[o] - a.om_dtau * ijck * ((x_a - x) * izc);
    const float rt_new = a.rts[o] - a.om_dtau * ijck * ((thw_a - thw) * izc);
    st(a.rho_out + o, rho_new);
    st(a.rt_out + o, rt_new);
    if (a.damp == kThermal) a.dd[o] = (rt_new - ld(a.rt_in + o)) / __ldg(a.th + o);
    x_a = x;
    thw_a = thw;
  }
}

template <typename T>
__global__ void __launch_bounds__(256) acoustic_damp_kernel(AcArgs<T> a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int nx = a.nx, ny = a.ny;
  const size_t row = (size_t)k * ny;
  const size_t p = (row + j) * nx + i;
  float ru = a.ruw[p], rv = a.rvw[p];
  if (a.damp) {
    const size_t pxm = (row + j) * nx + (i == 0 ? nx - 1 : i - 1);
    const size_t pym = (row + (j == 0 ? ny - 1 : j - 1)) * nx + i;
    const float d0 = a.dd[p];
    const float gx = a.fac_x * (d0 - a.dd[pxm]), gy = a.fac_y * (d0 - a.dd[pym]);
    if (a.damp == kDirect) {   // +αΔx ∂xδ/θᴸₓ
      const float t0 = __ldg(a.th + p);
      ru += gx / (0.5f * (t0 + __ldg(a.th + pxm)));
      rv += gy / (0.5f * (t0 + __ldg(a.th + pym)));
    } else {                   // −αΔx/Δτ ∂x D
      ru -= gx;
      rv -= gy;
    }
  }
  a.sru[p] = a.sru_in[p] + st(a.ru_out + p, ru);
  a.srv[p] = a.srv_in[p] + st(a.rv_out + p, rv);
  a.srw[p] = a.srw_in[p] + rd(a.rw + p);
}

template <typename T>
void unpack(AcArgs<T>& a, const void* const* ptrs, const int* ints, const float* floats) {
  int n = 0;
  const T** in_t[] = {&a.ru_in, &a.rv_in, &a.rt_in, &a.rho_in, &a.rw_in};
  for (const T** dst : in_t) *dst = static_cast<const T*>(ptrs[n++]);
  const float** in_f[] = {&a.cl, &a.th, &a.thzf, &a.crho, &a.gru, &a.grv, &a.grw, &a.grho,
                          &a.grt, &a.invdzc, &a.invdzf, &a.sru_in, &a.srv_in, &a.srw_in};
  for (const float** dst : in_f) *dst = static_cast<const float*>(ptrs[n++]);
  T** out_t[] = {&a.ru_out, &a.rv_out, &a.rt_out, &a.rho_out, &a.rw};
  for (T** dst : out_t) *dst = static_cast<T*>(const_cast<void*>(ptrs[n++]));
  float** out_f[] = {&a.ruw, &a.rvw, &a.rhos, &a.rts, &a.cp, &a.dp, &a.dd,
                     &a.sru, &a.srv, &a.srw};
  for (float** dst : out_f) *dst = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  const float** extra[] = {&a.ijc, &a.ijf, &a.jxf, &a.jyf, &a.sxz, &a.syz, &a.sxc, &a.syc,
                           &a.sponge};
  for (const float** dst : extra) *dst = static_cast<const float*>(ptrs[n++]);
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2]; a.damp = ints[3];
  a.terrain = ints[4]; a.has_sponge = ints[5]; a.jz = ints[6];
  a.has_crho = ints[7]; a.bf16 = ints[8];
  float* f[] = {&a.inv_dx, &a.inv_dy, &a.dtau, &a.omega, &a.pgf, &a.od2,
                &a.half_g_od2, &a.g_dtau, &a.dtau_om1, &a.om_dtau, &a.fac_x, &a.fac_y};
  n = 0;
  for (float* dst : f) *dst = floats[n++];
}

template <typename T>
int launch_column(const void* const* ptrs, const int* ints, const float* floats,
                  cudaStream_t s) {
  AcArgs<T> a;
  unpack(a, ptrs, ints, floats);
  const dim3 block(32, 4, 1);
  const dim3 grid((a.nx + block.x - 1) / block.x, (a.ny + block.y - 1) / block.y, 1);
  switch (a.terrain * 4 + a.has_sponge * 2 + a.has_crho) {
    case 0: acoustic_column_kernel<T, false, false, false><<<grid, block, 0, s>>>(a); break;
    case 1: acoustic_column_kernel<T, false, false, true><<<grid, block, 0, s>>>(a); break;
    case 2: acoustic_column_kernel<T, false, true, false><<<grid, block, 0, s>>>(a); break;
    case 3: acoustic_column_kernel<T, false, true, true><<<grid, block, 0, s>>>(a); break;
    case 4: acoustic_column_kernel<T, true, false, false><<<grid, block, 0, s>>>(a); break;
    case 6: acoustic_column_kernel<T, true, true, false><<<grid, block, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);   // C_ρ over terrain
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_damp(const void* const* ptrs, const int* ints, const float* floats,
                cudaStream_t s) {
  AcArgs<T> a;
  unpack(a, ptrs, ints, floats);
  const dim3 block(32, 8, 1);
  const dim3 grid((a.nx + block.x - 1) / block.x, (a.ny + block.y - 1) / block.y, a.nz);
  acoustic_damp_kernel<T><<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ptrs, in the carries' storage type (bfloat16 when ints[8], else float32):
// ru_in, rv_in, rt_in, rho_in, rw_in; in float32: cl, th, thzf, crho, gru,
// grv, grw, grho, grt, invdzc, invdzf, sru_in, srv_in, srw_in; in the
// storage type: ru_out, rv_out, rt_out, rho_out, rw; in float32: ruw, rvw,
// rhos, rts, cp, dp, dd, sru, srv, srw, then the terrain's ijc, ijf, jxf,
// jyf, sxz, syz, sxc, syc and the sponge column (null when unused);
// ints: nz, ny, nx, damp (0 none, 1 thermal, 2 direct), terrain, sponge, jz
// (1: the Jacobians vary with z), crho, bf16; floats in the order of AcArgs
// from inv_dx (see kernels/acoustic.py).
int breeze_acoustic_column(const void* const* ptrs, const int* ints,
                           const float* floats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ints[8] ? launch_column<__nv_bfloat16>(ptrs, ints, floats, s)
                 : launch_column<float>(ptrs, ints, floats, s);
}

// The same arguments as breeze_acoustic_column.
int breeze_acoustic_damp(const void* const* ptrs, const int* ints,
                         const float* floats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ints[8] ? launch_damp<__nv_bfloat16>(ptrs, ints, floats, s)
                 : launch_damp<float>(ptrs, ints, floats, s);
}

}  // extern "C"
