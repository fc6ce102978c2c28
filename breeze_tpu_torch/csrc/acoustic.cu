// Acoustic substeps of the split-explicit compressible core for sm_90a.
//
// Replaces breeze_tpu/pallas_kernels/acoustic.py::_run_k3 (body _make_k3,
// entry point acoustic_substep_loop_pallas) on its potential-temperature
// branches with float32 carries: flat or σ-terrain (LinearDecay or SLEVE),
// thermal or no divergence damping, with or without the upper Rayleigh
// sponge.  The Python wrapper and the plain PyTorch version (the jnp
// substep loop of dynamics/compressible.py) are in
// breeze_tpu_torch/kernels/acoustic.py.
//
// One substep advances the perturbations (ρ′, ρu′, ρv′, ρw′, (ρθ)′) about
// the stage-entry state:
//   A. forward ρu′, ρv′ under the slow tendencies and the perturbation
//      pressure gradient p′ = Cᴸ(ρθ)′ (gated off on a stage's first
//      substep by pgf = 0); over terrain slope-corrected,
//      ∂x p′ − sx·½(∂z p′ at the two centers beside the face), with
//      ∂z p′ = (1/J)∂ζ p′ moved from ζ-faces to ζ-centers;
//   B. the predictors ρ′★, (ρθ)′★ from the new horizontal divergences;
//      over terrain the fluxes are J-weighted and the divergences ×1/J, and
//      the vertical flux is the contravariant ρw̃′ = ρw′ − S′, with
//      S′ = sx·ℑxz(ρu′) + sy·ℑyz(ρv′) at ζ-faces;
//   C. the off-centred Crank-Nicolson column solve for ρw′ (the top face's
//      coupling dropped; the bottom face ρw′ = 0 when flat, ρw′ = S′ of the
//      new momenta over terrain, the kinematic bottom); 1/J factors on its
//      couplings over terrain; the sponge ωΔτ·r on its diagonal and
//      (1−ω)Δτ·r·ρw′ on its right-hand side (r = rate × ramp at the face);
//   D. the recovery of ρ′ and (ρθ)′ (×1/J over terrain);
//   E. Klemp's thermal divergence damping of ρu′, ρv′ from
//      D = δτ(ρθ)′/θᴸ, and the sums of ρu′, ρv′, ρw′ over the substeps.
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
// and the previous row's momenta in registers.  The terrain and sponge
// branches are template flags; the flat, sponge-free instance does the
// work of the flat kernel alone.  The four Jacobian factors are read with a
// z-stride of 0 when they are ζ-independent (LinearDecay), so one code path
// serves both formulations.  The sweep's c′ and d′ go to scratch in device
// memory laid out (z, y, x), so that every level's loads and stores
// coalesce across x.  acoustic_damp_kernel, one thread per point, then does
// E, which reads D at x−1 and y−1 of the recovered (ρθ)′.
//
// Buffers: ρu′, ρv′ and (ρθ)′ are read at neighbouring columns, so the
// previous substep's values stay in their own buffers (ping-pong in the
// wrapper); ρ′ and ρw′ are read only in their own column, and the sums only
// at their own point.  Those five have an input and an output pointer: on a
// stage's first substep the inputs are the caller's tensors, which are never
// written, and after it each input is its output, updated in place (ρ′ holds
// the predictor between the sweeps, the (ρθ)′ output buffer the (ρθ)′
// predictor).  The inputs that may alias outputs are read with plain loads.
//
// Bound: device memory.  A stage reads its 13 input fields (and over
// terrain the 8 metric fields) and writes 8 outputs; each substep here
// moves about 20 fields through device memory (28 over terrain), against
// ~110 float32 operations per point (~190 over terrain).  Keeping the
// carries on chip across substeps, as the TPU kernel did in VMEM, is later
// work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

struct AcArgs {
  const float *ru_in, *rv_in, *rt_in;     // previous substep (read only)
  float *ru_out, *rv_out, *rt_out;        // this substep
  const float *rho_in, *rw_in;            // previous substep (may alias rho, rw)
  float *rho, *rw;                        // this substep
  const float *cl, *th, *thzf;            // Cᴸ, θᴸ, θᴸ at z-faces
  const float *gru, *grv, *grw, *grho, *grt;
  const float *invdzc, *invdzf;           // (nz,)
  float *cp, *dp, *dd;                    // sweep scratch, damping proxy D
  const float *sru_in, *srv_in, *srw_in;  // sums so far (may alias sru, ...)
  float *sru, *srv, *srw;                 // running sums
  // terrain: 1/J at ζ-centers and ζ-faces, J at x- and y-faces (z-extent 1
  // or nz), the slopes at (ζ-face, x/y-center) and (ζ-center, x/y-face)
  const float *ijc, *ijf, *jxf, *jyf, *sxz, *syz, *sxc, *syc;
  const float* sponge;                    // (nz,) rate × ramp at z-faces
  int nz, ny, nx, damp, terrain, has_sponge, jz;
  float inv_dx, inv_dy, dtau, omega, pgf;
  float od2, half_g_od2, g_dtau, dtau_om1, om_dtau, fac_x, fac_y;
};

// The new (and previous) ρu′ at faces i, i+1 and ρv′ at faces j, j+1 of one
// row of a column.
struct Row {
  float ru0, ru1, rv0, rv1;   // new
  float ou0, ou1, ov0, ov1;   // previous substep
};

template <bool TERRAIN, bool SPONGE>
__global__ void __launch_bounds__(128) acoustic_column_kernel(AcArgs a) {
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

  // ---- A, one row at a time, bottom up ------------------------------------
  // pp: p′ of row m in the five columns; dzf: (1/J)∂ζ p′ on face m (terrain)
  float pp[5], dzf[5];
#pragma unroll
  for (int n = 0; n < 5; ++n) {
    pp[n] = __ldg(a.cl + col[n]) * __ldg(a.rt_in + col[n]);
    dzf[n] = 0.f;   // face 0: p′ is mirrored below the wall
  }
  auto row_a = [&](int m) {
    const size_t o = (size_t)m * plane;
    const bool last = m == nz - 1;
    float pn[5];
    float sl_x0 = 0.f, sl_x1 = 0.f, sl_y0 = 0.f, sl_y1 = 0.f;
#pragma unroll
    for (int n = 0; n < 5; ++n)
      pn[n] = last ? 0.f : __ldg(a.cl + o + plane + col[n]) * __ldg(a.rt_in + o + plane + col[n]);
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
    r.ou0 = __ldg(a.ru_in + o + col[0]);
    r.ou1 = __ldg(a.ru_in + o + col[2]);
    r.ov0 = __ldg(a.rv_in + o + col[0]);
    r.ov1 = __ldg(a.rv_in + o + col[4]);
    r.ru0 = r.ou0 + dtau * (__ldg(a.gru + o + col[0]) - pgf * ((pp[0] - pp[1]) * idx - sl_x0));
    r.ru1 = r.ou1 + dtau * (__ldg(a.gru + o + col[2]) - pgf * ((pp[2] - pp[0]) * idx - sl_x1));
    r.rv0 = r.ov0 + dtau * (__ldg(a.grv + o + col[0]) - pgf * ((pp[0] - pp[3]) * idy - sl_y0));
    r.rv1 = r.ov1 + dtau * (__ldg(a.grv + o + col[4]) - pgf * ((pp[4] - pp[0]) * idy - sl_y1));
    a.ru_out[o + c0] = r.ru0;
    a.rv_out[o + c0] = r.rv0;
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
  float rho_b = 0.f, rhos_b = 0.f, ct_b = 0.f, cs_b = 0.f, cl_b = 0.f;
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
    const float thf = __ldg(a.thzf + o + c0);
    const float thf_a = top ? thf : __ldg(a.thzf + o + plane + c0);
    const float rw0 = a.rw_in[o + c0];
    const float rw1 = top ? 0.f : a.rw_in[o + plane + c0];
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
    const float rho_p = a.rho_in[o + c0], rt_p = __ldg(a.rt_in + o + c0);
    const float rhos = rho_p + dtau * (__ldg(a.grho + o + c0) - div_h) - vert;
    const float rts = rt_p + dtau * (__ldg(a.grt + o + c0) - div_ht) - vert_t;
    a.rho[o + c0] = rhos;
    a.rt_out[o + c0] = rts;

    // ---- C: forward sweep (row 0 is the bottom face: c′ = 0, d′ = 0 on a
    // flat wall, S′ of the new momenta over terrain) ----------------------
    const float clk = __ldg(a.cl + o + c0);
    const float ct = clk * rt_p, cs = clk * rts;
    float cp = 0.f, dp = TERRAIN ? sn : 0.f;
    if (k > 0) {
      const float izf = __ldg(a.invdzf + k);
      const float ijfk = TERRAIN ? __ldg(a.ijf + (size_t)k * jstride + c0) : 1.f;
      const float dzC = (om1 * ((ct - ct_b) * izf) + om * ((cs - cs_b) * izf)) * ijfk;
      float d = rw0 + dtau * __ldg(a.grw + o + c0)
                - a.g_dtau * (om1 * (0.5f * (rho_p + rho_b)) + om * (0.5f * (rhos + rhos_b)))
                - dtau * dzC;
      const float lo = a.half_g_od2 * izc_b * ijc_b
                       - a.od2 * izf * cl_b * thf_b * izc_b * ijfk * ijc_b;
      float di = 1.0f - a.half_g_od2 * (izc_b * ijc_b - izc * ijck)
                 + a.od2 * izf * thf * (clk * izc * ijck + cl_b * izc_b * ijc_b) * ijfk;
      const float up = -a.half_g_od2 * izc * ijck - a.od2 * izf * clk * thf_a * izc * ijfk * ijck;
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
    rho_b = rho_p; rhos_b = rhos; ct_b = ct; cs_b = cs; cl_b = clk;
    izc_b = izc; thf_b = thf; cp_b = cp; dp_b = dp; ijc_b = ijck;
    cur = nxt; sn = sn1; so = so1;
  }

  // ---- C: backward sweep, D: recovery (and the damping proxy) ------------
  float x_a = 0.f, thw_a = 0.f;   // ρw′ and θᴸρw′ on the face above (top: 0)
  for (int k = nz - 1; k >= 0; --k) {
    const size_t o = (size_t)k * plane + c0;
    float x = a.dp[o];
    if (k < nz - 1) x = x - a.cp[o] * x_a;
    if (!TERRAIN && k == 0) x = 0.f;   // the flat wall; over terrain d′ = S′
    a.rw[o] = x;
    const float thw = __ldg(a.thzf + o) * x;
    const float izc = __ldg(a.invdzc + k);
    const float ijck = TERRAIN ? __ldg(a.ijc + (size_t)k * jstride + c0) : 1.f;
    const float rho_new = a.rho[o] - a.om_dtau * ijck * ((x_a - x) * izc);
    const float rt_new = a.rt_out[o] - a.om_dtau * ijck * ((thw_a - thw) * izc);
    a.rho[o] = rho_new;
    a.rt_out[o] = rt_new;
    if (a.damp) a.dd[o] = (rt_new - __ldg(a.rt_in + o)) / __ldg(a.th + o);
    x_a = x;
    thw_a = thw;
  }
}

__global__ void __launch_bounds__(256) acoustic_damp_kernel(AcArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int nx = a.nx, ny = a.ny;
  const size_t row = (size_t)k * ny;
  const size_t p = (row + j) * nx + i;
  float ru = a.ru_out[p], rv = a.rv_out[p];
  if (a.damp) {
    const float d0 = a.dd[p];
    ru = ru - a.fac_x * (d0 - a.dd[(row + j) * nx + (i == 0 ? nx - 1 : i - 1)]);
    rv = rv - a.fac_y * (d0 - a.dd[(row + (j == 0 ? ny - 1 : j - 1)) * nx + i]);
    a.ru_out[p] = ru;
    a.rv_out[p] = rv;
  }
  a.sru[p] = a.sru_in[p] + ru;
  a.srv[p] = a.srv_in[p] + rv;
  a.srw[p] = a.srw_in[p] + a.rw[p];
}

void unpack(AcArgs& a, const void* const* ptrs, const int* ints, const float* floats) {
  const float** in[] = {&a.ru_in, &a.rv_in, &a.rt_in, &a.cl, &a.th, &a.thzf,
                        &a.gru, &a.grv, &a.grw, &a.grho, &a.grt, &a.invdzc, &a.invdzf,
                        &a.rho_in, &a.rw_in, &a.sru_in, &a.srv_in, &a.srw_in};
  int n = 0;
  for (const float** dst : in) *dst = static_cast<const float*>(ptrs[n++]);
  float** out[] = {&a.ru_out, &a.rv_out, &a.rt_out, &a.rho, &a.rw,
                   &a.cp, &a.dp, &a.dd, &a.sru, &a.srv, &a.srw};
  for (float** dst : out) *dst = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  const float** extra[] = {&a.ijc, &a.ijf, &a.jxf, &a.jyf, &a.sxz, &a.syz, &a.sxc, &a.syc,
                           &a.sponge};
  for (const float** dst : extra) *dst = static_cast<const float*>(ptrs[n++]);
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2]; a.damp = ints[3];
  a.terrain = ints[4]; a.has_sponge = ints[5]; a.jz = ints[6];
  float* f[] = {&a.inv_dx, &a.inv_dy, &a.dtau, &a.omega, &a.pgf, &a.od2,
                &a.half_g_od2, &a.g_dtau, &a.dtau_om1, &a.om_dtau, &a.fac_x, &a.fac_y};
  n = 0;
  for (float* dst : f) *dst = floats[n++];
}

}  // namespace

extern "C" {

// ptrs: ru_in, rv_in, rt_in, cl, th, thzf, gru, grv, grw, grho, grt, invdzc,
// invdzf, rho_in, rw_in, sru_in, srv_in, srw_in, then ru_out, rv_out, rt_out,
// rho, rw, cp, dp, dd, sru, srv, srw, then the terrain's ijc, ijf, jxf, jyf,
// sxz, syz, sxc, syc and the sponge column (null when unused);
// ints: nz, ny, nx, damp, terrain, sponge, jz (1: the Jacobians vary with
// z); floats in the order of AcArgs from inv_dx (see kernels/acoustic.py).
int breeze_acoustic_column(const void* const* ptrs, const int* ints,
                           const float* floats, void* stream) {
  AcArgs a;
  unpack(a, ptrs, ints, floats);
  const dim3 block(32, 4, 1);
  const dim3 grid((a.nx + block.x - 1) / block.x, (a.ny + block.y - 1) / block.y, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.terrain && a.has_sponge)
    acoustic_column_kernel<true, true><<<grid, block, 0, s>>>(a);
  else if (a.terrain)
    acoustic_column_kernel<true, false><<<grid, block, 0, s>>>(a);
  else if (a.has_sponge)
    acoustic_column_kernel<false, true><<<grid, block, 0, s>>>(a);
  else
    acoustic_column_kernel<false, false><<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The same arguments as breeze_acoustic_column.
int breeze_acoustic_damp(const void* const* ptrs, const int* ints,
                         const float* floats, void* stream) {
  AcArgs a;
  unpack(a, ptrs, ints, floats);
  const dim3 block(32, 8, 1);
  const dim3 grid((a.nx + block.x - 1) / block.x, (a.ny + block.y - 1) / block.y, a.nz);
  acoustic_damp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
