// Acoustic substeps of the split-explicit compressible core for sm_90a.
//
// Replaces breeze_tpu/pallas_kernels/acoustic.py::_run_k3 (body _make_k3,
// driver acoustic_substep_loop_pallas) on its flat, potential-temperature
// branch with float32 carries and thermal or no divergence damping.  The
// Python wrapper and the plain PyTorch version (the jnp substep loop of
// dynamics/compressible.py) are in breeze_tpu_torch/kernels/acoustic.py.
//
// One substep advances the perturbations (ρ′, ρu′, ρv′, ρw′, (ρθ)′) about
// the stage-entry state:
//   A. forward ρu′, ρv′ under the slow tendencies and the perturbation
//      pressure gradient p′ = Cᴸ(ρθ)′ (gated off on a stage's first
//      substep by pgf = 0);
//   B. the predictors ρ′★, (ρθ)′★ from the new horizontal divergences;
//   C. the off-centred Crank-Nicolson column solve for ρw′ (ρw′ = 0 on the
//      bottom face, the top face's coupling dropped);
//   D. the recovery of ρ′ and (ρθ)′;
//   E. Klemp's thermal divergence damping of ρu′, ρv′ from
//      D = δτ(ρθ)′/θᴸ, and the sums of ρu′, ρv′, ρw′ over the substeps.
//
// Two kernels per substep.  acoustic_column_kernel runs one thread per
// (y, x) column up and down z: A, B and the forward Thomas sweep on the way
// up, the backward sweep and D on the way down.  B's divergence needs the
// new ρu′ at x+1 and ρv′ at y+1; each is pointwise in the previous
// substep's fields, so the thread recomputes it rather than waiting for its
// neighbour.  The sweep's c′ and d′ go to scratch in device memory laid out
// (z, y, x), so that every level's loads and stores coalesce across x.
// acoustic_damp_kernel, one thread per point, then does E, which reads D at
// x−1 and y−1 of the recovered (ρθ)′.
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
// Bound: device memory.  A stage reads its 13 input fields and writes 8
// outputs; each substep here moves about 20 fields through device memory,
// against ~150 float32 operations per point.  Keeping the carries on chip
// across substeps, as the TPU kernel did in VMEM, is later work.

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
  int nz, ny, nx, damp;
  float inv_dx, inv_dy, dtau, omega, pgf;
  float od2, half_g_od2, g_dtau, dtau_om1, om_dtau, fac_x, fac_y;
};

__global__ void __launch_bounds__(128) acoustic_column_kernel(AcArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= a.nx || j >= a.ny) return;
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const size_t plane = (size_t)ny * nx;
  const int im = i == 0 ? nx - 1 : i - 1, ip = i == nx - 1 ? 0 : i + 1;
  const int jm = j == 0 ? ny - 1 : j - 1, jp = j == ny - 1 ? 0 : j + 1;
  const size_t c0 = (size_t)j * nx + i;
  const size_t cxm = (size_t)j * nx + im, cxp = (size_t)j * nx + ip;
  const size_t cym = (size_t)jm * nx + i, cyp = (size_t)jp * nx + i;
  const float dtau = a.dtau, om = a.omega, om1 = 1.0f - a.omega, pgf = a.pgf;
  const float idx = a.inv_dx, idy = a.inv_dy;

  // values of the level below, carried up the column
  float rho_b = 0.f, rhos_b = 0.f, ct_b = 0.f, cs_b = 0.f, cl_b = 0.f;
  float izc_b = 0.f, thf_b = 0.f, cp_b = 0.f, dp_b = 0.f;
  for (int k = 0; k < nz; ++k) {
    const size_t o = (size_t)k * plane;
    const float* cl = a.cl + o;
    const float* rt = a.rt_in + o;
    const float* th = a.th + o;
    // ---- A: ρu′ at faces i, i+1 and ρv′ at faces j, j+1 --------------------
    const float pp = __ldg(cl + c0) * __ldg(rt + c0);
    const float pp_xm = __ldg(cl + cxm) * __ldg(rt + cxm);
    const float pp_xp = __ldg(cl + cxp) * __ldg(rt + cxp);
    const float pp_ym = __ldg(cl + cym) * __ldg(rt + cym);
    const float pp_yp = __ldg(cl + cyp) * __ldg(rt + cyp);
    const float ru0 = __ldg(a.ru_in + o + c0) + dtau * (__ldg(a.gru + o + c0) - pgf * ((pp - pp_xm) * idx));
    const float ru1 = __ldg(a.ru_in + o + cxp) + dtau * (__ldg(a.gru + o + cxp) - pgf * ((pp_xp - pp) * idx));
    const float rv0 = __ldg(a.rv_in + o + c0) + dtau * (__ldg(a.grv + o + c0) - pgf * ((pp - pp_ym) * idy));
    const float rv1 = __ldg(a.rv_in + o + cyp) + dtau * (__ldg(a.grv + o + cyp) - pgf * ((pp_yp - pp) * idy));
    a.ru_out[o + c0] = ru0;
    a.rv_out[o + c0] = rv0;

    // ---- B: predictors -------------------------------------------------
    const float th0 = __ldg(th + c0);
    const float thx0 = 0.5f * (th0 + __ldg(th + cxm)), thx1 = 0.5f * (__ldg(th + cxp) + th0);
    const float thy0 = 0.5f * (th0 + __ldg(th + cym)), thy1 = 0.5f * (__ldg(th + cyp) + th0);
    const float div_h = (ru1 - ru0) * idx + (rv1 - rv0) * idy;
    const float div_ht = (thx1 * ru1 - thx0 * ru0) * idx + (thy1 * rv1 - thy0 * rv0) * idy;
    const bool top = k == nz - 1;
    const float thf = __ldg(a.thzf + o + c0);
    const float thf_a = top ? thf : __ldg(a.thzf + o + plane + c0);
    const float rw0 = a.rw_in[o + c0];
    const float rw1 = top ? 0.f : a.rw_in[o + plane + c0];
    const float izc = __ldg(a.invdzc + k);
    const float dzdiv = (rw1 - rw0) * izc;
    const float dzdiv_t = ((top ? 0.f : thf_a * rw1) - thf * rw0) * izc;
    const float rho_p = a.rho_in[o + c0], rt_p = __ldg(rt + c0);
    const float rhos = rho_p + dtau * (__ldg(a.grho + o + c0) - div_h) - a.dtau_om1 * dzdiv;
    const float rts = rt_p + dtau * (__ldg(a.grt + o + c0) - div_ht) - a.dtau_om1 * dzdiv_t;
    a.rho[o + c0] = rhos;
    a.rt_out[o + c0] = rts;

    // ---- C: forward sweep (row 0 is the wall: c′ = d′ = 0) ---------------
    const float clk = __ldg(cl + c0);
    const float ct = clk * rt_p, cs = clk * rts;
    float cp = 0.f, dp = 0.f;
    if (k > 0) {
      const float izf = __ldg(a.invdzf + k);
      const float dzC = om1 * ((ct - ct_b) * izf) + om * ((cs - cs_b) * izf);
      const float d = rw0 + dtau * __ldg(a.grw + o + c0)
                      - a.g_dtau * (om1 * (0.5f * (rho_p + rho_b)) + om * (0.5f * (rhos + rhos_b)))
                      - dtau * dzC;
      const float lo = a.half_g_od2 * izc_b - a.od2 * izf * cl_b * thf_b * izc_b;
      const float di = 1.0f - a.half_g_od2 * (izc_b - izc)
                       + a.od2 * izf * thf * (clk * izc + cl_b * izc_b);
      const float up = -a.half_g_od2 * izc - a.od2 * izf * clk * thf_a * izc;
      const float den = di - lo * cp_b;
      cp = up / den;
      dp = (d - lo * dp_b) / den;
    }
    a.cp[o + c0] = cp;
    a.dp[o + c0] = dp;
    rho_b = rho_p; rhos_b = rhos; ct_b = ct; cs_b = cs; cl_b = clk;
    izc_b = izc; thf_b = thf; cp_b = cp; dp_b = dp;
  }

  // ---- C: backward sweep, D: recovery (and the damping proxy) ------------
  float x_a = 0.f, thw_a = 0.f;   // ρw′ and θᴸρw′ on the face above (top: 0)
  for (int k = nz - 1; k >= 0; --k) {
    const size_t o = (size_t)k * plane + c0;
    float x = a.dp[o];
    if (k < nz - 1) x = x - a.cp[o] * x_a;
    if (k == 0) x = 0.f;
    a.rw[o] = x;
    const float thw = __ldg(a.thzf + o) * x;
    const float izc = __ldg(a.invdzc + k);
    const float rho_new = a.rho[o] - a.om_dtau * ((x_a - x) * izc);
    const float rt_new = a.rt_out[o] - a.om_dtau * ((thw_a - thw) * izc);
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
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2]; a.damp = ints[3];
  float* f[] = {&a.inv_dx, &a.inv_dy, &a.dtau, &a.omega, &a.pgf, &a.od2,
                &a.half_g_od2, &a.g_dtau, &a.dtau_om1, &a.om_dtau, &a.fac_x, &a.fac_y};
  n = 0;
  for (float* dst : f) *dst = floats[n++];
}

}  // namespace

extern "C" {

// ptrs: ru_in, rv_in, rt_in, cl, th, thzf, gru, grv, grw, grho, grt, invdzc,
// invdzf, rho_in, rw_in, sru_in, srv_in, srw_in, then ru_out, rv_out, rt_out,
// rho, rw, cp, dp, dd, sru, srv, srw;
// ints: nz, ny, nx, damp; floats in the order of AcArgs from inv_dx (see
// kernels/acoustic.py).
int breeze_acoustic_column(const void* const* ptrs, const int* ints,
                           const float* floats, void* stream) {
  AcArgs a;
  unpack(a, ptrs, ints, floats);
  const dim3 block(32, 4, 1);
  const dim3 grid((a.nx + block.x - 1) / block.x, (a.ny + block.y - 1) / block.y, 1);
  acoustic_column_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
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
