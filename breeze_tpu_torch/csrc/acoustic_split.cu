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
// ρu′, ρv′ from D = ((ρθ)′new − (ρθ)′)/θᴸ, which needs D at x−1 and y−1.  A
// block owns a BX × BY tile of columns, one thread each, and one halo
// thread for each column on the tile's low x side and low y side; the halo
// threads solve their columns again (the TPU kernel's redundant halo rows,
// 16% more columns at 32 × 8).  The forward sweep keeps c′, d′ in global
// scratch laid out (z, block, thread), so that every level's stores and
// loads coalesce.  The backward sweep runs top down: at each level every
// thread recovers ρ′, (ρθ)′ and D, puts D into shared memory, and after one
// barrier each owned column damps its ρu′, ρv′ at that level.  D of two
// consecutive levels sits in two shared buffers, so one barrier a level
// suffices.  Its five outputs are in the carries' storage type; D uses the
// stored (ρθ)′ carry, widened.
//
// The sums of ρu′, ρv′, ρw′ over a stage's substeps stay outside both
// kernels, as in the TPU driver loop (acoustic.py:1126-1128).
//
// Bound: device memory.  K1 reads 12 fields and writes 4, K2 reads 11 and
// writes 5, against 46 and 61 float32 operations a point.  K2's columns are
// sequential in z, so it is latency-bound at first: 65,536 columns of 128
// levels give the card one thread per column and little else to hide a
// load behind.  Neither kernel keeps anything on chip across substeps; the
// port's K3 counterpart (acoustic.cu) cuts after D instead of after B.

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

// K2's tile: BX × BY owned columns, then BY halo columns at x−1 and BX at y−1.
constexpr int BX = 32, BY = 8, K2_THREADS = BX * BY + BY + BX;

template <typename T>
struct K2Args {
  const float *rhos, *rts, *ru_new, *rv_new;   // K1's outputs
  const T *rw, *rho, *rt;                      // carries of the previous substep
  const float *grw, *cl, *th, *thzf;
  const float *invdzc, *invdzf;                // (nz,)
  T *ru_out, *rv_out, *rw_out, *rho_out, *rt_out;
  float *cp, *dp;                              // sweep scratch (nz, blocks, K2_THREADS)
  int nz, ny, nx, damp;
  float dtau, omega, od2, half_g_od2, g_dtau, om_dtau, fac_x, fac_y;
};

template <typename T>
__global__ void __launch_bounds__(K2_THREADS) acoustic_k2_kernel(K2Args<T> a) {
  __shared__ float d_lvl[2][BY + 1][BX + 1];   // D of a level; row/column 0 the halo
  const int t = threadIdx.x;
  // (tx, ty): the thread's place in the (BY+1) × (BX+1) tile
  int tx, ty;
  if (t < BX * BY) {
    tx = t % BX + 1;
    ty = t / BX + 1;
  } else if (t < BX * BY + BY) {
    tx = 0;
    ty = t - BX * BY + 1;
  } else {
    tx = t - BX * BY - BY + 1;
    ty = 0;
  }
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const bool owned = tx > 0 && ty > 0;
  // a halo column is solved when the owned column beside it is in the domain
  const bool active = x0 + max(tx, 1) - 1 < nx && y0 + max(ty, 1) - 1 < ny;
  int i = x0 + tx - 1, j = y0 + ty - 1;
  if (i < 0) i += nx;
  if (j < 0) j += ny;
  const size_t plane = (size_t)ny * nx;
  const size_t c0 = (size_t)j * nx + i;
  const size_t blocks = (size_t)gridDim.x * gridDim.y;
  const size_t s0 = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * K2_THREADS + t;
  const size_t s_stride = blocks * K2_THREADS;
  const float dtau = a.dtau, om = a.omega, om1 = 1.0f - a.omega;

  // ---- C: forward sweep (row 0 the wall: c′ = d′ = 0) ---------------------
  if (active) {
    float rho_b = 0.f, rhos_b = 0.f, ct_b = 0.f, cs_b = 0.f, cl_b = 0.f;
    float izc_b = 0.f, thf_b = 0.f, cp_b = 0.f, dp_b = 0.f;
    for (int k = 0; k < nz; ++k) {
      const size_t o = (size_t)k * plane + c0;
      const float rhos = __ldg(a.rhos + o), rts = __ldg(a.rts + o);
      const float rho_p = ld(a.rho + o), rt_p = ld(a.rt + o);
      const float clk = __ldg(a.cl + o), thf = __ldg(a.thzf + o);
      const float izc = __ldg(a.invdzc + k);
      const float ct = clk * rt_p, cs = clk * rts;
      float cp = 0.f, dp = 0.f;
      if (k > 0) {
        const float izf = __ldg(a.invdzf + k);
        const float thf_a = k < nz - 1 ? __ldg(a.thzf + o + plane) : thf;
        const float lo = a.half_g_od2 * izc_b - a.od2 * izf * cl_b * thf_b * izc_b;
        const float di = 1.0f - a.half_g_od2 * (izc_b - izc)
                         + a.od2 * izf * thf * (clk * izc + cl_b * izc_b);
        const float up = -a.half_g_od2 * izc - a.od2 * izf * clk * thf_a * izc;
        const float d = ld(a.rw + o) + dtau * __ldg(a.grw + o)
                        - a.g_dtau * (om1 * (0.5f * (rho_p + rho_b)) + om * (0.5f * (rhos + rhos_b)))
                        - dtau * (om1 * ((ct - ct_b) * izf) + om * ((cs - cs_b) * izf));
        const float den = di - lo * cp_b;
        cp = up / den;
        dp = (d - lo * dp_b) / den;
      }
      a.cp[s0 + k * s_stride] = cp;
      a.dp[s0 + k * s_stride] = dp;
      rho_b = rho_p; rhos_b = rhos; ct_b = ct; cs_b = cs; cl_b = clk;
      izc_b = izc; thf_b = thf; cp_b = cp; dp_b = dp;
    }
  }

  // ---- C: backward sweep, D: recovery, E: damping, level by level --------
  float x_a = 0.f, thw_a = 0.f;   // ρw′ and θᴸρw′ on the face above (top: 0)
  for (int k = nz - 1; k >= 0; --k) {
    const size_t o = (size_t)k * plane + c0;
    float dd = 0.f;
    if (active) {
      float x = a.dp[s0 + k * s_stride];
      if (k < nz - 1) x = x - a.cp[s0 + k * s_stride] * x_a;
      const float thw = __ldg(a.thzf + o) * x;
      const float izc = __ldg(a.invdzc + k);
      const float rho_new = __ldg(a.rhos + o) - a.om_dtau * (x_a - x) * izc;
      const float rt_new = __ldg(a.rts + o) - a.om_dtau * (thw_a - thw) * izc;
      if (owned) {
        st(a.rw_out + o, x);
        st(a.rho_out + o, rho_new);
        st(a.rt_out + o, rt_new);
      }
      if (a.damp) dd = (rt_new - ld(a.rt + o)) / __ldg(a.th + o);
      x_a = x;
      thw_a = thw;
    }
    if (a.damp) {   // uniform across the block: every thread reaches the barrier
      float(*lvl)[BX + 1] = d_lvl[k & 1];
      lvl[ty][tx] = dd;
      __syncthreads();
      if (owned && active) {
        st(a.ru_out + o, __ldg(a.ru_new + o) - a.fac_x * (dd - lvl[ty][tx - 1]));
        st(a.rv_out + o, __ldg(a.rv_new + o) - a.fac_y * (dd - lvl[ty - 1][tx]));
      }
    } else if (owned && active) {
      st(a.ru_out + o, __ldg(a.ru_new + o));
      st(a.rv_out + o, __ldg(a.rv_new + o));
    }
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

template <typename T>
int launch_k2(const void* const* ptrs, const int* ints, const float* floats, cudaStream_t s) {
  K2Args<T> a;
  int n = 0;
  const float** k1[] = {&a.rhos, &a.rts, &a.ru_new, &a.rv_new};
  for (const float** dst : k1) *dst = static_cast<const float*>(ptrs[n++]);
  const T** carries[] = {&a.rw, &a.rho, &a.rt};
  for (const T** dst : carries) *dst = static_cast<const T*>(ptrs[n++]);
  const float** in[] = {&a.grw, &a.cl, &a.th, &a.thzf, &a.invdzc, &a.invdzf};
  for (const float** dst : in) *dst = static_cast<const float*>(ptrs[n++]);
  T** out[] = {&a.ru_out, &a.rv_out, &a.rw_out, &a.rho_out, &a.rt_out};
  for (T** dst : out) *dst = static_cast<T*>(const_cast<void*>(ptrs[n++]));
  a.cp = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  a.dp = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2]; a.damp = ints[4];
  float* f[] = {&a.dtau, &a.omega, &a.od2, &a.half_g_od2, &a.g_dtau, &a.om_dtau,
                &a.fac_x, &a.fac_y};
  n = 0;
  for (float* dst : f) *dst = floats[n++];
  const dim3 grid((a.nx + BX - 1) / BX, (a.ny + BY - 1) / BY, 1);
  acoustic_k2_kernel<T><<<grid, K2_THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
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

// K2.  ptrs, in float32: rhos, rts, ru_new, rv_new (K1's outputs); in the
// storage type: rw, rho, rt; in float32: grw, cl, th, thzf, invdzc (nz,),
// invdzf (nz,); in the storage type the outputs ru, rv, rw, rho, rt; the
// float32 scratch cp, dp of nz × blocks × K2_THREADS each (blocks =
// ⌈nx/32⌉·⌈ny/8⌉, K2_THREADS = 296); ints: nz, ny, nx, bf16, damping
// (0 none, 1 thermal); floats: Δτ, ω, ω²Δτ², ½gω²Δτ², gΔτ, ωΔτ, αΔx/Δτ,
// αΔy/Δτ.
int breeze_acoustic_k2(const void* const* ptrs, const int* ints, const float* floats,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ints[3] ? launch_k2<__nv_bfloat16>(ptrs, ints, floats, s)
                 : launch_k2<float>(ptrs, ints, floats, s);
}

}  // extern "C"
