// WENO5 momentum flux divergences ∇·(ρU⊗u) for sm_90a: two kernels.
//
// momentum_div_kernel replaces breeze_tpu/pallas_kernels/momentum.py::
// momentum_div_pallas (the pl.pallas_call in _run, body momentum_divs);
// momentum_div_cols_kernel replaces momentum_div_pallas_cols (the
// pl.pallas_call in _run_cols).  The Python wrappers and the plain PyTorch
// versions are in breeze_tpu_torch/kernels/momentum.py.
//
// Inputs: the velocities u, v, w as windows padded by HALO in z and y, and
// 1/Δz at centers and faces (nz,); then either the momenta ρu, ρv, ρw as
// windows of the same shape, or (the column kernel) the padded reference
// density columns at centers and faces (nz + 2·HALO,), from which the
// anelastic momenta ρᵣ(z)·u are formed.  The face column is mirrored about
// the wall faces, so that it times the odd-reflected w pad gives the
// odd-reflected ρw pad.  Outputs du, dv, dw (nz, ny, nx), the divergences
// (not their negatives).  Row 0 of dw reads below-wall pad data, which the
// wall condition overwrites.
//
// momentum_div_kernel: one thread per output point, x fastest, the
// arithmetic momentum_divs in weno.cuh.  Six padded windows read and three
// fields written (~316 MB at 256×256×128) take ~0.094 ms at 3.35 TB/s; the
// ~675 float32 operations a point that nine interface reconstructions need
// take ~0.085 ms at 67 TFLOP/s, but it computes each interface twice (once
// for each cell beside it), so arithmetic is what limits it.
//
// momentum_div_cols_kernel: the fused tendency kernel's z-marching tile
// (momentum_tile.cuh) on the three velocity windows.  Its bound at 256³ is
// arithmetic: ~678 operations a point, 0.170 ms, against 0.120 ms for the
// three windows read once and the three outputs written.  A block of 512
// threads owns a 32 × 16 tile of columns and marches up a chunk of levels
// (the wrapper's z chunk); u, v, w sit in a 7-plane ring in shared memory,
// the plane of level k+4 copied in by cp.async while level k computes.  Each
// x and y face flux of a level is computed once into shared memory and each
// z face flux carried in a register, with ρᵣ multiplied in as each face's
// mass flux is formed: 9 reconstructions a point, where the one-thread-a-
// point form did 18 and multiplied every stencil value by ρᵣ.  Three fields
// and no scalars or ν take 83,088 bytes of shared memory a block (the ring
// 70,224, the face fluxes 12,864), so two blocks, 32 warps, fit an SM under
// 64 registers a thread.  The chunk's six planes below and above its levels
// are read again from L2 by the chunks beside it, and the tile's 3-point
// halo by the tiles beside it.

#include "momentum_tile.cuh"

namespace {

struct MomArgs {
  const float *ru, *rv, *rw, *u, *v, *w, *invdzc, *invdzf;
  float *du, *dv, *dw;
  int nz, ny, nx;
  float inv_dx, inv_dy;
};

__global__ void __launch_bounds__(256) momentum_div_kernel(MomArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= a.nx || j >= a.ny) return;
  const int nyp = a.ny + 2 * HALO;
  const Win U{a.u, nyp, a.nx}, V{a.v, nyp, a.nx}, W{a.w, nyp, a.nx};
  const Win RU{a.ru, nyp, a.nx}, RV{a.rv, nyp, a.nx}, RW{a.rw, nyp, a.nx};
  float du, dv, dw;
  momentum_divs(RU, RV, RW, U, V, W, k, j, i, a.inv_dx, a.inv_dy,
                __ldg(a.invdzc + k), __ldg(a.invdzf + k), du, dv, dw);
  const size_t p = ((size_t)k * a.ny + j) * a.nx + i;
  a.du[p] = du;
  a.dv[p] = dv;
  a.dw[p] = dw;
}

struct ColsArgs {
  const float *u, *v, *w, *colc, *colf, *invdzc, *invdzf;
  float *du, *dv, *dw;
  int nz, ny, nx, zchunk;
  float inv_dx, inv_dy;
};

// The column kernel's ring holds u, v, w; the warps of the tile's extra
// faces (three in y, three in x) are rows of the tile.
constexpr int COLS_FIELDS = 3;
static_assert(TX == 32 && TY >= 2 * COLS_FIELDS, "the extra faces take a warp each");
constexpr size_t COLS_SMEM = sizeof(float) * COLS_FIELDS * (NSLOT * PLANE + XF + YF);

__global__ void __launch_bounds__(NT, 2) momentum_div_cols_kernel(ColsArgs a) {
  extern __shared__ float sm[];
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int ti = threadIdx.x, tj = threadIdx.y;
  const int i0 = blockIdx.x * TX, j0 = blockIdx.y * TY;
  const int k0 = blockIdx.z * a.zchunk, k1 = min(k0 + a.zchunk, nz);
  const int nxt = min(TX, nx - i0), nyt = min(TY, ny - j0);
  const int i = i0 + ti, j = j0 + tj;
  const bool valid = ti < nxt && tj < nyt;
  const Tile t{sm, i0, j0};
  float* FX = sm + COLS_FIELDS * NSLOT * PLANE;   // u, v, w × TY × (TX+1)
  float* FY = FX + COLS_FIELDS * XF;              // u, v, w × (TY+1) × TX
  const Col colc{a.colc}, colf{a.colf};
  const float idx = a.inv_dx, idy = a.inv_dy;
  const auto field = [&](int f) { return f == 0 ? a.u : f == 1 ? a.v : a.w; };
  const auto load = [&](int kk) {
    load_level<COLS_FIELDS>(sm, field, COLS_FIELDS, kk, i0, j0, nxt, nyt, ny, nx);
  };

  // ---- the chunk's first planes and the z-flux carries ---------------------
  for (int kk = k0 - 3; kk <= k0 + 3; ++kk) load(kk);
  cp_async_wait_all();
  __syncthreads();
  int sk = k0 % NSLOT;
  float cu = 0.0f, cv = 0.0f, cw = 0.0f;   // u, v on face k, w at center k-1
  if (valid) {
    const Ring U = t.ring(0, k0, sk, j, i), V = t.ring(1, k0, sk, j, i),
               W = t.ring(2, k0, sk, j, i);
    cu = flux_zu(U, W, k0, j, i, colf(k0));
    cv = flux_zv(V, W, k0, j, i, colf(k0));
    cw = flux_zw(W, k0 - 1, j, i, colf(k0 - 1), colf(k0));
  }
  __syncthreads();   // slot k0-3 is free for level k0+4

  for (int k = k0; k < k1; ++k) {
    if (k + 4 <= k1 + 2) load(k + 4);
    const float ck = colc(k), ckm = colc(k - 1);

    // ---- x and y face fluxes, each once: the thread's own ... --------------
    float fzu = 0.0f, fzv = 0.0f, fzw = 0.0f;
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
    }
    // ... and the extra face each row and column needs: warp f < 3 takes
    // field f's y-face past the tile's last row (v: the y-center before its
    // first), for every column; warp 3+f field f's x-face past its last
    // column (u: the x-center before its first), for every row
    if (tj < COLS_FIELDS) {
      if (ti < nxt) {
        const int ii = i0 + ti, f = tj, y = f == 1 ? j0 - 1 : j0 + nyt;
        const Ring U = t.ring(0, k, sk, y, ii), V = t.ring(1, k, sk, y, ii);
        float fl;
        if (f == 0) fl = flux_yu(U, V, k, y, ii, ck);
        else if (f == 1) fl = flux_yv(V, k, y, ii, ck);
        else fl = flux_yw(V, t.ring(2, k, sk, y, ii), k, y, ii, ck, ckm);
        FY[f * YF + (f == 1 ? 0 : nyt) * TX + ti] = fl;
      }
    } else if (tj < 2 * COLS_FIELDS && ti < nyt) {
      const int f = tj - COLS_FIELDS, jj = j0 + ti, x = f == 0 ? i0 - 1 : i0 + nxt;
      const Ring U = t.ring(0, k, sk, jj, x);
      float fl;
      if (f == 0) fl = flux_xu(U, k, jj, x, ck);
      else if (f == 1) fl = flux_xv(U, t.ring(1, k, sk, jj, x), k, jj, x, ck);
      else fl = flux_xw(U, t.ring(2, k, sk, jj, x), k, jj, x, ck, ckm);
      FX[f * XF + ti * (TX + 1) + (f == 0 ? 0 : nxt)] = fl;
    }
    __syncthreads();

    if (valid) {
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
      const size_t p = ((size_t)k * ny + j) * nx + i;
      a.du[p] = du;
      a.dv[p] = dv;
      a.dw[p] = dw;
      cu = fzu;
      cv = fzv;
      cw = fzw;
    }
    cp_async_wait_all();
    __syncthreads();
    sk = sk == NSLOT - 1 ? 0 : sk + 1;
  }
}

// The column kernel's shared memory raised past 48 KB once.
cudaError_t prepare_cols() {
  static bool raised = false;
  if (raised) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      momentum_div_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(COLS_SMEM));
  raised = err == cudaSuccess;
  return err;
}

}  // namespace

extern "C" {

// ptrs: ru, rv, rw, u, v, w, invdzc, invdzf, du, dv, dw; ints: nz, ny, nx;
// floats: inv_dx, inv_dy (see kernels/momentum.py).
int breeze_momentum_div(const void* const* ptrs, const int* ints,
                        const float* floats, void* stream) {
  MomArgs a;
  const float** in[] = {&a.ru, &a.rv, &a.rw, &a.u, &a.v, &a.w, &a.invdzc, &a.invdzf};
  int n = 0;
  for (const float** dst : in) *dst = static_cast<const float*>(ptrs[n++]);
  float** out[] = {&a.du, &a.dv, &a.dw};
  for (float** dst : out) *dst = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2];
  a.inv_dx = floats[0]; a.inv_dy = floats[1];
  const dim3 block(32, 8, 1);
  const dim3 grid((a.nx + block.x - 1) / block.x, (a.ny + block.y - 1) / block.y, a.nz);
  momentum_div_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: u, v, w, colc, colf, invdzc, invdzf, du, dv, dw; ints: nz, ny, nx,
// the z chunk; floats: inv_dx, inv_dy (see kernels/momentum.py).
int breeze_momentum_div_cols(const void* const* ptrs, const int* ints,
                             const float* floats, void* stream) {
  ColsArgs a;
  const float** in[] = {&a.u, &a.v, &a.w, &a.colc, &a.colf, &a.invdzc, &a.invdzf};
  int n = 0;
  for (const float** dst : in) *dst = static_cast<const float*>(ptrs[n++]);
  float** out[] = {&a.du, &a.dv, &a.dw};
  for (float** dst : out) *dst = static_cast<float*>(const_cast<void*>(ptrs[n++]));
  a.nz = ints[0]; a.ny = ints[1]; a.nx = ints[2]; a.zchunk = ints[3];
  a.inv_dx = floats[0]; a.inv_dy = floats[1];
  const cudaError_t err = prepare_cols();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.nx + TX - 1) / TX, (a.ny + TY - 1) / TY, (a.nz + a.zchunk - 1) / a.zchunk);
  momentum_div_cols_kernel<<<grid, dim3(TX, TY, 1), COLS_SMEM,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The column kernel's resources: out = {shared bytes a block, blocks
// resident per SM, registers a thread, local (spill) bytes a thread}.
int breeze_momentum_div_cols_info(int* out) {
  cudaError_t err = prepare_cols();
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, momentum_div_cols_kernel, NT,
                                                      COLS_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, momentum_div_cols_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(COLS_SMEM);
  out[1] = blocks;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
