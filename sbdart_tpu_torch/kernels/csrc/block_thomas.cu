// B10: block-Thomas elimination of a block-tridiagonal system whose blocks
// were assembled beforehand (diag, lower, upper [L, m, m, B], rhs
// [L, m, B]): m = 2N for N = 1..8 one thread per column
// (block_thomas_kernel), past m = 16 a group of lanes per column on the
// elimination core (block_thomas_group_kernel, below).
//
// Replaces the TPU kernel sbdart_tpu/pallas/blocktri.py:_kernel (entry
// block_thomas).  The forward sweep solves
//     (diag_l - lower_l W_{l-1}) [W_l | y_l]
//         = [upper_l | r_l - lower_l y_{l-1}]
// by shrinking implicit-pivot elimination (solve_step.cuh: the pivot is
// the first row of maximal |lead| among the rows not yet eliminated) and
// stores the full W_l and y_l; the backward sweep recovers
// x_{L-1} = y_{L-1}, x_l = y_l - W_l x_{l+1}.  The generic solver path
// assembles such blocks in solver/bvp.py:assemble_blocks.
//
// What bounds it on Hopper: the layer recursion is sequential, so one
// thread carries a column through all L layers and the parallelism is the
// column count.  A layer reads 3 m^2 + m floats and writes m^2 + m of
// history (read back once in the backward sweep), against ~m^3 / 3 +
// m^2 (m + 1) flops of elimination and 2 m^3 of the lower-block product;
// at m = 16 that is ~1.1 kB against ~14k flops.  The augmented system
// (m x (2m + 1) floats) and the running [W | y] live in local memory,
// which the L1 cache holds, past m = 8.  History scratch is allocated by
// the wrapper, column-minor ([L, m^2, B], [L, m, B]) so a warp's accesses
// are 32 consecutive floats.  The TPU pads the columns with identity
// blocks and refuses shapes beyond its VMEM; here the kernel bounds-checks
// col < B and takes any L.
//
// Numerics: every sum over a block index runs in order, as in the plain
// torch version (sbdart_tpu_torch/kernels/blocktri.py), term by term;
// built with IEEE division and --fmad=false.

#include <cuda_runtime.h>

#include "group_solve.cuh"
#include "solve_step.cuh"

namespace {

template <int M>
__global__ void block_thomas_kernel(
    const float* __restrict__ diag,    // [L, M, M, B]
    const float* __restrict__ lower,   // [L, M, M, B]
    const float* __restrict__ upper,   // [L, M, M, B]
    const float* __restrict__ rhs,     // [L, M, B]
    float* __restrict__ ws,            // [L, M^2, B] scratch: W history
    float* __restrict__ ys,            // [L, M, B]   scratch: y history
    float* __restrict__ xs,            // [L, M, B]
    int nlyr, int ncol) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const long long B = ncol;
  auto blk = [&](long long l, int i, int j) {
    return ((l * M + i) * M + j) * B + col;
  };

  float wy[M][M + 1];   // [W_{l-1} | y_{l-1}], then the layer's solution
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j <= M; ++j) wy[i][j] = 0.0f;

  for (int l = 0; l < nlyr; ++l) {
    float a[M][2 * M + 1];   // [dt | upper | rt]
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float low[M];
#pragma unroll
      for (int q = 0; q < M; ++q) low[q] = lower[blk(l, i, q)];
#pragma unroll
      for (int j = 0; j < M; ++j) {
        float corr = low[0] * wy[0][j];
#pragma unroll
        for (int q = 1; q < M; ++q) corr = corr + low[q] * wy[q][j];
        a[i][j] = diag[blk(l, i, j)] - corr;
        a[i][M + j] = upper[blk(l, i, j)];
      }
      float corr_r = low[0] * wy[0][M];
#pragma unroll
      for (int q = 1; q < M; ++q) corr_r = corr_r + low[q] * wy[q][M];
      a[i][2 * M] = rhs[((long long)l * M + i) * B + col] - corr_r;
    }

    sbdart_la::solve_step<M, M + 1>(a, wy);
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j)
        ws[((long long)l * M * M + i * M + j) * B + col] = wy[i][j];
      ys[((long long)l * M + i) * B + col] = wy[i][M];
    }
  }

  float x_next[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    x_next[i] = wy[i][M];
    xs[((long long)(nlyr - 1) * M + i) * B + col] = x_next[i];
  }
  for (int l = nlyr - 2; l >= 0; --l) {
    float x_l[M];
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const long long base = (long long)l * M * M + r * M;
      float s = ws[base * B + col] * x_next[0];
#pragma unroll
      for (int j = 1; j < M; ++j) s = s + ws[(base + j) * B + col] * x_next[j];
      x_l[r] = ys[((long long)l * M + r) * B + col] - s;
    }
#pragma unroll
    for (int r = 0; r < M; ++r) {
      x_next[r] = x_l[r];
      xs[((long long)l * M + r) * B + col] = x_l[r];
    }
  }
}

template <int M>
cudaError_t launch(const float* diag, const float* lower, const float* upper,
                   const float* rhs, float* ws, float* ys, float* xs,
                   int nlyr, int ncol, cudaStream_t stream) {
  const int threads = 64;
  const int blocks = (ncol + threads - 1) / threads;
  block_thomas_kernel<M><<<blocks, threads, 0, stream>>>(
      diag, lower, upper, rhs, ws, ys, xs, nlyr, ncol);
  return cudaGetLastError();
}

// Past m = 16, the same solve on the elimination core (group_solve.cuh): a
// group of G = 32 lanes per column holds [dt | upper | rt] (m x (2m + 1),
// a padded row stride) in shared memory, with the carry [W | y] and the
// layer's diag, lower, upper and rhs, which the block copies in together
// (cp.async, whole 32-byte sectors); m is a run-time argument.  Past the
// shared memory of one column (m = 98 on an H100) the far instance keeps
// only the system there and the rest in the column's device scratch
// (group_solve.cuh, "Placement").  Each element is computed by one lane in
// the plain version's order.
struct BtLayout {   // offsets in floats; [W | y] column-major
  int w, aw, mp, a, wy, piv, dg, low, up, rl, near, far;
  __host__ __device__ BtLayout(int m, bool f)
      : w(2 * m + 1), aw(sbdart_group::row_stride(2 * m + 1)),
        mp(sbdart_group::pad4(m)) {
    using sbdart_group::pad4;
    sbdart_group::Segments g;
    a = g.put(false, m * aw);
    wy = g.put(f, (m + 1) * mp);
    piv = g.put(false, mp);
    dg = g.put(f, pad4(m * m));
    low = g.put(f, pad4(m * m));
    up = g.put(f, pad4(m * m));
    rl = g.put(f, mp);
    near = g.near;
    far = g.far;
  }
};

template <bool kFar>
__global__ void __launch_bounds__(256, 3) block_thomas_group_kernel(
    const float* __restrict__ diag,    // [L, m, m, B]
    const float* __restrict__ lower,   // [L, m, m, B]
    const float* __restrict__ upper,   // [L, m, m, B]
    const float* __restrict__ rhs,     // [L, m, B]
    float* __restrict__ ws,            // [L, m^2, B] scratch: W history
    float* __restrict__ ys,            // [L, m, B]   scratch: y history
    float* __restrict__ xs,            // [L, m, B]
    int nlyr, int m, int ncol, int stride,
    float* far, int far_stride) {   // far segments (the far instance)
  extern __shared__ __align__(16) float smem[];
  const BtLayout lay(m, kFar);
  const int w = lay.w, aw = lay.aw, mp = lay.mp;
  const int g = sbdart_group::group_size(m);
  const int lane = threadIdx.x & (g - 1);
  const sbdart_group::Block bk(g, ncol, stride);
  float* base = smem + (threadIdx.x / g) * stride;
  // the far segments of the block's columns, and this column's
  float* fblock = kFar ? far + (long long)blockIdx.x * bk.cols * far_stride
                       : smem;
  const int fstride = kFar ? far_stride : stride;
  float* fbase = fblock + (threadIdx.x / g) * fstride;
  float* a = base + lay.a;
  float* wy = fbase + lay.wy;
  int* piv = reinterpret_cast<int*>(base + lay.piv);
  const float* dg = fbase + lay.dg;
  const float* low = fbase + lay.low;
  const float* up = fbase + lay.up;
  const float* rl = fbase + lay.rl;

  for (int e = lane; e < (m + 1) * mp; e += g) wy[e] = 0.0f;
  for (int l = 0; l < nlyr; ++l) {
    const long long first = (long long)l * m * m;
    bk.stage_into<!kFar>(fblock, fstride, lay.dg, diag, first, m * m);
    bk.stage_into<!kFar>(fblock, fstride, lay.low, lower, first, m * m);
    bk.stage_into<!kFar>(fblock, fstride, lay.up, upper, first, m * m);
    bk.stage_into<!kFar>(fblock, fstride, lay.rl, rhs, (long long)l * m, m);
    sbdart_group::stage_wait();
    sbdart_group::for_each(m, m, lane, g, [&](int i, int c) {
      const float* wc = wy + c * mp;
      float s = low[i * m] * wc[0];
      for (int q = 1; q < m; ++q) s = s + low[i * m + q] * wc[q];
      a[i * aw + c] = dg[i * m + c] - s;
      a[i * aw + m + c] = up[i * m + c];
    });
    for (int i = lane; i < m; i += g) {
      const float* yc = wy + m * mp;
      float s = low[i * m] * yc[0];
      for (int q = 1; q < m; ++q) s = s + low[i * m + q] * yc[q];
      a[i * aw + w - 1] = rl[i] - s;
    }
    __syncwarp();
    sbdart_group::solve(a, aw, w, m, wy, mp, piv, lane, g);
    __syncthreads();
    bk.store_from(ws, first, m, m, fblock, fstride, lay.wy, 1, mp);
    bk.store_from(ys, (long long)l * m, m, 1, fblock, fstride,
                  lay.wy + m * mp, 1);
    __syncthreads();
  }
  sbdart_group::back_sweep(bk, smem, lay.a, m * aw, ws, ys, xs, nlyr, m,
                           lane, g);
}

}  // namespace

// Shared-memory bytes one column of B10's group kernel takes with every
// region there (far = 0), or with the system alone (far = 1).
extern "C" int sbdart_block_thomas_group_bytes(int m, int far) {
  return static_cast<int>(sizeof(float)) *
         sbdart_group::column_stride(BtLayout(m, far != 0).near,
                                     sbdart_group::group_size(m));
}

// Floats of device scratch a launch over ncol columns needs (0 where one
// column fits in shared memory).
extern "C" long long sbdart_block_thomas_group_scratch(int m, int ncol) {
  if (m < 1) return 0;
  return sbdart_group::scratch_floats(sbdart_group::group_size(m),
                                      BtLayout(m, false).near,
                                      BtLayout(m, true).near,
                                      BtLayout(m, true).far, ncol);
}

extern "C" int sbdart_block_thomas_group(const float* diag,
                                         const float* lower,
                                         const float* upper, const float* rhs,
                                         float* ws, float* ys, float* xs,
                                         float* scratch, int nlyr, int m,
                                         int ncol, cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sbdart_group::launch(
      block_thomas_group_kernel<false>, block_thomas_group_kernel<true>,
      sbdart_group::group_size(m), BtLayout(m, false).near, BtLayout(m, true).near, BtLayout(m, true).far,
      scratch, ncol, stream, diag, lower, upper, rhs, ws, ys, xs, nlyr, m,
      ncol));
}

extern "C" int sbdart_block_thomas(const float* diag, const float* lower,
                                   const float* upper, const float* rhs,
                                   float* ws, float* ys, float* xs, int nlyr,
                                   int m, int ncol, cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  cudaError_t err;
  switch (m) {
#define SBDART_BT_CASE(MM)                                                   \
  case MM:                                                                   \
    err = launch<MM>(diag, lower, upper, rhs, ws, ys, xs, nlyr, ncol,        \
                     stream);                                                \
    break;
    SBDART_BT_CASE(2)
    SBDART_BT_CASE(4)
    SBDART_BT_CASE(6)
    SBDART_BT_CASE(8)
    SBDART_BT_CASE(10)
    SBDART_BT_CASE(12)
    SBDART_BT_CASE(14)
    SBDART_BT_CASE(16)
#undef SBDART_BT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
