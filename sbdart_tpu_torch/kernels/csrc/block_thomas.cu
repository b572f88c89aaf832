// B10: block-Thomas elimination of a block-tridiagonal system whose blocks
// were assembled beforehand (diag, lower, upper [L, m, m, B], rhs
// [L, m, B]): a group of lanes per column (the kernels below on the group
// core, group_solve.cuh), except at the m of blocktri.BT_ONE_THREAD_M
// (m = 4), where one thread per column is faster (block_thomas_kernel).
//
// Replaces the TPU kernel sbdart_tpu/pallas/blocktri.py:_kernel (entry
// block_thomas).  The forward sweep solves
//     (diag_l - lower_l W_{l-1}) [W_l | y_l]
//         = [upper_l | r_l - lower_l y_{l-1}]
// by shrinking implicit-pivot elimination (the pivot is the first row of
// maximal |lead| among the rows not yet eliminated) and stores the full
// W_l and y_l; the backward sweep recovers x_{L-1} = y_{L-1},
// x_l = y_l - W_l x_{l+1}.  The generic solver path assembles such blocks
// in solver/bvp.py:assemble_blocks.
//
// What bounds it on Hopper: a layer reads 3 m^2 + m floats and writes
// m^2 + m of history (read back once in the backward sweep), against
// ~2 m^3 / 3 + 2 m^2 (m + 1) flops of elimination and 2 m^2 (m + 1) of
// the lower-block product, so the bytes bound it (0.40 ms at m = 8,
// 33 x 49152 columns; 0.59 ms at m = 20, 65 x 6144); the layer recursion
// is sequential per column, and the time is the instructions of each
// layer's elimination.  One thread per column holds the system and the
// carry in local memory, and only the column count gives parallelism
// (49,152 threads are ~11 warps an SM); the group kernels spread a column
// over a group of G = group_size(m) lanes: its rows in registers at even
// m <= 8 (block_thomas_rows_kernel), its system in shared memory past
// that (block_thomas_group_kernel).  History scratch is allocated by the
// wrapper, column-minor ([L, m^2, B], [L, m, B]).  The TPU pads the
// columns with identity blocks and refuses shapes beyond its VMEM; here
// the kernels bounds-check col < B and take any L.
//
// Numerics: every sum over a block index runs in order, as in the plain
// torch version (sbdart_tpu_torch/kernels/blocktri.py), term by term, each
// element computed by one lane; built with IEEE division and --fmad=false,
// so every kernel equals the plain version to the bit.

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

// The smem instance: the system [dt | upper | rt] (m x (2m + 1), rows
// aw = row_stride(2m + 1) floats apart) in shared memory, eliminated on
// the core (group_solve.cuh:solve), a block of `cols` consecutive columns
// moving each layer's operands in and history out together.  The block
// copies layer l's diag, upper and rhs straight into the columns of the
// system (cp.async) and its lower into a row-padded buffer.  The product
// lower_l [W | y]_{l-1} is formed in place (dt = diag - s,
// rt = rhs - s): element (i, c) by one lane as a 16-byte-a-load dot of
// lower's row i (a broadcast across the lanes on row i) with column c of
// the carry, whose columns sit cs = row_stride(m) floats apart (4 mod 8,
// so the 8 lanes of a 16-byte access meet distinct banks).  At even
// m = 10..16 the kernel is instantiated for the m (sizes, loops and index
// arithmetic fixed at compile time) and keeps two system and lower
// buffers, layer l + 1's copy running while layer l is eliminated; past
// that m is a run-time argument and one buffer each, copied in after the
// elimination under the history's store (the second buffer cost a block
// an SM there, more than the copy's latency).  Past the shared memory of
// one column the far instance keeps only the system and the pivot rows
// there, the carry and lower in the column's device scratch
// (group_solve.cuh, "Placement").
struct BtLayout {   // offsets in floats
  int w, aw, ls, cs, nsys, a, piv, x, low, near, far;
  __host__ __device__ BtLayout(int m, bool f, bool ring = false)
      : w(2 * m + 1), aw(sbdart_group::row_stride(2 * m + 1)),
        ls(sbdart_group::pad4(m)), cs(sbdart_group::row_stride(m)),
        nsys(ring ? 2 : 1) {
    sbdart_group::Segments g;
    a = g.put(false, nsys * m * aw);
    piv = g.put(false, sbdart_group::pad4(m));
    x = g.put(f, (m + 1) * cs);
    low = g.put(f, nsys * m * ls);
    near = g.near;
    far = g.far;
  }
};

template <int kM, bool kFar>
__global__ void __launch_bounds__(256, 3) block_thomas_group_kernel(
    const float* __restrict__ diag,    // [L, m, m, B]
    const float* __restrict__ lower,   // [L, m, m, B]
    const float* __restrict__ upper,   // [L, m, m, B]
    const float* __restrict__ rhs,     // [L, m, B]
    float* __restrict__ ws,            // [L, m^2, B] scratch: W history
    float* __restrict__ ys,            // [L, m, B]   scratch: y history
    float* __restrict__ xs,            // [L, m, B]
    int nlyr, int m_arg, int ncol, int stride,
    float* far, int far_stride) {   // far segments (the far instance)
  constexpr bool kRing = kM > 0;
  const int m = kM > 0 ? kM : m_arg;
  extern __shared__ __align__(16) float smem[];
  const BtLayout lay(m, kFar, kRing);
  const int w = lay.w, aw = lay.aw, ls = lay.ls, cs = lay.cs;
  const int g = sbdart_group::group_size(m);
  const int lane = threadIdx.x & (g - 1);
  const sbdart_group::Block bk(g, ncol, stride);
  float* base = smem + (threadIdx.x / g) * stride;
  // the far segments of the block's columns, and this column's
  float* fblock = kFar ? far + (long long)blockIdx.x * bk.cols * far_stride
                       : smem;
  const int fstride = kFar ? far_stride : stride;
  float* fbase = fblock + (threadIdx.x / g) * fstride;
  float* x = fbase + lay.x;   // column c of [W | y] at x + c * cs
  int* piv = reinterpret_cast<int*>(base + lay.piv);
  // layer l's diag, upper and rhs into its system buffer, its lower into
  // its lower buffer: one copy group
  auto fetch = [&](int l) {
    const int b = kRing ? (l & 1) : 0;
    const long long first = (long long)l * m * m;
    const int sys = lay.a + b * m * aw;
    bk.stage_rows<true>(smem, stride, sys, aw, diag, first, m, m);
    bk.stage_rows<true>(smem, stride, sys + m, aw, upper, first, m, m);
    bk.stage_rows<true>(smem, stride, sys + w - 1, aw, rhs, (long long)l * m,
                        m, 1);
    bk.stage_rows<!kFar>(fblock, fstride, lay.low + b * m * ls, ls, lower,
                         first, m, m);
    sbdart_group::stage_commit();
  };

  for (int e = lane; e < (m + 1) * cs; e += g) x[e] = 0.0f;
  fetch(0);
  for (int l = 0; l < nlyr; ++l) {
    if (kRing && l + 1 < nlyr) {   // layer l + 1's copy runs meanwhile
      fetch(l + 1);
      sbdart_group::stage_wait_group<1>();
    } else {
      sbdart_group::stage_wait_group<0>();
    }
    const int b = kRing ? (l & 1) : 0;
    float* a = base + lay.a + b * m * aw;
    const float* low = fbase + lay.low + b * m * ls;
    // dt = diag - lower W_{l-1}, rt = rhs - lower y_{l-1}, in place
    sbdart_group::for_each(m, m + 1, lane, g, [&](int i, int c) {
      float* e = a + i * aw + (c < m ? c : w - 1);
      *e = *e - sbdart_group::dot(low + i * ls, x + c * cs, m);
    });
    __syncwarp();
    sbdart_group::solve(a, aw, w, m, x, cs, piv, lane, g);
    __syncthreads();
    if (!kRing && l + 1 < nlyr) fetch(l + 1);   // under the history's store
    bk.store_from(ws, (long long)l * m * m, m, m, fblock, fstride, lay.x, 1,
                  cs);
    bk.store_from(ys, (long long)l * m, m, 1, fblock, fstride, lay.x + m * cs,
                  1);
  }
  __syncthreads();
  sbdart_group::back_sweep(bk, smem, lay.a, lay.nsys * m * aw, ws, ys, xs,
                           nlyr, m, lane, g);
}

// The rows instance (m = kM <= 8, G = 4 or 8): B5's rows instance
// (blocktri_rt_group.cu) on B10's operands.  Lane i holds row i of
// dt = diag - lower W_{l-1} in registers (diag's and lower's row i read
// 16 bytes a load, W's columns a 16-byte broadcast each) and forms
// rhs_i - lower_i y_{l-1}; each lane holds one or two of the m + 1
// right-hand columns [upper | rhs - lower y_{l-1}] whole (column t on
// lane t mod G; the last gathered from the row lanes by shuffle).  The
// elimination moves the pivot row and the multipliers by shuffle
// (group_solve.cuh:solve_rows_cols) and nothing through shared memory.
// [W | y] goes through shared memory once a layer, for the next layer's
// products.  Each layer's operands are copied in (cp.async) as soon as
// the layer before has read its own (a ring of two staged layers measured
// no faster); diag's and lower's rows sit ls = row_stride(m) floats apart
// (4 mod 8: a 16-byte load of each of a group's rows meets distinct
// banks), upper's m.
struct BtRowsLayout {   // offsets in floats; the back sweep reuses `op`
  int ls, up, rl, op, wc, floats;
  __host__ __device__ explicit BtRowsLayout(int m)
      : ls(sbdart_group::row_stride(m)), up(2 * m * ls), rl(up + m * m),
        op(0), wc(rl + sbdart_group::pad4(m)), floats(wc + (m + 1) * ls) {}
};

template <int M>
__global__ void __launch_bounds__(256, 3) block_thomas_rows_kernel(
    const float* __restrict__ diag,    // [L, M, M, B]
    const float* __restrict__ lower,   // [L, M, M, B]
    const float* __restrict__ upper,   // [L, M, M, B]
    const float* __restrict__ rhs,     // [L, M, B]
    float* __restrict__ ws,            // [L, M^2, B] scratch: W history
    float* __restrict__ ys,            // [L, M, B]   scratch: y history
    float* __restrict__ xs,            // [L, M, B]
    int nlyr, int, int ncol, int stride, float*, int) {
  constexpr int G = M <= 4 ? 4 : 8, R = M + 1;
  extern __shared__ __align__(16) float smem[];
  const BtRowsLayout lay(M);
  const int ls = lay.ls;
  const int lane = threadIdx.x & (G - 1);
  const sbdart_group::Block bk(G, ncol, stride);
  float* base = smem + (threadIdx.x / G) * stride;
  const long long col = bk.col0 + threadIdx.x / G;
  const bool real = col < ncol;
  const long long B = ncol;
  const int ta = lane, tb = lane + G;   // this lane's right-hand columns
  const bool has_a = ta < R, has_b = tb < R;
  float* wc = base + lay.wc;   // column c of [W | y] at wc + c * ls
  auto fetch = [&](int l) {
    const int off = lay.op;
    const long long first = (long long)l * M * M;
    bk.stage_rows<true>(smem, stride, off, ls, diag, first, M, M);
    bk.stage_rows<true>(smem, stride, off + M * ls, ls, lower, first, M, M);
    bk.stage_rows<true>(smem, stride, off + lay.up, M, upper, first, M, M);
    bk.stage_rows<true>(smem, stride, off + lay.rl, 1, rhs, (long long)l * M,
                        M, 1);
    sbdart_group::stage_commit();
  };
  // row q of a staged plane (rows ls floats apart), 16 bytes a load
  auto row = [&](const float* p, int q, float (&v)[M]) {
#pragma unroll
    for (int j = 0; j < M; j += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + q * ls + j);
      v[j] = u.x;
      if (j + 1 < M) v[j + 1] = u.y;
      if (j + 2 < M) v[j + 2] = u.z;
      if (j + 3 < M) v[j + 3] = u.w;
    }
  };

  fetch(0);
  for (int e = lane; e < (M + 1) * ls; e += G) wc[e] = 0.0f;
  float xa[M], xb[M];   // this lane's columns of [W | y] of the last layer
#pragma unroll
  for (int q = 0; q < M; ++q) xa[q] = xb[q] = 0.0f;
  for (int l = 0; l < nlyr; ++l) {
    sbdart_group::stage_wait_group<0>();
    const float* dg = base + lay.op;
    const float* low = dg + M * ls;
    const float* up = dg + lay.up;
    const float* rl = dg + lay.rl;

    // ---- row i of dt = diag - lower W_{l-1}, and rhs_i - lower_i y_{l-1}
    float a[M];
    float r_own = 0.0f;
#pragma unroll
    for (int c = 0; c < M; ++c) a[c] = 0.0f;
    if (lane < M) {
      float li[M], wq[M];
      row(low, lane, li);
#pragma unroll
      for (int c = 0; c <= M; ++c) {   // the sums first, then diag's row
        row(wc, c, wq);
        float s = li[0] * wq[0];
#pragma unroll
        for (int q = 1; q < M; ++q) s = s + li[q] * wq[q];
        if (c < M)
          a[c] = s;
        else
          r_own = rl[lane] - s;
      }
      float di[M];
      row(dg, lane, di);
#pragma unroll
      for (int c = 0; c < M; ++c) a[c] = di[c] - a[c];
    }
    // ---- this lane's right-hand columns: upper's, and the lane of column
    // m gathers rhs - lower y_{l-1} from the row lanes ---------------------
    float va[M], vb[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      va[i] = ta < M ? up[i * M + ta] : 0.0f;
      vb[i] = tb < M ? up[i * M + tb] : 0.0f;
      const float r = __shfl_sync(sbdart_group::kFull, r_own, i, G);
      va[i] = ta == M ? r : va[i];
      vb[i] = tb == M ? r : vb[i];
    }

    // ---- elimination: solve_step's steps, rows by lane -------------------
    sbdart_group::solve_rows_cols<M, G>(a, va, vb, lane, has_b, xa, xb);

    // ---- W for the next layer's product, and the history -----------------
    __syncwarp();
    auto put = [&](int t, const float (&x)[M]) {
#pragma unroll
      for (int q = 0; q < M; ++q) wc[t * ls + q] = x[q];
      if (t < M) {
        if (real) {
#pragma unroll
          for (int q = 0; q < M; ++q)
            ws[((long long)l * M * M + q * M + t) * B + col] = x[q];
        }
      } else if (real) {
#pragma unroll
        for (int q = 0; q < M; ++q) ys[((long long)l * M + q) * B + col] = x[q];
      }
    };
    if (has_a) put(ta, xa);
    if (has_b) put(tb, xb);
    __syncthreads();
    if (l + 1 < nlyr) fetch(l + 1);
  }
  sbdart_group::back_sweep(bk, smem, lay.op, lay.wc, ws, ys, xs, nlyr, M,
                           lane, G);
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

namespace {

// The group kernel at m = kM: the rows instance at even kM <= 8, the smem
// instance for the kM beyond; kM = 0 (m a run-time argument) the smem
// instance, with its far instance beside it.
template <int kM>
cudaError_t launch_group(const float* diag, const float* lower,
                         const float* upper, const float* rhs, float* ws,
                         float* ys, float* xs, float* scratch, int nlyr, int m,
                         int ncol, cudaStream_t stream) {
  const int g = sbdart_group::group_size(m);
  if constexpr (kM > 0 && kM <= 8) {
    const int all = BtRowsLayout(kM).floats;
    return sbdart_group::launch(block_thomas_rows_kernel<kM>,
                                block_thomas_rows_kernel<kM>, g, all, all, 0,
                                nullptr, ncol, stream, diag, lower, upper, rhs,
                                ws, ys, xs, nlyr, m, ncol);
  } else {
    auto near_kernel = block_thomas_group_kernel<kM, false>;
    auto far_kernel =
        kM > 0 ? near_kernel : block_thomas_group_kernel<0, true>;
    return sbdart_group::launch(near_kernel, far_kernel, g,
                                BtLayout(m, false, kM > 0).near,
                                BtLayout(m, true).near, BtLayout(m, true).far,
                                scratch, ncol, stream, diag, lower, upper, rhs,
                                ws, ys, xs, nlyr, m, ncol);
  }
}

}  // namespace

extern "C" int sbdart_block_thomas_group(const float* diag,
                                         const float* lower,
                                         const float* upper, const float* rhs,
                                         float* ws, float* ys, float* xs,
                                         float* scratch, int nlyr, int m,
                                         int ncol, cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (m) {
#define SBDART_BT_GROUP_CASE(MM)                                            \
  case MM:                                                                  \
    err = launch_group<MM>(diag, lower, upper, rhs, ws, ys, xs, scratch,    \
                           nlyr, m, ncol, stream);                          \
    break;
    SBDART_BT_GROUP_CASE(2)
    SBDART_BT_GROUP_CASE(4)
    SBDART_BT_GROUP_CASE(6)
    SBDART_BT_GROUP_CASE(8)
    SBDART_BT_GROUP_CASE(10)
    SBDART_BT_GROUP_CASE(12)
    SBDART_BT_GROUP_CASE(14)
    SBDART_BT_GROUP_CASE(16)
#undef SBDART_BT_GROUP_CASE
    default:
      err = launch_group<0>(diag, lower, upper, rhs, ws, ys, xs, scratch,
                            nlyr, m, ncol, stream);
  }
  return static_cast<int>(err);
}

// The one-thread kernel, at the m of blocktri.BT_ONE_THREAD_M only.
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
    SBDART_BT_CASE(4)
#undef SBDART_BT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
