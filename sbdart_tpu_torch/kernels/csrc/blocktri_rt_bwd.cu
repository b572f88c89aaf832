// B6 backward: the back substitution of the rank-N factor history, a
// lane group per column, every N.
//
// Replaces the TPU kernel sbdart_tpu/pallas/blocktri.py:
// _rt_bwd_chunk_kernel.  From the forward kernel's history C_l (2N x N)
// and y_l (2N), per layer l from the top down:
//   x_{L-1} = y_{L-1};  z = ub_l x_{l+1};  x_l = y_l - C_l z,
// with ub_l = -[gp_{l+1}, gm_{l+1} e_{l+1}] (N x 2N), each sum in the
// order of the plain torch version
// (kernels/blocktri_rt_streamed.py:block_thomas_rt_bwd_plain): z_i =
// u_i0 x_0 + u_i1 x_1 + ..., x_r = y_r - (c_r0 z_0 + c_r1 z_1 + ...).
//
// What bounds it on Hopper: bytes.  A layer and column reads 4N^2 + 3N
// floats (C_l, y_l, gp, gm, ee) and writes 2N, against ~8N^2 flops, and
// nothing it loads depends on x.  So the kernel is a stream: the design
// keeps enough of it in flight and moves it in wide pieces.
//
// Design.  A block holds `cols` consecutive columns (16, or 32-128 where
// a column has fewer than 8 lanes, so a block has 128 threads or more),
// G lanes a column (the power of two >= N, 32 past N = 16).
//   - Ring.  Layer l's C_l and y_l and layer l + 1's gp, gm, ee are
//     copied into a ring of S layer slots in shared memory, the copy of a
//     layer issued S - 1 layers before it is used: 16-byte cp.async, four
//     columns a copy, where the planes allow it (columns a multiple of 4,
//     16-byte aligned planes), so a block reads each row of a plane as
//     cols x 4 (>= 64) contiguous bytes; 4-byte copies otherwise.  S = 3
//     (4 to 8 slots measured no faster at N = 2 to 16, slower where they
//     cost blocks an SM), fewer past N = 16 where 3 slots do not fit.
//   - Layout.  A slot is rows of `cols` floats, one row an element, with
//     C_l and gp, gm transposed (row j 2N + r holds c_rj, row k N + i
//     holds g_ik), so the lanes of a column read consecutive rows at
//     every step.  The 16-byte granules of a row are permuted by the row
//     (`Slot::q16`) so that those reads fall on distinct banks (at G = 16
//     two lanes share a bank, at G = 32 four: a column's floats sit in one
//     bank of each granule).  A slot also holds x_l, 2N rows.  (A layout
//     with each granule's rows together, which needs no address
//     arithmetic on a read, measured slower at N = 2, 8, 10 and 16.)
//   - Recursion in registers (to N = 16).  Lane j holds x_{l+1}'s rows
//     j, j + G, ... and computes z_j and x_l's rows j, j + G; x_{l+1}[k]
//     and z_j reach the lanes by __shfl_sync within the column's group.
//     A lane reads each phase's operands from the slot into registers
//     before its chain of sums (faster than reading them term by term,
//     most at N = 10).  x_l goes to the slot, and the next
//     layer's step stores the block's rows of it with 16-byte stores.
// One instance per N up to 16 (every loop unrolled); past 16 N is a
// run-time argument (G = 32, a column a warp), and the lanes read x_{l+1}
// from the previous layer's slot and z from the slot, each a broadcast,
// in loops bounded by N (shuffles in run-time loops measured slower).
// There a block's columns are halved on a deck too narrow to fill the
// SMs (`plan`), and a block of fewer than 128 threads gets warps that only
// copy (threadIdx.y > 0), so that a block of one or two columns (nstr =
// 128's deck) still keeps 128 threads' copies in flight.
// The wrapper refuses from N = 120, where one slot of one column no longer
// fits the card's opt-in shared memory.
//
// Numerics: every element is computed by one lane, in the plain version's
// order; built with --fmad=false, so each product is rounded before its
// sum, as in the plain version.  A column past the last stages the last
// column's rows (4-byte copies) or nothing (16-byte copies) and stores
// nothing.

#include <cuda_runtime.h>

#include <algorithm>

#include "ring.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlots = 3;   // layers in the ring
constexpr int kCopyThreads = 128;   // the fewest threads a block at run-time N

// Lanes a column at N (kN = 0: N a run-time argument, past 16).
__host__ __device__ constexpr int lanes_of(int kN) {
  return kN == 0   ? 32
         : kN <= 1 ? 1
         : kN <= 2 ? 2
         : kN <= 4 ? 4
         : kN <= 8 ? 8
                   : 16;
}

// Columns a block at G lanes a column: 128 threads or more.
__host__ __device__ constexpr int cols_of(int g) {
  return g >= 8 ? 16 : 128 / g;
}

// Threads a block of the instance at N (the most, at run-time N).
__host__ __device__ constexpr int threads_of(int kN) {
  return cols_of(lanes_of(kN)) * lanes_of(kN);
}

// The rows of one column's slot: C^T (2N^2), y (2N), gp^T, gm^T (N^2
// each), ee (N), x (2N).
struct Rows {
  int cs, y, gp, gm, ee, x, all;
  __host__ __device__ explicit Rows(int n)
      : cs(0), y(2 * n * n), gp(2 * n * n + 2 * n), gm(3 * n * n + 2 * n),
        ee(4 * n * n + 2 * n), x(4 * n * n + 3 * n), all(4 * n * n + 5 * n) {}
};

// A slot of `cols` columns at N, G lanes a column: Rows(n).all rows of
// `cols` floats.  Granule q (floats 4q..4q+3) of a row sits at granule
// q ^ t(row) of it, t chosen so that the G consecutive rows the lanes of
// a warp read (of 32 / G columns, 32 / G / 4 granules) land on distinct
// banks: at G = 8 and more rows pair up in 128-byte lines, at G = 4 and
// 2 a warp's granules move by 2 and 4 a row.
struct Slot {
  int cols, mask, floats;
  __host__ __device__ Slot(int n, int cols_)
      : cols(cols_), mask(cols_ / 4 - 1), floats(Rows(n).all * cols_) {}
  template <int G>
  __device__ __forceinline__ int q16(int row, int q) const {
    if (cols < 4) return row * cols;
    const int t =
        G == 1 ? 0 : G == 2 ? row << 2 : G == 4 ? row << 1 : row >> 1;
    return row * cols + (((q ^ t) & mask) << 2);
  }
  template <int G>
  __device__ __forceinline__ int at(int row, int c) const {
    return q16<G>(row, c >> 2) + (c & 3);
  }
};

template <int kN>
__global__ void __launch_bounds__(threads_of(kN)) blocktri_rt_bwd_group_kernel(
    const float* __restrict__ gp,     // [L, N, N, B]
    const float* __restrict__ gm,     // [L, N, N, B]
    const float* __restrict__ ee,     // [L, N, B]
    const float* __restrict__ cs,     // [L, 2N, N, B]
    const float* __restrict__ ys,     // [L, 2N, B]
    float* __restrict__ xs,           // [L, 2N, B]
    int nlyr, int n_arg, int ncol, int slots, int vec) {
  constexpr int G = lanes_of(kN);
  constexpr int RX = kN ? (2 * kN + G - 1) / G : 1;   // x_{l+1} rows a lane
  extern __shared__ __align__(16) float smem[];
  const int n = kN ? kN : n_arg;
  const int m = 2 * n;
  const Rows rows(n);
  // columns a block: the instance's at N <= 16, the plan's past it (a
  // block's threads with threadIdx.y > 0 only copy)
  const int cols = kN ? cols_of(G) : blockDim.x / G;
  const Slot sl(n, cols);
  const int tid = kN ? threadIdx.x : threadIdx.x + threadIdx.y * blockDim.x;
  const int nt = kN ? threads_of(kN) : blockDim.x * blockDim.y;
  const int j = tid % G;            // the lane in the column's group
  const int cb = tid / G;           // the column in the block
  const int col0 = blockIdx.x * cols;
  const int col = min(col0 + cb, ncol - 1);
  const long long B = ncol;
  auto slot_of = [&](int s) { return smem + s * sl.floats; };

  // A block's copies of a row: its granules (16-byte copies) or its
  // columns (4-byte ones), a power of two; thread t copies number t mod
  // per of every D-th row from row t / per.
  const int per = vec ? cols >> 2 : cols;
  const int ps = __ffs(per) - 1;
  const int pc = tid & (per - 1), D = nt >> ps;

  // Start copying `count` rows of a plane into the slot from row `row0`:
  // row row0 + p a + r (r < a) holds element r b + p (a = count, b = 1:
  // in order; a = 2N, b = N: C transposed; a = b = N: gp, gm transposed),
  // element e of column c at src[(first + e) * B + c].  A warp's copies
  // are whole rows (16 x cols contiguous bytes of the plane), so its
  // writes fall on as few wavefronts as they can; (p, r) advance without
  // a division.
  auto stage_plane = [&](float* slot, int row0, const float* src,
                         long long first, int count, int a, int b) {
    int d = tid >> ps, p = d / a, r = d - p * a;
    const int dp = D / a, dr = D - dp * a;
    for (; d < count; d += D) {
      const float* row = src + (first + (long long)r * b + p) * B;
      if (vec) {
        if (col0 + 4 * pc < ncol)
          sbdart_ring::copy16(slot + sl.q16<G>(row0 + d, pc),
                              row + col0 + 4 * pc);
      } else {
        sbdart_ring::copy4(slot + sl.at<G>(row0 + d, pc),
                           row + min(col0 + pc, ncol - 1));
      }
      p += dp;
      r += dr;
      if (r >= a) {
        r -= a;
        ++p;
      }
    }
  };
  // the operands of layer l = nlyr - 2 - t (iteration t) into its slot
  auto stage = [&](int t) {
    const int l = nlyr - 2 - t;
    if (l >= 0) {
      float* slot = slot_of(t % slots);
      const long long lp = l + 1;
      // c_rj (element r N + j) at row j 2N + r; g_ik (i N + k) at k N + i
      stage_plane(slot, rows.cs, cs, (long long)l * m * n, m * n, m, n);
      stage_plane(slot, rows.y, ys, (long long)l * m, m, m, 1);
      stage_plane(slot, rows.gp, gp, lp * n * n, n * n, n, n);
      stage_plane(slot, rows.gm, gm, lp * n * n, n * n, n, n);
      stage_plane(slot, rows.ee, ee, lp * n, n, n, 1);
    }
    sbdart_ring::commit();
  };
  // store x_l from its slot, the block's rows together
  auto store_x = [&](const float* slot, int l) {
    float* dst = xs + (long long)l * m * B;
    for (int r = tid >> ps; r < m; r += D) {
      if (vec) {
        if (col0 + 4 * pc < ncol)
          *reinterpret_cast<float4*>(dst + r * B + col0 + 4 * pc) =
              *reinterpret_cast<const float4*>(slot +
                                               sl.q16<G>(rows.x + r, pc));
      } else if (col0 + pc < ncol) {
        dst[r * B + col0 + pc] = slot[sl.at<G>(rows.x + r, pc)];
      }
    }
  };

  for (int t = 0; t < slots - 1; ++t) stage(t);

  // x_{L-1} = y_{L-1}: into the lanes' registers (at run-time N into the
  // slot the first layer reads it from), and to xs
  float xr[RX];
  if constexpr (kN > 0) {
#pragma unroll
    for (int q = 0; q < RX; ++q) {
      const int r = q * G + j;
      xr[q] = r < m ? ys[((long long)(nlyr - 1) * m + r) * B + col] : 0.0f;
    }
  } else if (cb < cols) {
    float* x0 = slot_of(slots - 1);
    for (int r = j; r < m; r += G)
      x0[sl.at<G>(rows.x + r, cb)] =
          ys[((long long)(nlyr - 1) * m + r) * B + col];
  }
  {
    const float* src = ys + (long long)(nlyr - 1) * m * B;
    float* dst = xs + (long long)(nlyr - 1) * m * B;
    for (int i = tid; i < m * cols; i += nt) {
      const int r = i >> (__ffs(cols) - 1), c = col0 + (i & (cols - 1));
      if (c < ncol) dst[r * B + c] = src[r * B + c];
    }
  }

  for (int t = 0; t + 1 < nlyr; ++t) {
    const int l = nlyr - 2 - t;
    // iteration t's copies have landed (at most slots - 2 newer groups in
    // flight; with one slot they are issued below), and every lane is
    // done with iteration t - 1
    if (slots == 3)
      sbdart_ring::wait<1>();
    else if (slots == 2)
      sbdart_ring::wait<0>();
    __syncthreads();
    if (t > 0) store_x(slot_of((t - 1) % slots), l + 1);
    stage(t + slots - 1);   // into the slot iteration t - 1 read
    if (slots == 1) {
      sbdart_ring::wait<0>();
      __syncthreads();
    }
    float* slot = slot_of(t % slots);
    // this lane's column's float of a row of the layer's slot
    auto v = [&](int row) -> float& { return slot[sl.at<G>(row, cb)]; };

    if constexpr (kN > 0) {
      // G >= N: lane j computes z_j and x_l's rows j, j + G.  Each phase
      // reads its operands into registers before its chain of sums.
      // z_j = sum_k u_jk x_{l+1}[k] (a lane past N computes a z no lane
      // reads)
      float u[2 * kN], xk[2 * kN];
      const int i = min(j, kN - 1);
#pragma unroll
      for (int k = 0; k < 2 * kN; ++k) {
        xk[k] = G == 1 ? xr[k / G] : __shfl_sync(kFull, xr[k / G], k % G, G);
        u[k] = k < kN ? -v(rows.gp + k * kN + i)
                      : -(v(rows.gm + (k - kN) * kN + i) * v(rows.ee + k - kN));
      }
      float z = u[0] * xk[0];
#pragma unroll
      for (int k = 1; k < 2 * kN; ++k) z = z + u[k] * xk[k];
      // x_l[r] = y_l[r] - sum_j c_rj z_j
      float zj[kN];
#pragma unroll
      for (int jz = 0; jz < kN; ++jz)
        zj[jz] = G == 1 ? z : __shfl_sync(kFull, z, jz, G);
#pragma unroll
      for (int q = 0; q < RX; ++q) {
        const int r = q * G + j;
        if (r < m) {
          float c[kN];
#pragma unroll
          for (int jz = 0; jz < kN; ++jz) c[jz] = v(rows.cs + jz * m + r);
          float acc = c[0] * zj[0];
#pragma unroll
          for (int jz = 1; jz < kN; ++jz) acc = acc + c[jz] * zj[jz];
          xr[q] = v(rows.y + r) - acc;
          v(rows.x + r) = xr[q];
        }
      }
    } else if (cb < cols) {
      // run-time N (G = 32, a column a warp): lane j computes z's rows j,
      // j + 32, ... and x_l's, term by term, reading x_{l+1} from the
      // previous layer's slot and each z_i from this slot's row of gp
      // that held g_i0, which only z_i's lane reads, once z_i is formed;
      // every such read is a broadcast
      const float* xn = slot_of((t + slots - 1) % slots);
      for (int i = j; i < n; i += G) {
        float z = 0.0f;
        for (int k = 0; k < m; ++k) {
          const float u = k < n ? -v(rows.gp + k * n + i)
                                : -(v(rows.gm + (k - n) * n + i) *
                                    v(rows.ee + k - n));
          const float prod = u * xn[sl.at<G>(rows.x + k, cb)];
          z = k == 0 ? prod : z + prod;
        }
        v(rows.gp + i) = z;
      }
      __syncwarp();
      for (int r = j; r < m; r += G) {
        float acc = 0.0f;
        for (int jz = 0; jz < n; ++jz) {
          const float prod = v(rows.cs + jz * m + r) * v(rows.gp + jz);
          acc = jz == 0 ? prod : acc + prod;
        }
        v(rows.x + r) = v(rows.y + r) - acc;
      }
    }
  }
  if (nlyr >= 2) {
    __syncthreads();
    store_x(slot_of((nlyr - 2) % slots), 0);
  }
}

// A launch's placement: `cols` columns a block and `slots` layers in the
// ring, kSlots where they fit the card's opt-in shared memory (to N = 16
// they do), else as many as fit.  At run-time N the columns a block are
// first halved while the blocks stay within one wave (a deck of few
// columns, such as nstr = 128's 12, gets a column a block), then until
// one slot fits.  (Halving until every SM had a block measured slower at
// 768 columns, N = 24 and 32, where the blocks then took two waves;
// keeping 3 slots of fewer columns where the SMs are full measured slower
// at N = 20 and 32.)
struct Plan {
  int cols, slots;
  size_t bytes;
};

cudaError_t plan(int n, int g, int ncol, bool shrink, Plan* p) {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p->cols = cols_of(g);
  while (shrink && p->cols > 1 && 2 * ((ncol + p->cols - 1) / p->cols) <= sms)
    p->cols >>= 1;
  for (;; p->cols >>= 1) {
    const size_t slot = sizeof(float) * (size_t)Slot(n, p->cols).floats;
    p->slots = std::min((int)(optin / slot), kSlots);
    p->bytes = slot * p->slots;
    if (p->slots >= 1) return cudaSuccess;
    if (!shrink || p->cols == 1) return cudaErrorInvalidValue;
  }
}

template <int kN>
cudaError_t launch(const float* gp, const float* gm, const float* ee,
                   const float* cs, const float* ys, float* xs, int nlyr,
                   int n, int ncol, cudaStream_t stream) {
  constexpr int G = lanes_of(kN);
  Plan p;
  cudaError_t err = plan(n, G, ncol, kN == 0, &p);
  if (err != cudaSuccess) return err;
  auto kernel = blocktri_rt_bwd_group_kernel<kN>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const bool vec = p.cols % 4 == 0 && ncol % 4 == 0 &&
                   sbdart_ring::aligned16({gp, gm, ee, cs, ys, xs});
  const int blocks = (ncol + p.cols - 1) / p.cols;
  // at run-time N, warps that only copy where the columns have fewer
  const dim3 threads(p.cols * G,
                     kN ? 1 : std::max(1, kCopyThreads / (p.cols * G)));
  kernel<<<blocks, threads, p.bytes, stream>>>(
      gp, gm, ee, cs, ys, xs, nlyr, n, ncol, p.slots, vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of the least the kernel runs with at N: one slot of
// one column (the wrapper refuses an N where they exceed the card's
// opt-in limit: N = 120 on an H100).
extern "C" int sbdart_blocktri_rt_bwd_group_bytes(int n) {
  return static_cast<int>(sizeof(float)) * Slot(n, 1).floats;
}

extern "C" int sbdart_blocktri_rt_bwd_group(
    const float* gp, const float* gm, const float* ee, const float* cs,
    const float* ys, float* xs, int nlyr, int n, int ncol,
    cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (n) {
#define SBDART_BWD_GROUP_CASE(NN)                                           \
  case NN:                                                                  \
    err = launch<NN>(gp, gm, ee, cs, ys, xs, nlyr, n, ncol, stream);        \
    break;
    SBDART_BWD_GROUP_CASE(1)
    SBDART_BWD_GROUP_CASE(2)
    SBDART_BWD_GROUP_CASE(3)
    SBDART_BWD_GROUP_CASE(4)
    SBDART_BWD_GROUP_CASE(5)
    SBDART_BWD_GROUP_CASE(6)
    SBDART_BWD_GROUP_CASE(7)
    SBDART_BWD_GROUP_CASE(8)
    SBDART_BWD_GROUP_CASE(9)
    SBDART_BWD_GROUP_CASE(10)
    SBDART_BWD_GROUP_CASE(11)
    SBDART_BWD_GROUP_CASE(12)
    SBDART_BWD_GROUP_CASE(13)
    SBDART_BWD_GROUP_CASE(14)
    SBDART_BWD_GROUP_CASE(15)
    SBDART_BWD_GROUP_CASE(16)
#undef SBDART_BWD_GROUP_CASE
    default:
      err = launch<0>(gp, gm, ee, cs, ys, xs, nlyr, n, ncol, stream);
  }
  return static_cast<int>(err);
}
