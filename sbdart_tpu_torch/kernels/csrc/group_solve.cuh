// The elimination core of the group kernels: one column's small dense
// system solved by a group of G lanes (G = 4, 8, 16 or 32, a power of two,
// so that a group never straddles a warp and several narrow columns share
// one), with N a run-time argument.  Used by B4, B5, B6 and B10
// (eig_beam_group.cu, blocktri_rt_group.cu, blocktri_rt_streamed_group.cu,
// block_thomas.cu); at small N the system in registers instead
// (solve_rows, solve_rows_cols).
//
// The augmented system [A | R] (m rows, w columns) of one column lives in
// shared memory, row major (row_stride); lane r owns the rows r, r + G,
// ...  Pivoted elimination as solve_step.cuh and the plain torch
// kernels/blocktri_rt.py:solve_step, step by step:
//   pivot  the FIRST row of maximal |a[i][k]| among the rows not yet
//          eliminated, eliminated rows counting as -1, in torch.argmax's
//          order (as jnp.argmax in the reference's _solve_step): a NaN
//          above every number, so the first NaN row wins where there is
//          one.  Each lane scans its rows in order keeping the first
//          maximum, and a butterfly of shuffles keeps the larger and, on a
//          tie, the lower row.
//   update each lane, for each of its rows i still in play, forms
//          f = a[i][k] * (1 / a[p][k]) and updates the row's columns
//          c > k: a[i][c] = a[i][c] - f * a[p][c], four at a time.
//   back   each right-hand column is done by one lane,
//          x[i] = (a[p_i][m + t] - sum_{j > i} a[p_i][j] x[j]) / a[p_i][i],
//          the sum in order j = i + 1, ... (four terms read at a time).
// Each element is computed by one lane in the plain version's order, so
// the result equals the plain version's to the bit (--fmad=false).
// One __syncwarp() a step orders the shared-memory updates; the lanes of a
// warp all run the same steps (N is the same for every column of a launch;
// a group past the last column works on a copy of the last column and
// stores nothing).
//
// The kernels stage each layer's operands from device memory into shared
// memory with cp.async (4-byte copies, all in flight at once), so a layer
// waits for one round trip to memory rather than for each load in turn.
//
// Placement.  A BVP kernel's column holds its system and, beside it, the
// carry, the lower block's rows, the surface operator and its bounds and
// the staged operands.  Where all of it fits the card's opt-in shared
// memory, all of it lives there (the "near" instance).  Past that the
// launcher runs the "far" instance of the same kernel: the system (and the
// pivot rows) stay in shared memory and the rest moves to per-column
// device scratch that the wrapper allocates (`plan`, `scratch_floats`),
// read back through L2; the operations and their order are the same, so
// both equal the plain version to the bit.

#pragma once

#include <cuda_runtime.h>

namespace sbdart_group {

constexpr unsigned kFull = 0xffffffffu;

// The group's lane count for a system of m rows: 4, 8, 16 or 32 (4 at
// m <= 4, so that eight small systems share a warp with no lane idle).
__host__ __device__ inline int group_size(int m) {
  return m <= 4 ? 4 : (m <= 8 ? 8 : (m <= 16 ? 16 : 32));
}

// The row stride of a system w columns wide: 4 mod 8 floats, so that each
// row starts on 16 bytes for the update's float4 accesses, and the rows of
// the 8 lanes that share a wavefront of them fall on distinct banks.
__host__ __device__ inline int row_stride(int w) { return (w + 3) / 8 * 8 + 4; }

// Floats one column takes, padded so that the columns a warp holds start
// G banks apart (stride = G mod 32), and 16-byte aligned; at G = 32 (one
// column a warp) the stride is 4 mod 32, so that the block's staging
// writes, one element of each of its 8 columns at a time, fall on
// distinct banks.
__host__ inline int column_stride(int floats, int g) {
  const int want = g == 32 ? 4 : g;
  int s = floats;
  while (s % 32 != want) ++s;
  return s;
}

// Start a 4-byte copy from device memory into shared memory.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// The block's columns: `cols` (a power of two) consecutive columns from
// col0, each a group of G lanes with `stride` floats of shared memory.
// The block moves each layer's operands and results between device memory
// and shared memory together, thread t on element t / cols of column
// t mod cols, so that a warp's accesses are whole 32-byte sectors of the
// column-minor planes.
struct Block {
  int t, nt, cols, shift, col0, ncol, stride;
  long long B;
  __device__ Block(int g, int ncol_, int stride_)
      : t(threadIdx.x), nt(blockDim.x), cols(blockDim.x / g), shift(0),
        col0(blockIdx.x * (blockDim.x / g)), ncol(ncol_), stride(stride_),
        B(ncol_) {
    while ((1 << shift) < cols) ++shift;
  }

  // Start copying count floats of a plane, element e of column c at
  // src[(first + e) * B + c], to offset off + e of each column's region
  // (a column past the last reads the last).
  __device__ __forceinline__ void stage(float* smem, int off, const float* src,
                                        long long first, int count) const {
    stage_into<true>(smem, stride, off, src, first, count);
  }

  // The same into regions of `bstride` floats from `base`: in shared memory
  // by cp.async, or (kShared false: a far instance's device scratch) by
  // plain copies, visible to the block after stage_wait().
  template <bool kShared>
  __device__ __forceinline__ void stage_into(float* base, int bstride, int off,
                                             const float* src, long long first,
                                             int count) const {
    for (int i = t; i < (count << shift); i += nt) {
      const int e = i >> shift, s = i & (cols - 1);
      const int c = min(col0 + s, ncol - 1);
      float* dst = base + s * bstride + off + e;
      const float* from = src + (first + e) * B + c;
      if constexpr (kShared)
        copy_async(dst, from);
      else
        *dst = *from;
    }
  }

  // The same for a plane of rows x len elements (element (r, k) at
  // src[(first + r len + k) * B + c]) into rows `rs` floats apart: to
  // offset off + r rs + k of each column's region.  A thread's elements
  // are G apart, so (r, k) advances without a division.
  template <bool kShared>
  __device__ __forceinline__ void stage_rows(float* base, int bstride, int off,
                                             int rs, const float* src,
                                             long long first, int rows,
                                             int len) const {
    const int s = t & (cols - 1);
    float* dst = base + s * bstride + off;
    const float* from = src + first * B + min(col0 + s, ncol - 1);
    const int step = nt >> shift;
    const int dr = step / len, dk = step - dr * len;
    int e = t >> shift;
    int r = e / len, k = e - r * len;
    for (; r < rows; e += step) {
      if constexpr (kShared)
        copy_async(dst + r * rs + k, from + (long long)e * B);
      else
        dst[r * rs + k] = from[(long long)e * B];
      r += dr;
      k += dk;
      if (k >= len) {
        k -= len;
        ++r;
      }
    }
  }

  // Store rows x per floats of each column's region (element (r, k) at
  // offset off + r * rs + k * ks) to dst[(first + r * per + k) * B + c].
  __device__ __forceinline__ void store(float* dst, long long first, int rows,
                                        int per, const float* smem, int off,
                                        int rs, int ks = 1) const {
    store_from(dst, first, rows, per, smem, stride, off, rs, ks);
  }

  // The same from regions of `bstride` floats from `base`.
  __device__ __forceinline__ void store_from(float* dst, long long first,
                                             int rows, int per,
                                             const float* base, int bstride,
                                             int off, int rs,
                                             int ks = 1) const {
    for (int i = t; i < (rows << shift); i += nt) {
      const int r = i >> shift, s = i & (cols - 1);
      const int c = col0 + s;
      if (c >= ncol) continue;
      const float* from = base + s * bstride + off + r * rs;
      float* to = dst + (first + (long long)r * per) * B + c;
      for (int k = 0; k < per; ++k) to[k * B] = from[k * ks];
    }
  }
};

// Wait for this thread's copies, then for the block's.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// The floats of n rounded up to a multiple of 4 (16 bytes).
__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// sum_k a[k] b[k] for k < len, in order: the first product, then each
// next one added (as the plain versions' lane matmul); a and b 16-byte
// aligned, read four at a time.
__device__ __forceinline__ float dot(const float* a, const float* b, int len) {
  float s = a[0] * b[0];
  int k = 1;
  for (; k < len && (k & 3); ++k) s = s + a[k] * b[k];
  for (; k + 3 < len; k += 4) {
    const float4 u = *reinterpret_cast<const float4*>(a + k);
    const float4 v = *reinterpret_cast<const float4*>(b + k);
    s = s + u.x * v.x;
    s = s + u.y * v.y;
    s = s + u.z * v.z;
    s = s + u.w * v.w;
  }
  for (; k < len; ++k) s = s + a[k] * b[k];
  return s;
}

// Call f(i, j) for the elements (i, j) of a rows x cols matrix this lane
// owns, lane, lane + g, ... in row-major order.
template <typename F>
__device__ __forceinline__ void for_each(int rows, int cols, int lane, int g,
                                         F f) {
  int i = lane / cols, j = lane - (lane / cols) * cols;
  const int di = g / cols, dj = g - (g / cols) * cols;
  while (i < rows) {
    f(i, j);
    i += di;
    j += dj;
    if (j >= cols) {
      j -= cols;
      ++i;
    }
  }
}

// One bottom-row entry of a layer's diagonal block: d - last * rg with
// rg = sum_q R[i][q] g[q] (in order), as the plain versions form
// d_bot - last * (R [gm e, gp]) on every layer.  Where last = 0, d != 0
// and the bound rs * gs of |rg| (rs = sum |R[i][q]|, gs = sum |g[q]|, both
// NaN where a term is) is finite and small, 0 * rg is a zero and the
// entry is d: rg is not formed.  g[q] = gq(q).
template <typename G>
__device__ __forceinline__ float surface_row(float d, float last,
                                             const float* ri, float rs,
                                             float gs, int n, G gq) {
  if (last == 0.0f && d != 0.0f && rs * gs < 1e37f) return d;
  float rg = ri[0] * gq(0);
  for (int q = 1; q < n; ++q) rg = rg + ri[q] * gq(q);
  return d - last * rg;
}

// A pivot candidate as one ordered key, the larger winning, in
// torch.argmax's order: a NaN above every number (0xffffffff), then by
// value (|a| >= 0 above an eliminated row's -1 and a lane's "no row" -3),
// ties to the lower row (the low word, 0x7fffffff - row).
__device__ __forceinline__ unsigned long long pivot_key(float cand, int row) {
  const unsigned v = cand != cand       ? 0xffffffffu
                     : cand >= 0.0f     ? 0x80000000u + __float_as_uint(cand)
                     : cand == -1.0f    ? 1u
                                        : 0u;
  return (static_cast<unsigned long long>(v) << 32) |
         static_cast<unsigned>(0x7fffffff - row);
}

// The butterfly of a pivot search over the G lanes of a group: each lane
// brings its best key and all leave with the group's row.
__device__ __forceinline__ int pivot_butterfly(unsigned long long key,
                                               int g) {
  for (int off = g >> 1; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, key, off, g);
    key = o > key ? o : key;
  }
  return 0x7fffffff - static_cast<int>(key & 0xffffffffu);
}

// The pivot row of step k (see the file comment); bit r of `done` marks
// this lane's row lane + r g as eliminated.  Each lane keeps the largest
// key of its rows, scanned in order, then the butterfly.
__device__ __forceinline__ int pivot_row(const float* a, int ws, int m, int k,
                                         unsigned done, int lane, int g) {
  unsigned long long best = pivot_key(-3.0f, m);
  for (int i = lane, r = 0; i < m; i += g, ++r) {
    const float cand = ((done >> r) & 1u) ? -1.0f : fabsf(a[i * ws + k]);
    const unsigned long long key = pivot_key(cand, i);
    best = key > best ? key : best;
  }
  return pivot_butterfly(best, g);
}

// The same elimination on a system held in registers: lane i < M holds
// row i of [A | b] (M x (M + 1), M <= G, M a template argument so that
// every index is a constant).  Step k takes the pivot row by the
// butterfly, broadcasts its columns k.. by shuffles and updates the rows
// still in play; lane k keeps step k's pivot row for the back
// substitution, which runs row by row, each x[i] broadcast from lane i.
// Every lane leaves with the solution x (solve_step's operations in its
// order; the lanes past M take no part).
template <int M>
__device__ __forceinline__ void solve_rows(float (&a)[M + 1], int i, int g,
                                           float (&x)[M]) {
  bool done = i >= M;
  float keep[M + 1];
#pragma unroll
  for (int c = 0; c <= M; ++c) keep[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float cand = i >= M ? -3.0f : (done ? -1.0f : fabsf(a[k]));
    const int p = pivot_butterfly(pivot_key(cand, i), g);
    float prow[M + 1];
#pragma unroll
    for (int c = k; c <= M; ++c) prow[c] = __shfl_sync(kFull, a[c], p, g);
    const float inv = 1.0f / prow[k];
    if (!done && i != p) {
      const float f = a[k] * inv;
#pragma unroll
      for (int c = k + 1; c <= M; ++c) a[c] = a[c] - f * prow[c];
    }
    done = done || i == p;
    if (i == k) {
#pragma unroll
      for (int c = k; c <= M; ++c) keep[c] = prow[c];
    }
  }
#pragma unroll
  for (int r = M - 1; r >= 0; --r) {
    float s = keep[M];
#pragma unroll
    for (int j = r + 1; j < M; ++j) s = s - keep[j] * x[j];
    x[r] = __shfl_sync(kFull, s / keep[r], r, g);
  }
}

// The elimination of solve_rows with the right-hand sides by column: lane
// i < M holds row i of A (M x M, M <= G) in `a`, and each lane up to two
// of the right-hand columns whole (va, vb: the column's M rows; has_b
// whether the second is real).  Step k takes the pivot row by the
// butterfly, broadcasts its columns k.. by shuffles and updates the rows
// still in play, and the rows' multipliers go to the column lanes by
// shuffle; each lane keeps every step's pivot row (its entries of A and
// of this lane's columns) and back-substitutes its own columns into xa
// and xb (xb zero where has_b is false).  The operations are solve_step's
// in its order.  Every lane of the group takes part.
template <int M, int G>
__device__ __forceinline__ void solve_rows_cols(float (&a)[M], float (&va)[M],
                                                float (&vb)[M], int lane,
                                                bool has_b, float (&xa)[M],
                                                float (&xb)[M]) {
  float keep[M][M];             // step k's pivot row, columns k..M-1
  float keep_a[M], keep_b[M];   // and its entries of this lane's columns
  unsigned done = 0;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const bool mine_done = lane >= M || ((done >> lane) & 1u);
    const float cand = lane >= M ? -3.0f : (mine_done ? -1.0f : fabsf(a[k]));
    const int p = pivot_butterfly(pivot_key(cand, lane), G);
#pragma unroll
    for (int c = k; c < M; ++c) keep[k][c] = __shfl_sync(kFull, a[c], p, G);
    const float inv = 1.0f / keep[k][k];
    float f = 0.0f;
    if (!mine_done && lane != p) {
      f = a[k] * inv;
#pragma unroll
      for (int c = k + 1; c < M; ++c) a[c] = a[c] - f * keep[k][c];
    }
    float pa = va[0], pb = vb[0];
#pragma unroll
    for (int i = 1; i < M; ++i) {
      pa = (i == p) ? va[i] : pa;
      pb = (i == p) ? vb[i] : pb;
    }
    keep_a[k] = pa;
    keep_b[k] = pb;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float fi = __shfl_sync(kFull, f, i, G);
      if (!((done >> i) & 1u) && i != p) {
        va[i] = va[i] - fi * pa;
        vb[i] = vb[i] - fi * pb;
      }
    }
    done |= 1u << p;
  }
#pragma unroll
  for (int r = M - 1; r >= 0; --r) {
    float s = keep_a[r], u = keep_b[r];
#pragma unroll
    for (int j = r + 1; j < M; ++j) {
      s = s - keep[r][j] * xa[j];
      u = u - keep[r][j] * xb[j];
    }
    xa[r] = s / keep[r][r];
    xb[r] = has_b ? u / keep[r][r] : 0.0f;
  }
}

// Solve A X = B for A = a[:, 0:m], B = a[:, m:w] (a, row stride ws, a
// multiple of 4 not below w rounded up to one, is destroyed), the solution
// column-major into x[t * xs + i] for t = 0..w-m-1 (x and xs 16-byte
// aligned); piv is m ints of scratch.  m <= 32 g.  Entered and left after
// a __syncwarp().  The row update runs four columns at a time from column
// k + 1 rounded down to a multiple of 4 up to w rounded up: the columns
// <= k of a row still in play are never read again (the later pivots'
// entries past their own step are), and those past w are padding.
__device__ __forceinline__ void solve(float* a, int ws, int w, int m,
                                      float* x, int xs, int* piv, int lane,
                                      int g) {
  const int lg = __ffs(g) - 1;
  unsigned done = 0;
  for (int k = 0; k < m; ++k) {
    const int p = pivot_row(a, ws, m, k, done, lane, g);
    const float* prow = a + p * ws;
    const float inv = 1.0f / prow[k];
    for (int i = lane, r = 0; i < m; i += g, ++r) {
      if (((done >> r) & 1u) || i == p) continue;
      float* row = a + i * ws;
      const float f = row[k] * inv;
      for (int c = (k + 1) & ~3; c < w; c += 4) {
        float4 v = *reinterpret_cast<float4*>(row + c);
        const float4 q = *reinterpret_cast<const float4*>(prow + c);
        v.x = v.x - f * q.x;
        v.y = v.y - f * q.y;
        v.z = v.z - f * q.z;
        v.w = v.w - f * q.w;
        *reinterpret_cast<float4*>(row + c) = v;
      }
    }
    if ((p & (g - 1)) == lane) done |= 1u << (p >> lg);
    if (lane == 0) piv[k] = p;
    __syncwarp();
  }
  for (int c = m + lane; c < w; c += g) {
    float* xt = x + (c - m) * xs;
    for (int i = m - 1; i >= 0; --i) {
      const float* prow = a + piv[i] * ws;
      float s = prow[c];
      int j = i + 1;
      for (; j < m && (j & 3); ++j) s = s - prow[j] * xt[j];
      for (; j + 3 < m; j += 4) {
        const float4 u = *reinterpret_cast<const float4*>(prow + j);
        const float4 v = *reinterpret_cast<const float4*>(xt + j);
        s = s - u.x * v.x;
        s = s - u.y * v.y;
        s = s - u.z * v.z;
        s = s - u.w * v.w;
      }
      for (; j < m; ++j) s = s - prow[j] * xt[j];
      xt[i] = s / prow[i];
    }
  }
  __syncwarp();
}

// Close the copies this thread started since the last commit into a
// group; wait until at most `n` of its groups are in flight, then for the
// block.
__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void stage_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
  __syncthreads();
}

// The back sweep of a full-W block-Thomas (B5, B10): x_{L-1} = y_{L-1},
// x_l = y_l - W_l x_{l+1}, from the history ws [L, m*m, B], ys [L, m, B],
// in `room` floats at `off` of each column's shared memory.  A layer's W
// and y take m*m + m floats, x_{l+1} and x_l m each; where two layers fit
// the next one's copy runs while this one is summed.  Row r of x_l is
// done by lane r mod g.  Entered after a __syncthreads() that follows the
// history's stores.
__device__ __forceinline__ void back_sweep(const Block& bk, float* smem,
                                           int off, int room, const float* wsh,
                                           const float* ys, float* xs,
                                           int nlyr, int m, int lane, int g) {
  const int slot = bk.t / g;
  const int per = m * m + m;
  const bool two = 2 * per + 2 * m <= room;
  float* region = smem + slot * bk.stride;
  const int cur0 = off + (two ? 2 : 1) * per;
  int cur = cur0, nxt = cur0 + m;
  auto fetch = [&](int buf, int l) {
    bk.stage(smem, off + buf * per, wsh, (long long)l * m * m, m * m);
    bk.stage(smem, off + buf * per + m * m, ys, (long long)l * m, m);
    stage_commit();
  };
  bk.stage(smem, cur, ys, (long long)(nlyr - 1) * m, m);
  stage_commit();
  if (two && nlyr >= 2) {
    fetch(0, nlyr - 2);
    stage_wait_group<1>();
  } else {
    stage_wait_group<0>();
  }
  bk.store(xs, (long long)(nlyr - 1) * m, m, 1, smem, cur, 1);
  for (int l = nlyr - 2, k = 0; l >= 0; --l, ++k) {
    const int buf = two ? (k & 1) : 0;
    if (!two) {
      fetch(0, l);
      stage_wait_group<0>();
    } else if (l >= 1) {
      fetch(buf ^ 1, l - 1);
      stage_wait_group<1>();
    } else {
      stage_wait_group<0>();
    }
    const float* w_l = region + off + buf * per;
    const float* y_l = w_l + m * m;
    const float* xc = region + cur;
    float* xn = region + nxt;
    for (int r = lane; r < m; r += g) {
      const float* wr = w_l + r * m;
      float s = wr[0] * xc[0];
      for (int j = 1; j < m; ++j) s = s + wr[j] * xc[j];
      xn[r] = y_l[r] - s;
    }
    __syncthreads();
    bk.store(xs, (long long)l * m, m, 1, smem, nxt, 1);
    const int t = cur;
    cur = nxt;
    nxt = t;
  }
}

// A region of `size` floats in one of a column's two segments (near: its
// shared memory; far: its device scratch), laid out in call order.  Every
// size is a multiple of 4 floats, so each region starts on 16 bytes.
struct Segments {
  int near = 0, far = 0;
  __host__ __device__ int put(bool to_far, int size) {
    int& at = to_far ? far : near;
    const int off = at;
    at += size;
    return off;
  }
};

// A launch's placement: `cols` columns a block (8 where they fit, 16 at
// G = 4: a 32-byte sector of each column-minor row and at least 64 lanes),
// `stride` floats of shared memory a column, and whether the far instance
// runs: `all` is the floats of one column with every region in shared
// memory, `sys` with only the far instance's near segment (the system and
// the pivot rows).  Fails with cudaErrorInvalidValue where even that does
// not fit the card's opt-in shared memory (the wrappers refuse that N
// first, naming the limit).
struct Plan {
  int cols, stride;
  bool far;
};

__host__ inline cudaError_t plan(int g, int all, int sys, Plan* p) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const size_t limit = (size_t)optin;
  p->far = sizeof(float) * (size_t)column_stride(all, g) > limit;
  p->stride = column_stride(p->far ? sys : all, g);
  const size_t col_bytes = sizeof(float) * (size_t)p->stride;
  p->cols = g <= 4 ? 16 : 8;
  while (p->cols > 1 && p->cols * col_bytes > limit) p->cols >>= 1;
  return p->cols * col_bytes > limit ? cudaErrorInvalidValue : cudaSuccess;
}

// Floats of device scratch a far launch over ncol columns takes: `far`
// floats for each column of each block (0 where the near instance runs or
// the column does not fit at all).
__host__ inline long long scratch_floats(int g, int all, int sys, int far,
                                         int ncol) {
  Plan p;
  if (ncol <= 0 || plan(g, all, sys, &p) != cudaSuccess || !p.far) return 0;
  const long long blocks = (ncol + p.cols - 1) / p.cols;
  return blocks * p.cols * far;
}

// Launch a group kernel of G = g lanes a column, its near or far instance
// by `plan`.  Each instance takes (args..., stride, scratch, far):
// `scratch` the far segments (`far` floats a column, scratch_floats of
// them in all; unused by the near instance, which gets nullptr).
template <typename Near, typename Far, typename... Args>
cudaError_t launch(Near near_kernel, Far far_kernel, int g, int all, int sys,
                   int far, float* scratch, int ncol, cudaStream_t stream,
                   Args... args) {
  Plan p;
  cudaError_t err = plan(g, all, sys, &p);
  if (err != cudaSuccess) return err;
  if (p.far && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)p.cols * p.stride;
  const int blocks = (ncol + p.cols - 1) / p.cols;
  // all of the SM's unified memory as shared memory, so that as many
  // blocks as it holds run at once (the near instances keep nothing in L1)
  if (p.far) {
    err = cudaFuncSetAttribute(
        far_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    far_kernel<<<blocks, p.cols * g, smem, stream>>>(args..., p.stride,
                                                     scratch, far);
  } else {
    err = cudaFuncSetAttribute(
        near_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(near_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    near_kernel<<<blocks, p.cols * g, smem, stream>>>(
        args..., p.stride, static_cast<float*>(nullptr), 0);
  }
  return cudaGetLastError();
}

}  // namespace sbdart_group
