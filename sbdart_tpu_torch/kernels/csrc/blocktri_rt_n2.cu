// Fused SETMTX + SOLVE0 for nstr=4 (n = 2): the boundary-value solve of
// one column, block-Thomas over the layers, one thread per column.
//
// Replaces the TPU kernel sbdart_tpu/pallas/blocktri.py:_rt_kernel_planar
// (with its pivoted solve _planar_solve4).  The 4x4 diagonal, lower and
// upper blocks of the block-tridiagonal system are assembled on the fly
// from G+-, the per-mode transmissions ee and the Lambertian surface
// operator; the forward sweep solves D' [W | y] = [U | r] for every layer
// with shrinking Gaussian elimination whose pivot is the first row of
// maximal |leading entry| among the rows not yet eliminated (eliminated
// rows score -1), and stores the full W history; the backward sweep
// recovers the layer coefficients x_l = y_l - W_l x_{l+1}.
//
// What bounds it on Hopper: the layer recursion is sequential, so one
// thread carries a column through all L layers and the parallelism is
// the column count (the 4x9 system fits in registers; a lane group lost
// to one thread at n = 2 in B5).  Per layer and column the kernel reads
// 14 floats of the layer's own (G+-, ee, rhs), writes 20 (W, y), and the
// backward sweep reads those 20 back and writes 4: 58 floats, 376 MB at
// 33 layers x 49152 columns, 0.112 ms at 3.35 TB/s (the work's own bytes,
// without the history, are 18).  So device-memory traffic and its
// latency set the time, not the ~500 flops a layer.
//
// Design: each layer's 14 input floats are read from device memory once.
// A warp stages them for its 32 columns into a ring of four layer slots
// in shared memory with 16-byte cp.async (a row of a block's 128 columns
// is 512 contiguous bytes), issued while layer l computes for layer
// l + 4, three layers before it is first read (as layer l + 3's upper
// block).  Layer l reads only layer l + 1's slot: it forms that layer's
// gpe and gme once and keeps them in registers, where layer l + 1 finds
// them as its own and layer l + 2 as its lower block.  W and y go to a
// global scratch tensor the wrapper allocates ([L, 16, B] and [L, 4, B],
// column-minor: a warp's 32 threads touch 32 consecutive floats); the
// backward sweep keeps three layers' 20 floats in flight in registers:
// layer l - 3's are loaded while layer l computes.
//
// Numerics: operation order follows the plain torch version
// (sbdart_tpu_torch/kernels/blocktri_n2.py) term by term; built with IEEE
// division and --fmad=false, so no multiply-add is contracted.

#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

constexpr int kCols = 128;   // columns (threads) a block
constexpr int kSlots = 4;    // layers in the ring
constexpr int kRows = 14;    // a layer's floats: gp 4, gm 4, ee 2, rhs 4
constexpr int kAhead = 3;    // layers of history in flight (backward)

// One layer's blocks and right-hand side as the recursion reads them.
struct LayerMats {
  float gp[2][2], gm[2][2], gpe[2][2], gme[2][2], r[4];
};

// Start copying layer l's 14 rows of the warp's 32 columns into `slot`
// (row e, column c at slot[e * kCols + c]): 16 bytes a copy where the
// planes allow it (vec), else each thread its own column's 14 floats.
__device__ __forceinline__ void stage_layer(
    float* slot, const float* __restrict__ gp, const float* __restrict__ gm,
    const float* __restrict__ ee, const float* __restrict__ rhs, long long l,
    long long B, int ncol, int wcol0, int lane, bool vec) {
  auto plane = [&](int e) {
    return e < 4 ? gp + (l * 4 + e) * B
                 : e < 8 ? gm + (l * 4 + e - 4) * B
                         : e < 10 ? ee + (l * 2 + e - 8) * B
                                  : rhs + (l * 4 + e - 10) * B;
  };
  const int c0 = wcol0 % kCols;   // the warp's first column in the slot
  if (vec) {
    for (int i = lane; i < kRows * 8; i += 32) {
      const int e = i >> 3, q = (i & 7) * 4;
      if (wcol0 + q < ncol)
        sbdart_ring::copy16(slot + e * kCols + c0 + q, plane(e) + wcol0 + q);
    }
  } else {
    const int col = min(wcol0 + lane, ncol - 1);
#pragma unroll
    for (int e = 0; e < kRows; ++e)
      sbdart_ring::copy4(slot + e * kCols + c0 + lane, plane(e) + col);
  }
}

// A staged layer's blocks, gpe and gme formed once.
__device__ __forceinline__ void read_layer(const float* slot, int c,
                                           LayerMats& m) {
  const float e[2] = {slot[8 * kCols + c], slot[9 * kCols + c]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m.gp[i][j] = slot[(2 * i + j) * kCols + c];
      m.gm[i][j] = slot[(4 + 2 * i + j) * kCols + c];
      m.gpe[i][j] = m.gp[i][j] * e[j];
      m.gme[i][j] = m.gm[i][j] * e[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m.r[i] = slot[(10 + i) * kCols + c];
}

// Pivoted shrinking elimination of the 4x4 system `a[0..3]` (columns) with
// five right-hand-side columns a[4..8]; returns x[row][rhs column].
__device__ __forceinline__ void solve4(float a[9][4], float x[4][5]) {
  bool elim[4] = {false, false, false, false};
  float pvs[4];
  float tail[4][8];   // tail[k][c - k - 1]: pivot row k at columns c > k
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float cand[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cand[i] = elim[i] ? -1.0f : fabsf(a[k][i]);
    const float mx = fmaxf(fmaxf(cand[0], cand[1]), fmaxf(cand[2], cand[3]));
    bool sel[4];
    bool taken = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sel[i] = (cand[i] == mx) && !taken;
      taken = taken || sel[i];
    }
    // the pivot row's entry of a column: the plain version sums the
    // selected entry and three zeros from 0, which is that entry + 0 (-0
    // turns +0; 0 where no row is selected)
    auto pick = [&](const float (&col)[4]) {
      return (sel[0] ? col[0] : sel[1] ? col[1] : sel[2] ? col[2]
              : sel[3] ? col[3] : 0.0f) + 0.0f;
    };
    const float pv = pick(a[k]);
    const float inv = 1.0f / pv;
    float fac[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      fac[i] = (sel[i] || elim[i]) ? 0.0f : a[k][i] * inv;
#pragma unroll
    for (int c = k + 1; c < 9; ++c) {
      const float rp = pick(a[c]);
      tail[k][c - k - 1] = rp;
#pragma unroll
      for (int i = 0; i < 4; ++i) a[c][i] = a[c][i] - fac[i] * rp;
    }
    pvs[k] = pv;
#pragma unroll
    for (int i = 0; i < 4; ++i) elim[i] = elim[i] || sel[i];
  }
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    float s[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) s[t] = tail[i][3 - i + t];
#pragma unroll
    for (int j = i + 1; j < 4; ++j) {
      const float aij = tail[i][j - i - 1];
#pragma unroll
      for (int t = 0; t < 5; ++t) s[t] = s[t] - aij * x[j][t];
    }
#pragma unroll
    for (int t = 0; t < 5; ++t) x[i][t] = s[t] / pvs[i];
  }
}

__global__ void __launch_bounds__(kCols) blocktri_rt_n2_kernel(
    const float* __restrict__ gp,     // [L, 4, B]  G+ entries 11, 12, 21, 22
    const float* __restrict__ gm,     // [L, 4, B]  G-
    const float* __restrict__ ee,     // [L, 2, B]
    const float* __restrict__ refl,   // [4, B]     surface operator R
    const float* __restrict__ rhs,    // [L, 4, B]
    float* __restrict__ ws,           // [L, 16, B] scratch: W history
    float* __restrict__ ys,           // [L, 4, B]  scratch: y history
    float* __restrict__ xs,           // [L, 4, B]
    int nlyr, int ncol, int vec) {
  __shared__ __align__(16) float ring[kSlots][kRows * kCols];
  const int c = threadIdx.x, lane = c & 31;
  const int wcol0 = blockIdx.x * kCols + (c & ~31);
  const int col0 = blockIdx.x * kCols + c;
  // a thread past the last column stages for its warp and stores nothing
  const bool live = col0 < ncol;
  const int col = min(col0, ncol - 1);
  const long long B = ncol;
  auto stage = [&](int l) {
    if (l < nlyr)
      stage_layer(ring[l % kSlots], gp, gm, ee, rhs, l, B, ncol, wcol0, lane,
                  vec);
    sbdart_ring::commit();
  };
  for (int l = 0; l < kSlots; ++l) stage(l);

  float rmat[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) rmat[i][j] = refl[(2 * i + j) * B + col];

  float w_prev[4][4], y_prev[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    y_prev[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) w_prev[i][j] = 0.0f;
  }

  LayerMats low, cur, up;
  sbdart_ring::wait<kSlots - 1>();
  __syncwarp();
  read_layer(ring[0], c, cur);
  low = cur;   // layer 0's lower block is layer 0's, times -0

  for (int l = 0; l < nlyr; ++l) {
    // layers up to l + 1 have landed; the slot of layer l (read as the
    // upper block of layer l - 1) takes layer l + 4
    sbdart_ring::wait<kSlots - 2>();
    __syncwarp();
    stage(l + kSlots);
    if (l + 1 < nlyr)
      read_layer(ring[(l + 1) % kSlots], c, up);
    else
      up = cur;   // the last layer's upper block is its own, times -0
    const float last = (l == nlyr - 1) ? 1.0f : 0.0f;
    float d[4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        d[i][j] = cur.gm[i][j];
        d[i][2 + j] = cur.gpe[i][j];
        const float rg_me = rmat[i][0] * cur.gme[0][j] + rmat[i][1] * cur.gme[1][j];
        const float rg_p = rmat[i][0] * cur.gp[0][j] + rmat[i][1] * cur.gp[1][j];
        d[2 + i][j] = cur.gpe[i][j] - last * rg_me;
        d[2 + i][2 + j] = cur.gm[i][j] - last * rg_p;
      }
    }

    // lower block rows (from layer l - 1)
    const float neg_low = -((l > 0) ? 1.0f : 0.0f);
    float lt[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        lt[i][j] = neg_low * low.gme[i][j];
        lt[i][2 + j] = neg_low * low.gp[i][j];
      }
    }

    // augmented system: columns 0..3 of D', then U's four columns and r
    float a[9][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[8][i] = cur.r[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j][i] = d[i][j];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float corr_r = lt[i][0] * y_prev[0];
#pragma unroll
      for (int q = 1; q < 4; ++q) corr_r = corr_r + lt[i][q] * y_prev[q];
      a[8][i] = a[8][i] - corr_r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float corr = lt[i][0] * w_prev[0][j];
#pragma unroll
        for (int q = 1; q < 4; ++q) corr = corr + lt[i][q] * w_prev[q][j];
        a[j][i] = a[j][i] - corr;
      }
    }

    // upper block (bottom rows, from layer l + 1)
    const float neg_up = -((l < nlyr - 1) ? 1.0f : 0.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[4 + j][0] = 0.0f;
      a[4 + j][1] = 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        a[4 + j][2 + i] =
            j < 2 ? neg_up * up.gp[i][j] : neg_up * up.gme[i][j - 2];
    }

    float x[4][5];
    solve4(a, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w_prev[i][j] = x[i][j];
        if (live) ws[((long long)l * 16 + 4 * i + j) * B + col] = x[i][j];
      }
      y_prev[i] = x[i][4];
      if (live) ys[((long long)l * 4 + i) * B + col] = x[i][4];
    }
    low = cur;
    cur = up;
  }
  if (!live) return;

  float x_next[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x_next[i] = y_prev[i];
    xs[((long long)(nlyr - 1) * 4 + i) * B + col] = y_prev[i];
  }
  // the history of layers l, l - 1, l - 2 in registers: a layer's 20
  // floats are loaded three layers before they are used
  float hist[kAhead][20];
  auto load = [&](float (&h)[20], long long l) {
#pragma unroll
    for (int e = 0; e < 16; ++e) h[e] = ws[(l * 16 + e) * B + col];
#pragma unroll
    for (int r = 0; r < 4; ++r) h[16 + r] = ys[(l * 4 + r) * B + col];
  };
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    if (nlyr - 2 - k >= 0) load(hist[k], nlyr - 2 - k);
  for (int l0 = nlyr - 2; l0 >= 0; l0 -= kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int l = l0 - k;
      if (l < 0) break;
      float x_l[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float s = hist[k][4 * r] * x_next[0];
#pragma unroll
        for (int j = 1; j < 4; ++j) s = s + hist[k][4 * r + j] * x_next[j];
        x_l[r] = hist[k][16 + r] - s;
      }
      if (l - kAhead >= 0) load(hist[k], l - kAhead);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        x_next[r] = x_l[r];
        xs[((long long)l * 4 + r) * B + col] = x_l[r];
      }
    }
  }
}

}  // namespace

extern "C" int sbdart_blocktri_rt_n2(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* ws, float* ys, float* xs, int nlyr, int ncol,
    cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  const int blocks = (ncol + kCols - 1) / kCols;
  const bool vec = ncol % 4 == 0 && sbdart_ring::aligned16({gp, gm, ee, rhs});
  blocktri_rt_n2_kernel<<<blocks, kCols, 0, stream>>>(
      gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
