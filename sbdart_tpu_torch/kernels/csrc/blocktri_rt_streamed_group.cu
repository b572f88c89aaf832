// B6 forward on the elimination core (group_solve.cuh): the forward
// elimination of the rank-N factor history, a group of lanes per column,
// N a run-time argument (B6 backward is blocktri_rt_bwd.cu).
//
// Replaces the TPU kernel sbdart_tpu/pallas/blocktri.py:
// _rt_fwd_chunk_kernel; the arithmetic is that of
// blocktri_rt_streamed.cuh (the one-thread kernel) and of the plain torch
// version in kernels/blocktri_rt_streamed.py, per layer l:
//   dt_l = diag_l - [(lt_l C_{l-1}) ub_{l-1}; 0], solve
//   dt_l [C_l | y_l] = [I_bottom | r_l - [lt_l y_{l-1}; 0]]
// with ub_{l-1} = -[gp_l, gm_l e_l] and lt_l = -[gm_{l-1} e_{l-1}, gp_{l-1}],
// which is ub_{l-2} with its two halves swapped: each layer forms its ub
// once in shared memory and the next layer reads it as its lt.
//
// What bounds it on Hopper: the layer recursion is sequential and one
// column's work per layer is a 2N x (3N + 1) pivoted elimination with
// 2N steps, so the time is the latency of that chain.  The one-thread
// kernel held the system in local memory (255 registers and 2640 B of
// spill stores at N = 8) and ran each step's row updates one after the
// other in one thread; here G lanes (8, 16 or 32 by 2N) share it in
// shared memory, one row a lane, so a step is a shuffle reduction for
// the pivot and one row update per lane; at N = 8, 6144 columns are 3072
// warps.  Past the shared memory of one column (N = 52 on an H100) the
// kernel's far instance keeps only the system there (group_solve.cuh,
// "Placement").  A block holds 8 columns and moves each layer's operands
// into shared memory (cp.async) and its results out together, a warp's
// accesses whole 32-byte sectors of the column-minor planes.  Bytes:
// (2N^2 + 3N) floats read and (2N^2 + 2N) written a layer and column.
//
// Per layer, each element is computed by one lane, every sum over a block
// index in order as in the plain version; built with IEEE division and
// --fmad=false.

#include "group_solve.cuh"

namespace {

using sbdart_group::Block;
using sbdart_group::column_stride;
using sbdart_group::for_each;
using sbdart_group::group_size;
using sbdart_group::pad4;
using sbdart_group::row_stride;
using sbdart_group::Segments;
using sbdart_group::stage_wait;
using sbdart_group::surface_row;

// Offsets (floats) in one column's segments of the forward kernel, each
// 16-byte aligned: [A | I | r] (2N rows, 3N+1 columns, padded), the carry
// [C | y] column-major (N+1 columns of 2N, padded), lt_l (N rows of 2N,
// padded), ub_{l-1} transposed (2N rows of N, padded), lt C (N rows of N,
// padded), 2N ints of pivot rows, the surface operator R (N x N), the
// bounds of surface_row (N row sums of |R|, 2N column sums of
// |[gm e, gp]|), and the layer's gp, gm (N x N), ee (N), r (2N).  All in
// shared memory (near), or (far) the system and the pivot rows there and
// the rest in the column's device scratch.
struct FwdLayout {
  int m, w, aw, mp, np, a, cy, lt, ubt, tt, piv, rf, rs, gs, in, near, far;
  __host__ __device__ FwdLayout(int n, bool f)
      : m(2 * n), w(3 * n + 1), aw(row_stride(3 * n + 1)), mp(pad4(2 * n)),
        np(pad4(n)) {
    Segments g;
    a = g.put(false, m * aw);
    cy = g.put(f, (n + 1) * mp);
    lt = g.put(f, n * mp);
    ubt = g.put(f, m * np);
    tt = g.put(f, n * np);
    piv = g.put(false, pad4(m));
    rf = g.put(f, pad4(n * n));
    rs = g.put(f, pad4(n));
    gs = g.put(f, pad4(m));
    in = g.put(f, pad4(2 * n * n + 3 * n));
    near = g.near;
    far = g.far;
  }
};

template <bool kFar>
__global__ void __launch_bounds__(256, 3) blocktri_rt_fwd_group_kernel(
    const float* __restrict__ gp,     // [L, N, N, B]
    const float* __restrict__ gm,     // [L, N, N, B]
    const float* __restrict__ ee,     // [L, N, B]
    const float* __restrict__ refl,   // [N, N, B]
    const float* __restrict__ rhs,    // [L, 2N, B]
    float* __restrict__ cs,           // [L, 2N, N, B]
    float* __restrict__ ys,           // [L, 2N, B]
    int nlyr, int n, int ncol, int stride,
    float* far, int far_stride) {   // far segments (the far instance)
  extern __shared__ __align__(16) float smem[];
  const FwdLayout lay(n, kFar);
  const int m = lay.m, w = lay.w, aw = lay.aw, mp = lay.mp, np = lay.np;
  const int g = group_size(m);
  const int lane = threadIdx.x & (g - 1);
  const Block bk(g, ncol, stride);
  float* base = smem + (threadIdx.x / g) * stride;
  // the far segments of the block's columns, and this column's
  float* fblock = kFar ? far + (long long)blockIdx.x * bk.cols * far_stride
                       : smem;
  const int fstride = kFar ? far_stride : stride;
  float* fbase = fblock + (threadIdx.x / g) * fstride;
  float* a = base + lay.a;
  float* cy = fbase + lay.cy;   // column t of [C | y] at cy + t * mp
  float* lt = fbase + lay.lt;   // row i of lt_l at lt + i * mp
  float* ubt = fbase + lay.ubt;   // column c of ub_{l-1} at ubt + c * np
  float* tt = fbase + lay.tt;   // row i of lt_l C_{l-1} at tt + i * np
  int* piv = reinterpret_cast<int*>(base + lay.piv);
  const float* rf = fbase + lay.rf;
  float* rsum = fbase + lay.rs;
  float* gsum = fbase + lay.gs;
  const float* gpl = fbase + lay.in;
  const float* gml = gpl + n * n;
  const float* eel = gml + n * n;
  const float* rl = eel + n;
  auto stage = [&](int off, const float* src, long long first, int count) {
    bk.stage_into<!kFar>(fblock, fstride, off, src, first, count);
  };
  auto fetch = [&](int l) {
    stage(lay.in, gp, (long long)l * n * n, n * n);
    stage(lay.in + n * n, gm, (long long)l * n * n, n * n);
    stage(lay.in + 2 * n * n, ee, (long long)l * n, n);
    stage(lay.in + 2 * n * n + n, rhs, (long long)l * m, m);
  };
  // the next layer's lt, -s [gm_l e_l, gp_l], from this layer's operands
  auto next_lt = [&](float sgn) {
    for_each(n, m, lane, g, [&](int i, int k) {
      lt[i * mp + k] = k < n ? sgn * (gml[i * n + k] * eel[k])
                             : sgn * gpl[i * n + k - n];
    });
  };

  fetch(0);
  stage(lay.rf, refl, 0, n * n);
  for (int e = lane; e < (n + 1) * mp; e += g) cy[e] = 0.0f;
  stage_wait();
  for (int i = lane; i < n; i += g) {
    float t = fabsf(rf[i * n]);
    for (int q = 1; q < n; ++q) t = t + fabsf(rf[i * n + q]);
    rsum[i] = t;
  }
  next_lt(-0.0f);   // layer 0's: the plain version's neg_low = -0
  __syncwarp();

  for (int l = 0; l < nlyr; ++l) {
    if (l > 0) {
      fetch(l);
      stage_wait();
    }
    // ub_{l-1} = -[gp_l, gm_l e_l], transposed
    for_each(m, n, lane, g, [&](int c, int q) {
      ubt[c * np + q] =
          c < n ? -gpl[q * n + c] : -(gml[q * n + c - n] * eel[c - n]);
    });
    for_each(n, n, lane, g, [&](int i, int q) {   // lt_l C_{l-1}
      tt[i * np + q] = sbdart_group::dot(lt + i * mp, cy + q * mp, m);
    });
    for (int c = lane; c < m; c += g) {   // bounds of the surface rows
      float t;
      if (c < n) {
        t = fabsf(gml[c] * eel[c]);
        for (int q = 1; q < n; ++q) t = t + fabsf(gml[q * n + c] * eel[c]);
      } else {
        t = fabsf(gpl[c - n]);
        for (int q = 1; q < n; ++q) t = t + fabsf(gpl[q * n + c - n]);
      }
      gsum[c] = t;
    }
    __syncwarp();
    const float last = (l == nlyr - 1) ? 1.0f : 0.0f;
    // top rows of dt: d_top - (lt C) ub
    for_each(n, m, lane, g, [&](int i, int c) {
      const float s = sbdart_group::dot(tt + i * np, ubt + c * np, n);
      const float d =
          c < n ? gml[i * n + c] : gpl[i * n + c - n] * eel[c - n];
      a[i * aw + c] = d - s;
    });
    // bottom rows of dt: d_bot - last R [gm e, gp]
    for_each(n, m, lane, g, [&](int i, int c) {
      const float* ri = rf + i * n;
      a[(n + i) * aw + c] =
          c < n ? surface_row(gpl[i * n + c] * eel[c], last, ri, rsum[i],
                              gsum[c], n,
                              [&](int q) { return gml[q * n + c] * eel[c]; })
                : surface_row(gml[i * n + c - n], last, ri, rsum[i], gsum[c],
                              n, [&](int q) { return gpl[q * n + c - n]; });
    });
    // the columns of dt^-1 to solve for: the bottom rows of the identity
    for_each(m, n, lane, g, [&](int i, int j) {
      a[i * aw + m + j] = (i == n + j) ? 1.0f : 0.0f;
    });
    for (int i = lane; i < m; i += g) {   // r_l - [lt_l y_{l-1}; 0]
      float v = rl[i];
      if (i < n) v = v - sbdart_group::dot(lt + i * mp, cy + n * mp, m);
      a[i * aw + w - 1] = v;
    }
    __syncwarp();
    next_lt(-1.0f);   // lt_l is read no more
    sbdart_group::solve(a, aw, w, m, cy, mp, piv, lane, g);
    __syncthreads();
    bk.store_from(cs, (long long)l * m * n, m, n, fblock, fstride, lay.cy, 1,
                  mp);
    bk.store_from(ys, (long long)l * m, m, 1, fblock, fstride,
                  lay.cy + n * mp, 1);
    __syncthreads();
  }
}

}  // namespace

// Shared-memory bytes one column of the kernel takes: kind 0 with every
// region there, 2 the far instance's (the system alone).
extern "C" int sbdart_blocktri_rt_streamed_group_bytes(int kind, int n) {
  return static_cast<int>(sizeof(float)) *
         column_stride(FwdLayout(n, kind == 2).near, group_size(2 * n));
}

// Floats of device scratch B6 forward's launch over ncol columns needs (0
// where one column fits in shared memory).
extern "C" long long sbdart_blocktri_rt_fwd_group_scratch(int n, int ncol) {
  if (n < 1) return 0;
  return sbdart_group::scratch_floats(group_size(2 * n),
                                      FwdLayout(n, false).near,
                                      FwdLayout(n, true).near,
                                      FwdLayout(n, true).far, ncol);
}

extern "C" int sbdart_blocktri_rt_fwd_group(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* cs, float* ys, float* scratch, int nlyr, int n,
    int ncol, cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(sbdart_group::launch(
      blocktri_rt_fwd_group_kernel<false>, blocktri_rt_fwd_group_kernel<true>,
      group_size(2 * n), FwdLayout(n, false).near, FwdLayout(n, true).near,
      FwdLayout(n, true).far, scratch, ncol, stream, gp, gm, ee, refl, rhs, cs,
      ys, nlyr, n, ncol));
}
