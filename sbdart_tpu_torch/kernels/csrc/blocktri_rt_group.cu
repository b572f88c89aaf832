// B5 on the elimination core (group_solve.cuh): fused SETMTX + SOLVE0
// with the full W history, a group of lanes per column, N a run-time
// argument.  kernels/blocktri_rt.py routes every N to it except those of
// RT_ONE_THREAD_N (the one-thread kernel of blocktri_rt.cu).
//
// Replaces the TPU kernel sbdart_tpu/pallas/blocktri.py:_rt_kernel, which
// the reference runs on columns short enough for one lane tile to fit its
// VMEM (at N = 2 past its planar kernel's 51 layers; to 41 layers at N = 8,
// 33 at N = 9, 10 at N = 16; longer ones stream, B6).
// Per layer l, as the plain torch version
// (kernels/blocktri_rt.py:block_thomas_rt_plain):
//   dt_l = diag_l - lower_l W_{l-1}, solve
//   dt_l [W_l | y_l] = [upper_l | r_l - lower_l y_{l-1}]  (width 4N + 1)
// and store W_l, y_l in wrapper-allocated column-minor scratch
// ([L, 4N^2, B], [L, 2N, B]); then x_{L-1} = y_{L-1},
// x_l = y_l - W_l x_{l+1}.  The layer's lower block's top rows
// lt_l = -[gm_{l-1} e_{l-1}, gp_{l-1}] are staged once.
//
// What bounds it on Hopper: as B6, the layer recursion; per layer a
// 2N x (4N + 1) elimination on G lanes (group_size: 4, 8, 16, 32 by 2N),
// and 4N^2 + 2N floats of history written and read back once.  At the
// main path's column counts the whole launch is one wave of two or three
// warps a scheduler, so its time is one column's chain of layers, and
// the instructions of each: at N = 5 to 8 the kernel is instantiated for
// the N (its sizes, loops and index arithmetic fixed at compile time), and
// N <= 4 runs the rows instance below.  Each
// layer's operands arrive in a ring of four staged layers, the next one's
// copy (cp.async) running while this one is eliminated, and the back
// sweep fetches the next layer's W while summing this one's.  A block
// holds 8 columns (16 at G = 4), each 32-byte sector of the column-minor
// operands read by one block; the block moves operands in and history out
// together, a warp's accesses whole 32-byte sectors.  Past the shared
// memory of one column the far instance keeps only the system there
// (group_solve.cuh, "Placement").  Sums over a block index in order, IEEE
// division, --fmad=false.

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

// Offsets (floats) in one column's segments, each 16-byte aligned:
// [dt | upper | r] (2N rows, 4N+1 columns, padded), the carry [W | y]
// column-major (2N+1 columns of 2N, padded), lt (N x 2N), 2N ints of
// pivot rows, R (N x N), the bounds of surface_row (N + 2N floats), and a
// ring of four layers' staged operands (gp, gm, ee, r; `slot` floats
// each): layers l - 1, l, l + 1 in use and l + 2 arriving.  All in shared
// memory (near), or (far) the system and the pivot rows there and the
// rest in the column's device scratch.  The back sweep reuses the
// system's floats.
struct RtLayout {
  int m, w, aw, mp, a, wy, lt, piv, rf, rs, gs, ring, slot, near, far;
  __host__ __device__ RtLayout(int n, bool f)
      : m(2 * n), w(4 * n + 1), aw(row_stride(4 * n + 1)), mp(pad4(2 * n)),
        slot(pad4(2 * n * n + 3 * n)) {
    Segments g;
    a = g.put(false, m * aw);
    wy = g.put(f, (m + 1) * mp);
    lt = g.put(f, n * mp);
    piv = g.put(false, pad4(m));
    rf = g.put(f, pad4(n * n));
    rs = g.put(f, pad4(n));
    gs = g.put(f, pad4(m));
    ring = g.put(f, 4 * slot);
    near = g.near;
    far = g.far;
  }
};

// kN > 0: the instance for N = kN (5 <= N <= 8), its sizes and loops
// fixed at compile time; kN = 0: N a run-time argument (N > 8, and the
// far instance).  G = group_size(2N) lanes a column.
template <bool kFar, int kN>
__global__ void __launch_bounds__(256, 3) blocktri_rt_group_kernel(
    const float* __restrict__ gp,     // [L, N, N, B]
    const float* __restrict__ gm,     // [L, N, N, B]
    const float* __restrict__ ee,     // [L, N, B]
    const float* __restrict__ refl,   // [N, N, B]
    const float* __restrict__ rhs,    // [L, 2N, B]
    float* __restrict__ ws,           // [L, 4N^2, B] scratch: W history
    float* __restrict__ ys,           // [L, 2N, B]   scratch: y history
    float* __restrict__ xs,           // [L, 2N, B]
    int nlyr, int n_arg, int ncol, int stride,
    float* far, int far_stride) {   // far segments (the far instance)
  const int n = kN > 0 ? kN : n_arg;
  extern __shared__ __align__(16) float smem[];
  const RtLayout lay(n, kFar);
  const int m = lay.m, w = lay.w, aw = lay.aw, mp = lay.mp;
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
  float* wy = fbase + lay.wy;   // column t of [W | y] at wy + t * mp
  float* lt = fbase + lay.lt;   // row i of lt at lt + i * mp
  int* piv = reinterpret_cast<int*>(base + lay.piv);
  const float* rf = fbase + lay.rf;
  float* rsum = fbase + lay.rs;
  float* gsum = fbase + lay.gs;
  auto stage = [&](int off, const float* src, long long first, int count) {
    bk.stage_into<!kFar>(fblock, fstride, off, src, first, count);
  };
  // layer l's gp, gm, ee, r into its ring slot (l mod 4), one copy group
  auto fetch = [&](int l) {
    const int off = lay.ring + (l & 3) * lay.slot;
    stage(off, gp, (long long)l * n * n, n * n);
    stage(off + n * n, gm, (long long)l * n * n, n * n);
    stage(off + 2 * n * n, ee, (long long)l * n, n);
    stage(off + 2 * n * n + n, rhs, (long long)l * m, m);
    sbdart_group::stage_commit();
  };
  auto ring = [&](int l) { return fbase + lay.ring + (l & 3) * lay.slot; };

  stage(lay.rf, refl, 0, n * n);
  fetch(0);
  if (nlyr > 1) fetch(1);
  for (int e = lane; e < (m + 1) * mp; e += g) wy[e] = 0.0f;
  for (int l = 0; l < nlyr; ++l) {
    // layer l + 1 must have arrived; layer l + 2's copy runs meanwhile
    if (l + 2 < nlyr) {
      fetch(l + 2);
      sbdart_group::stage_wait_group<1>();
    } else {
      sbdart_group::stage_wait_group<0>();
    }
    const float* gpl = ring(l);
    const float* gml = gpl + n * n;
    const float* eel = gml + n * n;
    const float* rl = eel + n;
    const float* low = ring(l > 0 ? l - 1 : 0);   // gp, gm, ee
    const float* upp = ring(l < nlyr - 1 ? l + 1 : nlyr - 1);
    if (l == 0) {
      for (int i = lane; i < n; i += g) {
        float t = fabsf(rf[i * n]);
        for (int q = 1; q < n; ++q) t = t + fabsf(rf[i * n + q]);
        rsum[i] = t;
      }
    }
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
    const float neg_low = -((l > 0) ? 1.0f : 0.0f);
    for_each(n, m, lane, g, [&](int i, int j) {
      lt[i * mp + j] = j < n ? neg_low * (low[n * n + i * n + j] *
                                          low[2 * n * n + j])
                             : neg_low * low[i * n + j - n];
    });
    __syncwarp();
    const float last = (l == nlyr - 1) ? 1.0f : 0.0f;
    const float neg_up = -((l < nlyr - 1) ? 1.0f : 0.0f);
    // top rows of dt: diag - lower W_{l-1}
    for_each(n, m, lane, g, [&](int i, int c) {
      const int j = c < n ? c : c - n;
      const float s = sbdart_group::dot(lt + i * mp, wy + c * mp, m);
      const float d = c < n ? gml[i * n + j] : gpl[i * n + j] * eel[j];
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
    // upper block: zero top rows, bottom rows from layer l + 1
    for_each(m, m, lane, g, [&](int i, int j) {
      float v = 0.0f;
      if (i >= n) {
        const int r = i - n;
        v = j < n ? neg_up * upp[r * n + j]
                  : neg_up * (upp[n * n + r * n + j - n] * upp[2 * n * n + j - n]);
      }
      a[i * aw + m + j] = v;
    });
    for (int i = lane; i < m; i += g) {   // r_l - lower y_{l-1}
      float v = rl[i];
      if (i < n) v = v - sbdart_group::dot(lt + i * mp, wy + m * mp, m);
      a[i * aw + w - 1] = v;
    }
    __syncwarp();
    sbdart_group::solve(a, aw, w, m, wy, mp, piv, lane, g);
    __syncthreads();
    bk.store_from(ws, (long long)l * m * m, m, m, fblock, fstride, lay.wy, 1,
                  mp);
    bk.store_from(ys, (long long)l * m, m, 1, fblock, fstride,
                  lay.wy + m * mp, 1);
    __syncthreads();
  }
  sbdart_group::back_sweep(bk, smem, lay.a, m * aw, ws, ys, xs, nlyr, m, lane,
                           g);
}

// The instance for N <= 4, rows in registers.  At these N the elimination
// of the smem instance above spends its time on shared-memory and shuffle
// instructions (the MIO pipe, shared by the column's lanes and the SM's
// warps) rather than on arithmetic; here lane i holds row i of
// dt = [diag - lower W_{l-1}] in registers and each lane one or two of the
// 2N + 1 right-hand columns [upper | r - lower y_{l-1}] (column t on lane
// t mod G), so a step moves the pivot row's left part and the rows'
// multipliers by shuffle and nothing through shared memory; each lane
// back-substitutes its own columns against the pivot rows it kept.  Only
// W goes through shared memory, once a layer, for the next layer's top
// rows.  The operations and their order are those of the smem instance
// (and of the plain version).
struct RowsLayout {   // offsets in floats; the back sweep reuses the ring
  int slot, ring, rf, wy, floats;
  __host__ __device__ explicit RowsLayout(int n)
      : slot(pad4(2 * n * n + 3 * n)), ring(0), rf(4 * slot),
        wy(rf + pad4(n * n)), floats(wy + 2 * n * pad4(2 * n)) {}
};

template <int N>
__global__ void __launch_bounds__(256, 3) blocktri_rt_group_kernel_rows(
    const float* __restrict__ gp,     // [L, N, N, B]
    const float* __restrict__ gm,     // [L, N, N, B]
    const float* __restrict__ ee,     // [L, N, B]
    const float* __restrict__ refl,   // [N, N, B]
    const float* __restrict__ rhs,    // [L, 2N, B]
    float* __restrict__ ws,           // [L, 4N^2, B] scratch: W history
    float* __restrict__ ys,           // [L, 2N, B]   scratch: y history
    float* __restrict__ xs,           // [L, 2N, B]
    int nlyr, int, int ncol, int stride, float*, int) {
  constexpr int m = 2 * N, R = m + 1, mp = (m + 3) & ~3;
  constexpr int G = m <= 4 ? 4 : 8;
  extern __shared__ __align__(16) float smem[];
  const RowsLayout lay(N);
  const int lane = threadIdx.x & (G - 1);
  const Block bk(G, ncol, stride);
  float* base = smem + (threadIdx.x / G) * stride;
  const long long col = bk.col0 + threadIdx.x / G;
  const bool real = col < ncol;
  const long long B = ncol;
  const int ta = lane, tb = lane + G;   // this lane's right-hand columns
  const bool has_a = ta < R, has_b = tb < R;
  float* wy = base + lay.wy;            // column c of W at wy + c * mp
  const float* rf = base + lay.rf;
  auto ring = [&](int l) { return base + lay.ring + (l & 3) * lay.slot; };
  auto fetch = [&](int l) {
    const int off = lay.ring + (l & 3) * lay.slot;
    bk.stage(smem, off, gp, (long long)l * N * N, N * N);
    bk.stage(smem, off + N * N, gm, (long long)l * N * N, N * N);
    bk.stage(smem, off + 2 * N * N, ee, (long long)l * N, N);
    bk.stage(smem, off + 2 * N * N + N, rhs, (long long)l * m, m);
    sbdart_group::stage_commit();
  };

  bk.stage(smem, lay.rf, refl, 0, N * N);
  fetch(0);
  if (nlyr > 1) fetch(1);
  for (int e = lane; e < m * mp; e += G) wy[e] = 0.0f;
  float xa[m], xb[m];   // this lane's columns of [W | y] of the last layer
#pragma unroll
  for (int q = 0; q < m; ++q) xa[q] = xb[q] = 0.0f;
  float rs_own = 0.0f;   // a bottom row's sum of |R| (surface_row's bound)
  for (int l = 0; l < nlyr; ++l) {
    if (l + 2 < nlyr) {
      fetch(l + 2);
      sbdart_group::stage_wait_group<1>();
    } else {
      sbdart_group::stage_wait_group<0>();
    }
    const float* gpl = ring(l);
    const float* gml = gpl + N * N;
    const float* eel = gml + N * N;
    const float* rl = eel + N;
    const float* low = ring(l > 0 ? l - 1 : 0);   // gp, gm, ee
    const float* upp = ring(l < nlyr - 1 ? l + 1 : nlyr - 1);
    const float neg_low = -((l > 0) ? 1.0f : 0.0f);
    const float neg_up = -((l < nlyr - 1) ? 1.0f : 0.0f);
    const float last = (l == nlyr - 1) ? 1.0f : 0.0f;
    // lt_l row i, column q: -[gm_{l-1} e_{l-1}, gp_{l-1}]
    auto lt = [&](int i, int q) {
      return q < N ? neg_low * (low[N * N + i * N + q] * low[2 * N * N + q])
                   : neg_low * low[i * N + q - N];
    };
    if (l == 0 && lane >= N && lane < m) {
      const float* ri = rf + (lane - N) * N;
      rs_own = fabsf(ri[0]);
#pragma unroll
      for (int q = 1; q < N; ++q) rs_own = rs_own + fabsf(ri[q]);
    }
    // the bounds of the surface rows: column c's on lane c
    float gs_own = 0.0f;
    if (lane < m) {
      const int c = lane;
      if (c < N) {
        gs_own = fabsf(gml[c] * eel[c]);
#pragma unroll
        for (int q = 1; q < N; ++q)
          gs_own = gs_own + fabsf(gml[q * N + c] * eel[c]);
      } else {
        gs_own = fabsf(gpl[c - N]);
#pragma unroll
        for (int q = 1; q < N; ++q) gs_own = gs_own + fabsf(gpl[q * N + c - N]);
      }
    }
    float gsum[m];
#pragma unroll
    for (int c = 0; c < m; ++c) gsum[c] = __shfl_sync(sbdart_group::kFull,
                                                      gs_own, c, G);

    // ---- row i of dt -----------------------------------------------------
    float a[m];
    if (lane < N) {   // diag - lower W_{l-1}
      const int i = lane;
      float lti[m];
#pragma unroll
      for (int q = 0; q < m; ++q) lti[q] = lt(i, q);
#pragma unroll
      for (int c = 0; c < m; ++c) {
        const float* wc = wy + c * mp;
        float s = lti[0] * wc[0];
#pragma unroll
        for (int q = 1; q < m; ++q) s = s + lti[q] * wc[q];
        const int j = c < N ? c : c - N;
        const float d = c < N ? gml[i * N + j] : gpl[i * N + j] * eel[j];
        a[c] = d - s;
      }
    } else if (lane < m) {   // d_bot - last R [gm e, gp]
      const int r = lane - N;
      const float* ri = rf + r * N;
#pragma unroll
      for (int c = 0; c < m; ++c) {
        a[c] = c < N ? surface_row(gpl[r * N + c] * eel[c], last, ri, rs_own,
                                   gsum[c], N,
                                   [&](int q) { return gml[q * N + c] * eel[c]; })
                     : surface_row(gml[r * N + c - N], last, ri, rs_own,
                                   gsum[c], N,
                                   [&](int q) { return gpl[q * N + c - N]; });
      }
    } else {
#pragma unroll
      for (int c = 0; c < m; ++c) a[c] = 0.0f;
    }
    // ---- this lane's right-hand columns ----------------------------------
    auto rhs_col = [&](int t, float (&x)[m], float (&v)[m]) {
#pragma unroll
      for (int i = 0; i < m; ++i) {
        if (t < m) {   // upper: zero top rows, bottom rows from layer l + 1
          const int j = t;
          const int r = i - N;
          v[i] = i < N ? 0.0f
                 : j < N ? neg_up * upp[r * N + j]
                         : neg_up * (upp[N * N + r * N + j - N] *
                                     upp[2 * N * N + j - N]);
        } else {       // r_l - lower y_{l-1}
          float u = rl[i];
          if (i < N) {
            float s = lt(i, 0) * x[0];
#pragma unroll
            for (int q = 1; q < m; ++q) s = s + lt(i, q) * x[q];
            u = u - s;
          }
          v[i] = u;
        }
      }
    };
    float va[m], vb[m];
#pragma unroll
    for (int i = 0; i < m; ++i) va[i] = vb[i] = 0.0f;
    if (has_a) rhs_col(ta, xa, va);
    if (has_b) rhs_col(tb, xb, vb);

    // ---- elimination: solve_step's steps, rows by lane -------------------
    sbdart_group::solve_rows_cols<m, G>(a, va, vb, lane, has_b, xa, xb);
    // ---- W for the next layer's top rows, and the history ----------------
    __syncwarp();
    auto put = [&](int t, const float (&x)[m]) {
      if (t < m) {
#pragma unroll
        for (int q = 0; q < m; ++q) wy[t * mp + q] = x[q];
        if (real) {
#pragma unroll
          for (int q = 0; q < m; ++q)
            ws[((long long)l * m * m + q * m + t) * B + col] = x[q];
        }
      } else if (real) {
#pragma unroll
        for (int q = 0; q < m; ++q) ys[((long long)l * m + q) * B + col] = x[q];
      }
    };
    if (has_a) put(ta, xa);
    if (has_b) put(tb, xb);
    __syncthreads();
  }
  sbdart_group::back_sweep(bk, smem, lay.ring, 4 * lay.slot, ws, ys, xs, nlyr,
                           m, lane, G);
}

}  // namespace

// Shared-memory bytes one column of B5's group kernel takes with every
// region there (far = 0), or with the system alone (far = 1).
extern "C" int sbdart_blocktri_rt_group_bytes(int n, int far) {
  const RtLayout lay(n, far != 0);
  return static_cast<int>(sizeof(float)) *
         column_stride(lay.near, group_size(2 * n));
}

// Floats of device scratch a launch over ncol columns needs (0 where one
// column fits in shared memory).
extern "C" long long sbdart_blocktri_rt_group_scratch(int n, int ncol) {
  if (n < 1) return 0;
  return sbdart_group::scratch_floats(group_size(2 * n),
                                      RtLayout(n, false).near,
                                      RtLayout(n, true).near,
                                      RtLayout(n, true).far, ncol);
}

namespace {

// The launch at N = kN (0: N > 8, with the far instance beside the near
// one; a column at N <= 8 always fits in shared memory), N <= 4 on the
// rows instance.
template <int kN>
cudaError_t launch_n(const float* gp, const float* gm, const float* ee,
                     const float* refl, const float* rhs, float* ws,
                     float* ys, float* xs, float* scratch, int nlyr, int n,
                     int ncol, cudaStream_t stream) {
  if constexpr (kN > 0 && kN <= 4) {
    const int all = RowsLayout(kN).floats;
    return sbdart_group::launch(
        blocktri_rt_group_kernel_rows<kN>, blocktri_rt_group_kernel_rows<kN>,
        group_size(2 * kN), all, all, 0, nullptr, ncol, stream, gp, gm, ee,
        refl, rhs, ws, ys, xs, nlyr, n, ncol);
  } else {
    auto near_kernel = blocktri_rt_group_kernel<false, kN>;
    auto far_kernel =
        kN > 0 ? near_kernel : blocktri_rt_group_kernel<true, 0>;
    return sbdart_group::launch(
        near_kernel, far_kernel, group_size(2 * n), RtLayout(n, false).near,
        RtLayout(n, true).near, RtLayout(n, true).far, scratch, ncol, stream,
        gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, n, ncol);
  }
}

}  // namespace

extern "C" int sbdart_blocktri_rt_group(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* ws, float* ys, float* xs, float* scratch,
    int nlyr, int n, int ncol, cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (n) {
#define SBDART_RT_CASE(NN)                                                  \
  case NN:                                                                  \
    err = launch_n<NN>(gp, gm, ee, refl, rhs, ws, ys, xs, scratch, nlyr, n, \
                       ncol, stream);                                       \
    break;
    SBDART_RT_CASE(1)
    SBDART_RT_CASE(2)
    SBDART_RT_CASE(3)
    SBDART_RT_CASE(4)
    SBDART_RT_CASE(5)
    SBDART_RT_CASE(6)
    SBDART_RT_CASE(7)
    SBDART_RT_CASE(8)
#undef SBDART_RT_CASE
    default:
      err = launch_n<0>(gp, gm, ee, refl, rhs, ws, ys, xs, scratch, nlyr, n,
                        ncol, stream);
  }
  return static_cast<int>(err);
}
