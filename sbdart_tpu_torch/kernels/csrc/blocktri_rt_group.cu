// B5 past N = 8 on the elimination core (group_solve.cuh): fused SETMTX +
// SOLVE0 with the full W history, a group of lanes per column, N a
// run-time argument.  N = 1..8 keep the one-thread kernel of
// blocktri_rt.cuh.
//
// Replaces the TPU kernel sbdart_tpu/pallas/blocktri.py:_rt_kernel, which
// the reference runs at N > 8 only on short columns (to 33 layers at
// N = 9, 27 at N = 10, 10 at N = 16, 6 at N = 20; longer ones stream, B6).
// Per layer l, as blocktri_rt.cuh and the plain torch version
// (kernels/blocktri_rt.py:block_thomas_rt_plain):
//   dt_l = diag_l - lower_l W_{l-1}, solve
//   dt_l [W_l | y_l] = [upper_l | r_l - lower_l y_{l-1}]  (width 4N + 1)
// and store W_l, y_l in wrapper-allocated column-minor scratch
// ([L, 4N^2, B], [L, 2N, B]); then x_{L-1} = y_{L-1},
// x_l = y_l - W_l x_{l+1}.  The layer's lower block's top rows
// lt_l = -[gm_{l-1} e_{l-1}, gp_{l-1}] are staged in shared memory once.
//
// What bounds it on Hopper: as B6, the layer recursion; per layer a
// 2N x (4N + 1) elimination on G lanes (G = 32 past N = 8), and 4N^2 + 2N
// floats of history written and read back once.  A block holds 8
// columns, each 32-byte sector of the column-minor operands read by one
// block; the block moves each layer's operands in (cp.async) and its
// history out together, a warp's accesses whole 32-byte sectors.  Sums over a block index in order, IEEE
// division, --fmad=false.

#include "group_solve.cuh"

namespace {

using sbdart_group::Block;
using sbdart_group::column_stride;
using sbdart_group::for_each;
using sbdart_group::group_size;
using sbdart_group::pad4;
using sbdart_group::row_stride;
using sbdart_group::stage_wait;
using sbdart_group::surface_row;

// Offsets (floats) in one column's shared memory, each 16-byte aligned:
// [dt | upper | r] (2N rows, 4N+1 columns, padded), the carry [W | y]
// column-major (2N+1 columns of 2N, padded),
// lt (N x 2N), 2N ints of pivot rows, R (N x N), the bounds of
// surface_row (N + 2N floats), and the staged operands:
// gp, gm, ee, r of layer l and gp, gm, ee of layers l - 1 and l + 1.  The
// back sweep reuses the system's floats.
struct RtLayout {
  int m, w, aw, mp, wy, lt, piv, rf, rs, gs, cur, low, upp, floats;
  __host__ __device__ explicit RtLayout(int n)
      : m(2 * n), w(4 * n + 1), aw(row_stride(4 * n + 1)), mp(pad4(2 * n)),
        wy(2 * n * aw), lt(wy + (2 * n + 1) * mp), piv(lt + n * mp),
        rf(piv + pad4(2 * n)), rs(rf + pad4(n * n)), gs(rs + pad4(n)),
        cur(gs + pad4(2 * n)), low(cur + pad4(2 * n * n + 3 * n)),
        upp(low + pad4(2 * n * n + n)), floats(upp + 2 * n * n + n) {}
};

__global__ void __launch_bounds__(256, 3) blocktri_rt_group_kernel(
    const float* __restrict__ gp,     // [L, N, N, B]
    const float* __restrict__ gm,     // [L, N, N, B]
    const float* __restrict__ ee,     // [L, N, B]
    const float* __restrict__ refl,   // [N, N, B]
    const float* __restrict__ rhs,    // [L, 2N, B]
    float* __restrict__ ws,           // [L, 4N^2, B] scratch: W history
    float* __restrict__ ys,           // [L, 2N, B]   scratch: y history
    float* __restrict__ xs,           // [L, 2N, B]
    int nlyr, int n, int ncol, int stride) {
  extern __shared__ __align__(16) float smem[];
  const RtLayout lay(n);
  const int m = lay.m, w = lay.w, aw = lay.aw, mp = lay.mp;
  const int g = group_size(m);
  const int lane = threadIdx.x & (g - 1);
  const Block bk(g, ncol, stride);
  float* base = smem + (threadIdx.x / g) * stride;
  float* a = base;
  float* wy = base + lay.wy;   // column t of [W | y] at wy + t * mp
  float* lt = base + lay.lt;   // row i of lt at lt + i * mp
  int* piv = reinterpret_cast<int*>(base + lay.piv);
  const float* rf = base + lay.rf;
  float* rsum = base + lay.rs;
  float* gsum = base + lay.gs;
  const float* gpl = base + lay.cur;
  const float* gml = gpl + n * n;
  const float* eel = gml + n * n;
  const float* rl = eel + n;
  const float* low = base + lay.low;   // layer l - 1: gp, gm, ee
  const float* upp = base + lay.upp;   // layer l + 1: gp, gm, ee
  auto fetch = [&](int off, long long l, bool with_rhs) {
    bk.stage(smem, off, gp, l * n * n, n * n);
    bk.stage(smem, off + n * n, gm, l * n * n, n * n);
    bk.stage(smem, off + 2 * n * n, ee, l * n, n);
    if (with_rhs) bk.stage(smem, off + 2 * n * n + n, rhs, l * m, m);
  };

  bk.stage(smem, lay.rf, refl, 0, n * n);
  for (int e = lane; e < (m + 1) * mp; e += g) wy[e] = 0.0f;
  for (int l = 0; l < nlyr; ++l) {
    fetch(lay.cur, l, true);
    fetch(lay.low, l > 0 ? l - 1 : 0, false);
    fetch(lay.upp, l < nlyr - 1 ? l + 1 : nlyr - 1, false);
    stage_wait();
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
    bk.store(ws, (long long)l * m * m, m, m, smem, lay.wy, 1, mp);
    bk.store(ys, (long long)l * m, m, 1, smem, lay.wy + m * mp, 1);
    __syncthreads();
  }
  sbdart_group::back_sweep(bk, smem, 0, ws, ys, xs, nlyr, m, lane, g);
}

}  // namespace

// Shared-memory bytes one column of B5's group kernel takes.
extern "C" int sbdart_blocktri_rt_group_bytes(int n) {
  return static_cast<int>(sizeof(float)) *
         column_stride(RtLayout(n).floats, group_size(2 * n));
}

extern "C" int sbdart_blocktri_rt_group(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* ws, float* ys, float* xs, int nlyr, int n,
    int ncol, cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int stride = column_stride(RtLayout(n).floats, group_size(2 * n));
  return static_cast<int>(sbdart_group::launch(
      blocktri_rt_group_kernel, 2 * n, stride, ncol, stream, gp, gm, ee, refl,
      rhs, ws, ys, xs, nlyr, n, ncol, stride));
}
