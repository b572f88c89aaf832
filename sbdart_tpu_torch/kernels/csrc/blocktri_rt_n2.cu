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
// the column count.  Per layer a thread reads 14 floats of its own layer
// and of each neighbour (G+-, ee) plus 4 of rhs, writes 20 (W, y), and
// the backward sweep reads those 20 back and writes 4: device-memory
// traffic and load latency, not arithmetic (~500 flops a layer), set the
// time.  The design keeps the 4x9 augmented system and the running W, y
// in registers; W and y go to a global scratch tensor the wrapper
// allocates ([L, 16, B] and [L, 4, B]), laid out column-minor so that a
// warp's 32 threads touch 32 consecutive floats in every access.
//
// Numerics: operation order follows the plain torch version
// (sbdart_tpu_torch/kernels/blocktri_n2.py) term by term; built with IEEE
// division and --fmad=false, so no multiply-add is contracted.

#include <cuda_runtime.h>

namespace {

struct LayerMats {
  float gp[2][2], gm[2][2], gpe[2][2], gme[2][2];
};

__device__ __forceinline__ void load_layer(
    const float* __restrict__ gp, const float* __restrict__ gm,
    const float* __restrict__ ee, long long l, long long B, int col,
    LayerMats& m) {
  const float e[2] = {ee[(l * 2 + 0) * B + col], ee[(l * 2 + 1) * B + col]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m.gp[i][j] = gp[(l * 4 + 2 * i + j) * B + col];
      m.gm[i][j] = gm[(l * 4 + 2 * i + j) * B + col];
      m.gpe[i][j] = m.gp[i][j] * e[j];
      m.gme[i][j] = m.gm[i][j] * e[j];
    }
  }
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
    float pv = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) pv = pv + (sel[i] ? a[k][i] : 0.0f);
    const float inv = 1.0f / pv;
    float fac[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      fac[i] = (sel[i] || elim[i]) ? 0.0f : a[k][i] * inv;
#pragma unroll
    for (int c = k + 1; c < 9; ++c) {
      float rp = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) rp = rp + (sel[i] ? a[c][i] : 0.0f);
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

__global__ void blocktri_rt_n2_kernel(
    const float* __restrict__ gp,     // [L, 4, B]  G+ entries 11, 12, 21, 22
    const float* __restrict__ gm,     // [L, 4, B]  G-
    const float* __restrict__ ee,     // [L, 2, B]
    const float* __restrict__ refl,   // [4, B]     surface operator R
    const float* __restrict__ rhs,    // [L, 4, B]
    float* __restrict__ ws,           // [L, 16, B] scratch: W history
    float* __restrict__ ys,           // [L, 4, B]  scratch: y history
    float* __restrict__ xs,           // [L, 4, B]
    int nlyr, int ncol) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const long long B = ncol;
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

  for (int l = 0; l < nlyr; ++l) {
    LayerMats cur, low, up;
    load_layer(gp, gm, ee, l, B, col, cur);
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
    load_layer(gp, gm, ee, l > 0 ? l - 1 : 0, B, col, low);
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
      a[8][i] = rhs[((long long)l * 4 + i) * B + col];
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
    load_layer(gp, gm, ee, l < nlyr - 1 ? l + 1 : nlyr - 1, B, col, up);
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
        ws[((long long)l * 16 + 4 * i + j) * B + col] = x[i][j];
      }
      y_prev[i] = x[i][4];
      ys[((long long)l * 4 + i) * B + col] = x[i][4];
    }
  }

  float x_next[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x_next[i] = y_prev[i];
    xs[((long long)(nlyr - 1) * 4 + i) * B + col] = y_prev[i];
  }
  for (int l = nlyr - 2; l >= 0; --l) {
    float x_l[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float s = ws[((long long)l * 16 + 4 * r) * B + col] * x_next[0];
#pragma unroll
      for (int j = 1; j < 4; ++j)
        s = s + ws[((long long)l * 16 + 4 * r + j) * B + col] * x_next[j];
      x_l[r] = ys[((long long)l * 4 + r) * B + col] - s;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x_next[r] = x_l[r];
      xs[((long long)l * 4 + r) * B + col] = x_l[r];
    }
  }
}

}  // namespace

extern "C" int sbdart_blocktri_rt_n2(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* ws, float* ys, float* xs, int nlyr, int ncol,
    cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  const int threads = 128;
  const int blocks = (ncol + threads - 1) / threads;
  blocktri_rt_n2_kernel<<<blocks, threads, 0, stream>>>(
      gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol);
  return static_cast<int>(cudaGetLastError());
}
