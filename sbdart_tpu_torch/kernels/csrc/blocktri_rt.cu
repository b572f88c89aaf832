// B5 at small N (N = 1, 2: kernels/blocktri_rt.py:RT_ONE_THREAD_N):
// fused SETMTX + SOLVE0 for one column, block-Thomas over the layers, one
// thread per column.  At N = 2 it runs where the reference's n = 2 planar
// tile no longer fits VMEM (52 to 472 layers).
// Every other N runs the group kernel (blocktri_rt_group.cu), which
// chip_smoke.py times beside this one at each N the main path sends B5.
//
// Replaces the TPU kernel sbdart_tpu/pallas/blocktri.py:_rt_kernel (with
// _solve_step).  Per layer l the 2N x 2N blocks are assembled on the fly
// from G+-, the per-mode transmissions ee and the Lambertian surface
// operator R:
//   diag_l  = [[gm_l, gp_l e_l], [gp_l e_l, gm_l]], the last layer's
//             bottom rows less [R (gm e), R gp];
//   lower_l = -[[gm_{l-1} e, gp_{l-1}], [0, 0]]   (zero at l = 0);
//   upper_l = -[[0, 0], [gp_{l+1}, gm_{l+1} e]]   (zero at l = L-1).
// The forward sweep solves (diag - lower W_{l-1}) [W_l | y_l] =
// [upper | r_l - lower y_{l-1}] by shrinking implicit-pivot elimination
// (solve_step.cuh: first row of maximal |lead| among rows not yet
// eliminated), and stores the full W_l and y_l; the backward sweep
// recovers x_l = y_l - W_l x_{l+1}.
//
// What bounds it on Hopper: the layer recursion is sequential, so one
// thread carries a column through all L layers, and the parallelism is
// the column count (49152 at N = 2, 65 layers: 768 blocks of 64 threads).
// At these N a column's system (m x (2m + 1), m = 2N <= 4) and its
// running [W | y] stay in registers, and each layer's chain of
// instructions is short; the group kernel's shuffles and barriers cost
// more there than the lanes it adds save.  The W and y history goes to a
// wrapper-allocated scratch laid out column-minor ([L, m^2, B] and
// [L, m, B]) so that a warp's accesses are 32 consecutive floats.
//
// Numerics: every sum over a block index runs in order, as in the plain
// torch version (sbdart_tpu_torch/kernels/blocktri_rt.py), term by term;
// built with IEEE division and --fmad=false.

#include <cuda_runtime.h>

#include "solve_step.cuh"

namespace {

template <int N>
__global__ void blocktri_rt_kernel(
    const float* __restrict__ gp,     // [L, N, N, B]
    const float* __restrict__ gm,     // [L, N, N, B]
    const float* __restrict__ ee,     // [L, N, B]
    const float* __restrict__ refl,   // [N, N, B]
    const float* __restrict__ rhs,    // [L, 2N, B]
    float* __restrict__ ws,           // [L, 4N^2, B] scratch: W history
    float* __restrict__ ys,           // [L, 2N, B]   scratch: y history
    float* __restrict__ xs,           // [L, 2N, B]
    int nlyr, int ncol) {
  constexpr int M = 2 * N;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const long long B = ncol;
  auto GP = [&](long long l, int i, int j) {
    return gp[((l * N + i) * N + j) * B + col];
  };
  auto GM = [&](long long l, int i, int j) {
    return gm[((l * N + i) * N + j) * B + col];
  };
  auto EE = [&](long long l, int j) { return ee[(l * N + j) * B + col]; };

  float rmat[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) rmat[i][j] = refl[(i * N + j) * B + col];

  float wy[M][M + 1];   // [W_{l-1} | y_{l-1}], then the layer's solution
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j <= M; ++j) wy[i][j] = 0.0f;

  for (int l = 0; l < nlyr; ++l) {
    float a[M][2 * M + 1];   // [dt | upper | rt]
    const float last = (l == nlyr - 1) ? 1.0f : 0.0f;
    // diagonal block
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float gpe = GP(l, i, j) * EE(l, j);
        const float gml = GM(l, i, j);
        float rg_me = rmat[i][0] * (GM(l, 0, j) * EE(l, j));
        float rg_p = rmat[i][0] * GP(l, 0, j);
#pragma unroll
        for (int q = 1; q < N; ++q) {
          rg_me = rg_me + rmat[i][q] * (GM(l, q, j) * EE(l, j));
          rg_p = rg_p + rmat[i][q] * GP(l, q, j);
        }
        a[i][j] = gml;
        a[i][N + j] = gpe;
        a[N + i][j] = gpe - last * rg_me;
        a[N + i][N + j] = gml - last * rg_p;
      }
    }
    // lower block (top rows, from layer l - 1): dt = diag - lower W_{l-1}
    const long long lm1 = l > 0 ? l - 1 : 0;
    const float neg_low = -((l > 0) ? 1.0f : 0.0f);
    float lt[N][M];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        lt[i][j] = neg_low * (GM(lm1, i, j) * EE(lm1, j));
        lt[i][N + j] = neg_low * GP(lm1, i, j);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        float corr = lt[i][0] * wy[0][j];
#pragma unroll
        for (int q = 1; q < M; ++q) corr = corr + lt[i][q] * wy[q][j];
        a[i][j] = a[i][j] - corr;
      }
      float corr_r = lt[i][0] * wy[0][M];
#pragma unroll
      for (int q = 1; q < M; ++q) corr_r = corr_r + lt[i][q] * wy[q][M];
      a[i][2 * M] = rhs[((long long)l * M + i) * B + col] - corr_r;
      a[N + i][2 * M] = rhs[((long long)l * M + N + i) * B + col];
    }
    // upper block (bottom rows, from layer l + 1)
    const long long lp1 = l < nlyr - 1 ? l + 1 : nlyr - 1;
    const float neg_up = -((l < nlyr - 1) ? 1.0f : 0.0f);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        a[i][M + j] = 0.0f;
        a[i][M + N + j] = 0.0f;
        a[N + i][M + j] = neg_up * GP(lp1, i, j);
        a[N + i][M + N + j] = neg_up * (GM(lp1, i, j) * EE(lp1, j));
      }
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

template <int N>
cudaError_t launch(const float* gp, const float* gm, const float* ee,
                   const float* refl, const float* rhs, float* ws, float* ys,
                   float* xs, int nlyr, int ncol, cudaStream_t stream) {
  const int threads = 64;
  const int blocks = (ncol + threads - 1) / threads;
  blocktri_rt_kernel<N><<<blocks, threads, 0, stream>>>(
      gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sbdart_blocktri_rt(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* ws, float* ys, float* xs, int nlyr, int n,
    int ncol, cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  cudaError_t err;
  switch (n) {
    case 1:
      err = launch<1>(gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol, stream);
      break;
    case 2:
      err = launch<2>(gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
