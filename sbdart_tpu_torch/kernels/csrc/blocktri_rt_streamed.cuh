// B6 forward, one thread per column (N = 1..3: FWD_ONE_THREAD_N in
// kernels/blocktri_rt_streamed.py; from N = 4 the group kernel of
// blocktri_rt_streamed_group.cu is faster): the forward elimination of
// the boundary-value solve with the rank-N factor history.  The kernel
// template lives here; blocktri_rt_streamed.cu instantiates it at N = 2
// and blocktri_rt_streamed_odd.cu at N = 1 and 3, so that the two compile
// in parallel.  B6 backward is blocktri_rt_bwd.cu.
//
// Replaces the TPU kernel sbdart_tpu/pallas/blocktri.py:
// _rt_fwd_chunk_kernel (the streamed variant of block_thomas_rt).  The
// blocks are assembled on the fly as in blocktri_rt.cu (B5); what differs
// is the factor kept per layer.  The upper block's only nonzero rows are
// its bottom N, upper_l = [[0], [ub_l]] with ub_l = -[gp_{l+1}, gm_{l+1}
// e_{l+1}], so the Thomas factor W_l = dt_l^-1 upper_l = C_l ub_l with
// C_l = dt_l^-1[:, N:] (2N x N):
//   dt_l = diag_l - [(lt_l C_{l-1}) ub_{l-1}; 0], where ub_{l-1} is built
//   from layer l's own gp/gm/ee; solve dt_l [C_l | y_l] = [I_bottom | r_l
//   - [lt_l y_{l-1}; 0]] by shrinking implicit-pivot elimination
//   (solve_step.cuh) and store C_l, y_l.
// The TPU splits the layers into VMEM-sized chunks and carries C, y and the
// previous layer's gp/gm/ee between grid steps; here one thread carries
// its column through every layer in registers and local memory, which is
// the same arithmetic in the same order (the chunking moved only the
// carry).  The TPU's zero halo layer and identity padding layers change no
// real layer's value and are not needed.
//
// What bounds it on Hopper: as B5, the layer recursion is sequential and
// the parallelism is the column count; per layer the solve is 2N x 3N+1
// at N <= 3.  Both history tensors are column-minor ([L, m N, B],
// [L, m, B]), so a warp's accesses are 32 consecutive floats.
//
// Numerics: every sum over a block index runs in order, as in the plain
// torch version (sbdart_tpu_torch/kernels/blocktri_rt_streamed.py), term
// by term; built with IEEE division and --fmad=false.

#pragma once

#include <cuda_runtime.h>

#include "solve_step.cuh"

namespace {

template <int N>
__global__ void blocktri_rt_fwd_kernel(
    const float* __restrict__ gp,     // [L, N, N, B]
    const float* __restrict__ gm,     // [L, N, N, B]
    const float* __restrict__ ee,     // [L, N, B]
    const float* __restrict__ refl,   // [N, N, B]
    const float* __restrict__ rhs,    // [L, 2N, B]
    float* __restrict__ cs,           // [L, 2N, N, B] rank-N factors C_l
    float* __restrict__ ys,           // [L, 2N, B]
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

  float cy[M][N + 1];   // [C_{l-1} | y_{l-1}], then the layer's solution
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j <= N; ++j) cy[i][j] = 0.0f;

  for (int l = 0; l < nlyr; ++l) {
    float a[M][M + N + 1];   // [dt | I_bottom | rt]
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
    // lower block (top rows, from layer l - 1)
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
    // rank-N correction: lower W_{l-1} = (lt C_{l-1}) ub_{l-1}
    float t[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = lt[i][0] * cy[0][j];
#pragma unroll
        for (int q = 1; q < M; ++q) s = s + lt[i][q] * cy[q][j];
        t[i][j] = s;
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float ub[N];   // column j of ub_{l-1} = -[gp_l, gm_l e_l]
#pragma unroll
      for (int q = 0; q < N; ++q)
        ub[q] = j < N ? -GP(l, q, j) : -(GM(l, q, j - N) * EE(l, j - N));
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float corr = t[i][0] * ub[0];
#pragma unroll
        for (int q = 1; q < N; ++q) corr = corr + t[i][q] * ub[q];
        a[i][j] = a[i][j] - corr;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float corr_r = lt[i][0] * cy[0][N];
#pragma unroll
      for (int q = 1; q < M; ++q) corr_r = corr_r + lt[i][q] * cy[q][N];
      a[i][M + N] = rhs[((long long)l * M + i) * B + col] - corr_r;
      a[N + i][M + N] = rhs[((long long)l * M + N + i) * B + col];
    }
    // the columns of dt^-1 to solve for: rows N..2N-1 of the identity
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) a[i][M + j] = (i == N + j) ? 1.0f : 0.0f;

    sbdart_la::solve_step<M, N + 1>(a, cy);
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        cs[((long long)l * M * N + i * N + j) * B + col] = cy[i][j];
      ys[((long long)l * M + i) * B + col] = cy[i][N];
    }
  }
}

constexpr int kThreads = 64;

template <int N>
cudaError_t launch_fwd(const float* gp, const float* gm, const float* ee,
                       const float* refl, const float* rhs, float* cs,
                       float* ys, int nlyr, int ncol, cudaStream_t stream) {
  const int blocks = (ncol + kThreads - 1) / kThreads;
  blocktri_rt_fwd_kernel<N><<<blocks, kThreads, 0, stream>>>(
      gp, gm, ee, refl, rhs, cs, ys, nlyr, ncol);
  return cudaGetLastError();
}

}  // namespace
