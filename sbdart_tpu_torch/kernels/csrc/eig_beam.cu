// The general-n eigen chain + beam solve of the flux path (nstr 8/12/16,
// N = nstr/2 = 4, 6, 8), one thread per (layer, column).
//
// Replaces the TPU kernel sbdart_tpu/pallas/eig.py:_kernel_beam (the chain
// _eig_chain_core, and the beam solve through blocktri.py:_solve_step).
// Per (layer, column):
//   1-5. the eigen chain of eig_chain.cuh (alpha -+ beta, the congruence
//      and ridge, Cholesky, 3 sweeps of parallel-ordered Jacobi without a
//      sort, G+-), shared with B9 (eig_chain.cu);
//   6. the reduced beam system [(a+b)(a-b) - I/mu0^2] S = (a+b) r1 - r2/mu0
//      by pivoted elimination (solve_step.cuh), D = (r1 - (a-b) S) mu0,
//      Z+- = (S +- D) / 2.
//
// What bounds it on Hopper: arithmetic and local memory.  At N = 8 a
// thread does ~4 * 8^3 flops for the products, 3 x 7 Jacobi rounds of
// ~3 * 8^2 multiply-adds each and the solves: ~12k flops against 2 N^2 + 2N
// + 1 floats read and 2 N^2 + 3 N written (~0.05 B/flop).  The working set
// (alpha -+ beta, S+-, L, the Jacobi matrix and eigenvectors: ~6 N^2
// floats) exceeds the register file at N = 8 and lives partly in local
// memory, which the L1 cache holds; the pair tables arrive in the
// constants block, so the partner indexing is dynamic.  Every tensor is
// column-minor [L, ..., B] so that a warp's global accesses are 32
// consecutive floats.  The TPU's lane tiles and padding lanes are gone:
// the kernel bounds-checks col < B.
//
// Numerics: every sum over a matrix index runs in order k = 0, 1, ...,
// as the plain torch version's (sbdart_tpu_torch/kernels/eig_beam.py),
// and each operation is the one the plain version performs; with IEEE
// sqrtf / division and --fmad=false the kernel rounds where it does.

#include <cuda_runtime.h>

#include <cstring>

#include "eig_chain.cuh"
#include "solve_step.cuh"

namespace {

using sbdart_eig::EigChainConsts;

template <int N>
__global__ void eig_beam_kernel(
    const float* __restrict__ cpp,     // [L, N, N, B]
    const float* __restrict__ cpm,     // [L, N, N, B]
    const float* __restrict__ r1,      // [L, N, B]
    const float* __restrict__ r2,      // [L, N, B]
    const float* __restrict__ mu0,     // [B]
    float* __restrict__ kk_out,        // [L, N, B]
    float* __restrict__ gp_out,        // [L, N, N, B]
    float* __restrict__ gm_out,        // [L, N, N, B]
    float* __restrict__ zp_out,        // [L, N, B]
    float* __restrict__ zm_out,        // [L, N, B]
    int ncol, EigChainConsts k) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const long long l = blockIdx.y;
  const long long B = ncol;
  auto vec = [&](long long i) { return (l * N + i) * B + col; };

  float amb[N][N], apb[N][N];
  sbdart_eig::alpha_beta<N>(k, cpp, cpm, l, B, col, amb, apb);
  sbdart_eig::eig_chain<N>(k, amb, apb, l, B, col, kk_out, gp_out, gm_out);

  // ---- 6. reduced beam solve --------------------------------------------
  const float m0 = mu0[col];
  const float inv0 = 1.0f / m0;
  const float inv0sq = inv0 * inv0;
  float rr1[N];
#pragma unroll
  for (int i = 0; i < N; ++i) rr1[i] = r1[vec(i)];
  float bm[N][N + 1];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = apb[i][0] * amb[0][j];
#pragma unroll
      for (int q = 1; q < N; ++q) s = s + apb[i][q] * amb[q][j];
      bm[i][j] = (i == j) ? s - inv0sq : s;
    }
    float s = apb[i][0] * rr1[0];
#pragma unroll
    for (int q = 1; q < N; ++q) s = s + apb[i][q] * rr1[q];
    bm[i][N] = s - r2[vec(i)] * inv0;
  }
  float sx[N][1];
  sbdart_la::solve_step<N, 1>(bm, sx);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = amb[i][0] * sx[0][0];
#pragma unroll
    for (int q = 1; q < N; ++q) s = s + amb[i][q] * sx[q][0];
    const float d = (rr1[i] - s) * m0;
    zp_out[vec(i)] = 0.5f * (sx[i][0] + d);
    zm_out[vec(i)] = 0.5f * (sx[i][0] - d);
  }
}

template <int N>
cudaError_t launch(const float* cpp, const float* cpm, const float* r1,
                   const float* r2, const float* mu0, float* kk, float* gp,
                   float* gm, float* zp, float* zm, int nlyr, int ncol,
                   const EigChainConsts& k, cudaStream_t stream) {
  const int threads = 64;
  dim3 grid((ncol + threads - 1) / threads, nlyr);
  eig_beam_kernel<N><<<grid, threads, 0, stream>>>(
      cpp, cpm, r1, r2, mu0, kk, gp, gm, zp, zm, ncol, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sbdart_eig_beam(
    const float* cpp, const float* cpm, const float* r1, const float* r2,
    const float* mu0, float* kk, float* gp, float* gm, float* zp, float* zm,
    int nlyr, int n, int ncol, const float* consts_host,
    cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  EigChainConsts k;
  memcpy(&k, consts_host, sizeof(k));
  cudaError_t err;
  switch (n) {
    case 4:
      err = launch<4>(cpp, cpm, r1, r2, mu0, kk, gp, gm, zp, zm, nlyr, ncol,
                      k, stream);
      break;
    case 6:
      err = launch<6>(cpp, cpm, r1, r2, mu0, kk, gp, gm, zp, zm, nlyr, ncol,
                      k, stream);
      break;
    case 8:
      err = launch<8>(cpp, cpm, r1, r2, mu0, kk, gp, gm, zp, zm, nlyr, ncol,
                      k, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
