// B9: the eigen chain (SOLEIG) without the beam solve, for N = nstr/2 =
// 2, 4, 6, 8, one thread per (layer, column) lane.  The generic solver
// path runs it on every (mode, layer, column) lane of an all-mode solve.
//
// Replaces the TPU kernel sbdart_tpu/pallas/eig.py:_kernel (reached via
// eig_chain_lane_fused): alpha -+ beta, the sqrt(mu w) congruence, the
// ridged Cholesky, L^T S+ L, 3 sweeps of parallel-ordered Jacobi at N >= 4
// or the closed-form half-angle 2x2 eigh at N = 2, the triangular solve
// and G+-, all in eig_chain.cuh.  No sort.
//
// What bounds it on Hopper: arithmetic and local memory, as B4's chain.  A
// lane reads 2 N^2 floats and writes 2 N^2 + N; at N = 8 it does ~11k
// flops (~0.05 B/flop), and the chain's ~6 N^2-float working set spills
// past the register file to local memory (L1-resident).  At N = 2 the
// chain is a few dozen flops and the kernel is bound by its bytes.  The
// TPU's lane tiles and identity padding are gone: the kernel bounds-checks
// col < B.

#include <cuda_runtime.h>

#include <cstring>

#include "eig_chain.cuh"

namespace {

using sbdart_eig::EigChainConsts;

template <int N>
__global__ void eig_chain_kernel(
    const float* __restrict__ cpp,     // [L, N, N, B]
    const float* __restrict__ cpm,     // [L, N, N, B]
    float* __restrict__ kk_out,        // [L, N, B]
    float* __restrict__ gp_out,        // [L, N, N, B]
    float* __restrict__ gm_out,        // [L, N, N, B]
    int ncol, EigChainConsts k) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const long long l = blockIdx.y;
  const long long B = ncol;
  float amb[N][N], apb[N][N];
  sbdart_eig::alpha_beta<N>(k, cpp, cpm, l, B, col, amb, apb);
  sbdart_eig::eig_chain<N>(k, amb, apb, l, B, col, kk_out, gp_out, gm_out);
}

template <int N>
cudaError_t launch(const float* cpp, const float* cpm, float* kk, float* gp,
                   float* gm, int nlyr, int ncol, const EigChainConsts& k,
                   cudaStream_t stream) {
  const int threads = 64;
  dim3 grid((ncol + threads - 1) / threads, nlyr);
  eig_chain_kernel<N><<<grid, threads, 0, stream>>>(cpp, cpm, kk, gp, gm,
                                                    ncol, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sbdart_eig_chain(const float* cpp, const float* cpm,
                                float* kk, float* gp, float* gm, int nlyr,
                                int n, int ncol, const float* consts_host,
                                cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  EigChainConsts k;
  memcpy(&k, consts_host, sizeof(k));
  cudaError_t err;
  switch (n) {
    case 2:
      err = launch<2>(cpp, cpm, kk, gp, gm, nlyr, ncol, k, stream);
      break;
    case 4:
      err = launch<4>(cpp, cpm, kk, gp, gm, nlyr, ncol, k, stream);
      break;
    case 6:
      err = launch<6>(cpp, cpm, kk, gp, gm, nlyr, ncol, k, stream);
      break;
    case 8:
      err = launch<8>(cpp, cpm, kk, gp, gm, nlyr, ncol, k, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
