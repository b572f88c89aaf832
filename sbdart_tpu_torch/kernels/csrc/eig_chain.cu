// B9: the eigen chain (SOLEIG) without the beam solve at N = nstr/2 = 2,
// one thread per (layer, column) lane.  The generic solver path runs it on
// every (mode, layer, column) lane of an all-mode nstr=4 solve; N = 4, 6, 8
// run on a lane group per lane (eig_beam_group.cu, sbdart_eig_chain_group).
//
// Replaces the TPU kernel sbdart_tpu/pallas/eig.py:_kernel (reached via
// eig_chain_lane_fused) at N = 2: alpha -+ beta, the sqrt(mu w)
// congruence, the ridged Cholesky, L^T S+ L, the closed-form half-angle
// 2x2 eigh, the triangular solve and G+-, all in eig_chain.cuh.  No sort.
//
// What bounds it on Hopper: its bytes.  A lane reads 8 floats and writes
// 10, against a few dozen flops, in registers.  The TPU's lane tiles and
// identity padding are gone: the kernel bounds-checks col < B.

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
  if (n != 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<2>(cpp, cpm, kk, gp, gm, nlyr, ncol, k,
                                    stream));
}
