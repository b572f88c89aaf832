// The nstr=4 (n = 2) front end on delta-M-scaled optics, one thread per
// (layer, column): the front end of the nstr=4 thermal flux solve.
//
// Replaces the TPU kernel sbdart_tpu/pallas/eig.py:_n2_scatter_kernel.  It
// is B1 (eig_n2_deltam.cu) without delta-M and without the dtau*/ee
// outputs: the thermal path scales the optics in glue, because its
// particular solution needs them batch-major too.  The scattering build,
// beam right-hand side, closed-form chain and beam solve are B1's own
// (eig_n2_chain.cuh), so the two kernels share one chain.
//
// What bounds it on Hopper: device-memory bytes.  Each thread reads 7
// floats (ssalb, 4 moments, scale, mu0) and writes 14 (kk 2, gp 4, gm 4,
// zp 2, zm 2) for ~230 flops; everything in between stays in registers,
// and every tensor is column-minor [L, k, B] so that a warp's accesses
// are 32 consecutive floats.
//
// Numerics: as B1, the plain torch version's op order term by term
// (sbdart_tpu_torch/kernels/eig_n2_scatter.py), --fmad=false.

#include <cuda_runtime.h>

#include <cstring>

#include "eig_n2_chain.cuh"

namespace {

using sbdart_n2::EigN2Consts;

__global__ void eig_n2_scatter_kernel(
    const float* __restrict__ ssalb,   // [L, B]     delta-M scaled
    const float* __restrict__ gl,      // [L, 4, B]  delta-M scaled
    const float* __restrict__ scale,   // [B]
    const float* __restrict__ mu0,     // [B]
    float* __restrict__ kk_out,        // [L, 2, B]
    float* __restrict__ gp_out,        // [L, 4, B]  (11, 12, 21, 22)
    float* __restrict__ gm_out,        // [L, 4, B]
    float* __restrict__ zp_out,        // [L, 2, B]
    float* __restrict__ zm_out,        // [L, 2, B]
    int ncol, EigN2Consts k) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const long long l = blockIdx.y;
  const long long B = ncol;
  float g[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) g[q] = gl[(l * 4 + q) * B + col];
  const sbdart_n2::N2Out o = sbdart_n2::n2_scatter_chain(
      k, ssalb[l * B + col], g, mu0[col], scale[col]);
  sbdart_n2::n2_store(o, l, B, col, kk_out, gp_out, gm_out, zp_out, zm_out);
}

}  // namespace

extern "C" int sbdart_eig_n2_scatter(
    const float* ssalb, const float* gl, const float* scale,
    const float* mu0, float* kk, float* gp, float* gm, float* zp, float* zm,
    int nlyr, int ncol, const float* consts_host, cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  EigN2Consts k;
  memcpy(&k, consts_host, sizeof(k));
  const int threads = 256;
  dim3 grid((ncol + threads - 1) / threads, nlyr);
  eig_n2_scatter_kernel<<<grid, threads, 0, stream>>>(
      ssalb, gl, scale, mu0, kk, gp, gm, zp, zm, ncol, k);
  return static_cast<int>(cudaGetLastError());
}
