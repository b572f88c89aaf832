// The nstr=4 (n = 2) closed-form eigen chain and beam solve on prebuilt
// scattering matrices, one thread per lane: the n = 2 eigensolve of the
// radiance path, whose lanes are every (azimuth mode, layer, column).
//
// Replaces the TPU kernel sbdart_tpu/pallas/eig.py:_n2_planar_kernel
// (reached via eig_beam_chain_lane_fused at n = 2, as a one-layer view of
// _eig_beam_call_layered_n2).  The chain is B1's and B3's own
// (eig_n2_chain.cuh:n2_chain): the three kernels share it.  The TPU's
// [8, B/8] planar layout only filled TPU sublanes and is not carried over;
// here every tensor is column-minor [L, k, B].
//
// What bounds it on Hopper: device-memory bytes.  Each thread reads 13
// floats (C^pp 4, C^pm 4, r1 2, r2 2, mu0 1) and writes 14 (kk 2, gp 4,
// gm 4, zp 2, zm 2), 108 bytes, for ~150 flops, two sqrt pairs and eight
// divisions; everything in between stays in registers.  At the nstr=4
// radiance shape (4 modes x 33 layers x 4096 columns = 540,672 lanes) that
// is 58 MB, ~0.017 ms at 3.35 TB/s.
//
// Numerics: as B1, the plain torch version's op order term by term
// (sbdart_tpu_torch/kernels/eig_n2.py:_n2_chain), --fmad=false.

#include <cuda_runtime.h>

#include <cstring>

#include "eig_n2_chain.cuh"

namespace {

using sbdart_n2::EigN2Consts;

__global__ void eig_n2_planar_kernel(
    const float* __restrict__ cpp,     // [L, 4, B]  (11, 12, 21, 22)
    const float* __restrict__ cpm,     // [L, 4, B]
    const float* __restrict__ r1,      // [L, 2, B]
    const float* __restrict__ r2,      // [L, 2, B]
    const float* __restrict__ mu0,     // [B]
    float* __restrict__ kk_out,        // [L, 2, B]
    float* __restrict__ gp_out,        // [L, 4, B]
    float* __restrict__ gm_out,        // [L, 4, B]
    float* __restrict__ zp_out,        // [L, 2, B]
    float* __restrict__ zm_out,        // [L, 2, B]
    int ncol, EigN2Consts k) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const long long l = blockIdx.y;
  const long long B = ncol;
  float c_pp[4], c_pm[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    c_pp[e] = cpp[(l * 4 + e) * B + col];
    c_pm[e] = cpm[(l * 4 + e) * B + col];
  }
  const float r[4] = {r1[(l * 2 + 0) * B + col], r1[(l * 2 + 1) * B + col],
                      r2[(l * 2 + 0) * B + col], r2[(l * 2 + 1) * B + col]};
  const sbdart_n2::N2Out o = sbdart_n2::n2_chain(k, c_pp, c_pm, r, mu0[col]);
  sbdart_n2::n2_store(o, l, B, col, kk_out, gp_out, gm_out, zp_out, zm_out);
}

}  // namespace

extern "C" int sbdart_eig_n2_planar(
    const float* cpp, const float* cpm, const float* r1, const float* r2,
    const float* mu0, float* kk, float* gp, float* gm, float* zp, float* zm,
    int nlyr, int ncol, const float* consts_host, cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  EigN2Consts k;
  memcpy(&k, consts_host, sizeof(k));
  const int threads = 256;
  dim3 grid((ncol + threads - 1) / threads, nlyr);
  eig_n2_planar_kernel<<<grid, threads, 0, stream>>>(
      cpp, cpm, r1, r2, mu0, kk, gp, gm, zp, zm, ncol, k);
  return static_cast<int>(cudaGetLastError());
}
