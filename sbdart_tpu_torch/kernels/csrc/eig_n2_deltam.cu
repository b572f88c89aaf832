// Fused nstr=4 (n = 2) front end of the flux solve, one thread per
// (layer, column).
//
// Replaces the TPU kernel sbdart_tpu/pallas/eig.py:_n2_deltam_scatter_kernel
// (with its chain _n2_chain_planar).  Per (layer, column) it applies
// Wiscombe delta-M to the raw optics, then runs the scattering build, the
// beam right-hand side, the closed-form SOLEIG chain and the 2x2 UPBEAM
// solve shared with B3 (eig_n2_chain.cuh), and emits the per-mode
// transmissions ee = exp(-kk dtau*).
//
// What bounds it on Hopper: device-memory bytes.  Each thread reads 9
// floats (dtau, ssalb, 5 moments, scale, mu0) and writes 17 (kk 2, gp 4,
// gm 4, zp 2, zm 2, dtau* 1, ee 2) for ~250 flops, two sqrt pairs, seven
// divisions and two exp: ~0.1 B/flop, far under the card's compute rate.
// The design keeps everything between the raw optics and the outputs in
// registers (no intermediate tensor round-trips device memory, which is
// what the plain torch version pays for), and lays every tensor out
// column-minor [L, k, B] so that neighbouring threads touch neighbouring
// addresses.  The TPU's [8, B/8] planar layout only filled TPU sublanes
// and is not carried over.
//
// Numerics: the formulas and their operation order follow the plain torch
// version (sbdart_tpu_torch/kernels/eig_n2.py) term by term.  The build
// uses IEEE sqrtf / expf / division and --fmad=false, so no multiply-add
// is contracted and the kernel rounds where the plain version does.
// Constants arrive pre-rounded from the wrapper (float64 -> float32), as
// the JAX kernel's Python-float constants are rounded when they meet f32.

#include <cuda_runtime.h>

#include <cstring>

#include "eig_n2_chain.cuh"

namespace {

using sbdart_n2::EigN2Consts;

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void eig_n2_deltam_kernel(
    const float* __restrict__ dtau,    // [L, B]
    const float* __restrict__ ssalb,   // [L, B]
    const float* __restrict__ pmom,    // [L, 5, B]
    const float* __restrict__ scale,   // [B]
    const float* __restrict__ mu0,     // [B]
    float* __restrict__ kk_out,        // [L, 2, B]
    float* __restrict__ gp_out,        // [L, 4, B]  (11, 12, 21, 22)
    float* __restrict__ gm_out,        // [L, 4, B]
    float* __restrict__ zp_out,        // [L, 2, B]
    float* __restrict__ zm_out,        // [L, 2, B]
    float* __restrict__ dts_out,       // [L, B]
    float* __restrict__ ee_out,        // [L, 2, B]
    int ncol, int use_dm, EigN2Consts k) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const long long l = blockIdx.y;
  const long long B = ncol;
  const long long lb = l * B + col;

  // ---- delta-M (solver/deltam.py formulas, kernel op order) ------------
  const float dt = dtau[lb];
  const float ss_raw = clipf(ssalb[lb], 0.0f, k.ss_hi);
  float pm[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) pm[q] = pmom[(l * 5 + q) * B + col];

  float dts, ss, gl[4];
  if (use_dm) {
    const float f = clipf(pm[4], 0.0f, k.f_hi);
    const float wf = ss_raw * f;
    dts = (1.0f - wf) * dt;
    ss = clipf(ss_raw * (1.0f - f) / (1.0f - wf), 0.0f, k.ss_hi);
    const float inv1mf = 1.0f / (1.0f - f);
#pragma unroll
    for (int q = 0; q < 4; ++q) gl[q] = (pm[q] - f) * inv1mf;
  } else {
    dts = dt;
    ss = ss_raw;
#pragma unroll
    for (int q = 0; q < 4; ++q) gl[q] = pm[q];
  }

  const sbdart_n2::N2Out o =
      sbdart_n2::n2_scatter_chain(k, ss, gl, mu0[col], scale[col]);
  sbdart_n2::n2_store(o, l, B, col, kk_out, gp_out, gm_out, zp_out, zm_out);
  dts_out[lb] = dts;
  ee_out[(l * 2 + 0) * B + col] = expf(-o.kk[0] * dts);
  ee_out[(l * 2 + 1) * B + col] = expf(-o.kk[1] * dts);
}

}  // namespace

extern "C" int sbdart_eig_n2_deltam(
    const float* dtau, const float* ssalb, const float* pmom,
    const float* scale, const float* mu0,
    float* kk, float* gp, float* gm, float* zp, float* zm, float* dts,
    float* ee, int nlyr, int ncol, int use_dm, const float* consts_host,
    cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  EigN2Consts k;
  memcpy(&k, consts_host, sizeof(k));
  const int threads = 256;
  dim3 grid((ncol + threads - 1) / threads, nlyr);
  eig_n2_deltam_kernel<<<grid, threads, 0, stream>>>(
      dtau, ssalb, pmom, scale, mu0, kk, gp, gm, zp, zm, dts, ee, ncol,
      use_dm, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sbdart_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
