// B4: the general-n eigen chain + beam solve of the flux and radiance
// paths (nstr 8/12/16, N = nstr/2 = 4, 6, 8) on a group of G lanes per
// (layer, column), lane i on row i; and B9, the same kernel without the
// beam solve (kBeam false), on the generic path's all-mode lanes.
//
// Replaces the TPU kernels sbdart_tpu/pallas/eig.py:_kernel_beam (the
// chain _eig_chain_core, and the beam solve through
// blocktri.py:_solve_step) and, at N >= 4, sbdart_tpu/pallas/eig.py:_kernel
// (the chain alone; N = 2 stays in eig_chain.cu).  Per (layer, column), as
// the plain torch versions (sbdart_tpu_torch/kernels/eig_beam.py:
// eig_beam_chain_plain, kernels/eig_chain.py:eig_chain_plain):
//   1. alpha -+ beta = M^-1 (I - (C^pp +- C^pm) W), lane i its row;
//   2-5. the eigen chain on the group (eig_group.cuh): kk, G+-;
//   6. (B4 only) the reduced beam system
//      [(a+b)(a-b) - I/mu0^2] S = (a+b) r1 - r2/mu0
//      by pivoted elimination on the group, lane i on row i in registers
//      (group_solve.cuh:solve_rows, the pivot in torch.argmax's order),
//      D = (r1 - (a-b) S) mu0, Z+- = (S +- D) / 2.
//
// What bounds it on Hopper: the work per (layer, column) is ~12k flops
// against 2 N^2 + 2 N + 1 floats read and 2 N^2 + 3 N written (B9: 2 N^2
// read, 2 N^2 + N written), so the bound is the bytes (0.14 ms at 65 x
// 6144, N = 8), and the time is the latency of the chain's ~60 dependent
// steps.  The one-thread kernels ran the chain in one thread a (layer,
// column), 255 registers with dynamically indexed rows in local memory
// (the Jacobi partner came from a table in the constants).  Here a group
// of G lanes (4 at N = 4; 8 at N = 6 and 8, two idle at 6) shares a
// (layer, column), each lane a row
// in registers with compile-time indices (no stack), and a block holds
// `cols` consecutive columns of one layer: it stages their operands into
// shared memory with cp.async and writes the outputs back together, a
// warp's accesses whole 32-byte sectors of the column-minor planes.  B9's
// flat lane axis is a one-layer view (L = 1, B every lane).
//
// Numerics: every element is computed by one lane, every sum over a
// matrix index in order k = 0, 1, ..., each operation the plain version's;
// with IEEE sqrtf / division and --fmad=false the kernel rounds where the
// plain version does.

#include <cuda_runtime.h>

#include <cstring>

#include "eig_group.cuh"
#include "group_solve.cuh"

namespace {

using sbdart_eig::EigChainConsts;
using sbdart_group::Block;
using sbdart_group::pad4;

constexpr int kThreads = 128;

// Offsets (floats) in one (layer, column)'s shared memory, each 16-byte
// aligned: the chain's tiles and rotations (eig_group.cuh; C^pp and C^pm
// arrive in its tiles t0 and t1, and G+ and G- leave from them), kk, then
// (the beam solve only) r1, r2, mu0, Z+ and Z-.
struct BeamLayout {
  int ch, kk, r1, r2, mu0, zp, zm, floats;
  __host__ __device__ BeamLayout(int n, int chain_floats, bool beam)
      : ch(0), kk(chain_floats), r1(kk + pad4(n)), r2(r1 + pad4(n)),
        mu0(r2 + pad4(n)), zp(mu0 + 4), zm(zp + pad4(n)),
        floats(beam ? zm + pad4(n) : r1) {}
};

template <int N, bool kBeam>
__host__ __device__ BeamLayout beam_layout() {
  return BeamLayout(N, sbdart_eig_group::chain_floats<N>(), kBeam);
}

// kBeam: B4 (the chain and the beam solve); else B9 (the chain alone:
// r1, r2, mu0, zp and zm are not read or written and may be null).
template <int N, int G, bool kBeam>
__global__ void __launch_bounds__(kThreads) eig_beam_group_kernel(
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
    int ncol, int stride, EigChainConsts k) {
  extern __shared__ __align__(16) float smem[];
  const BeamLayout lay = beam_layout<N, kBeam>();
  const int i = threadIdx.x & (G - 1);
  const bool live = i < N;
  const Block bk(G, ncol, stride);
  const long long l = blockIdx.y;
  float* base = smem + (threadIdx.x / G) * stride;
  // the Jacobi partners, after the block's columns
  int* parts = reinterpret_cast<int*>(smem + bk.cols * stride);
  sbdart_eig_group::fill_partners<N, G>(parts);

  // C^pp and C^pm into the chain's tiles t0 and t1, row i at i * ts
  constexpr int ts = sbdart_eig_group::tile_stride<N>();
  for (int idx = bk.t; idx < (2 * N * N) << bk.shift; idx += bk.nt) {
    const int e = idx >> bk.shift, s = idx & (bk.cols - 1);
    const int c = min(bk.col0 + s, ncol - 1);
    const int plane = e / (N * N), f = e - plane * N * N;
    sbdart_group::copy_async(
        smem + s * stride + lay.ch + plane * N * ts + (f / N) * ts + f % N,
        (plane ? cpm : cpp) + (l * N * N + f) * bk.B + c);
  }
  if constexpr (kBeam) {
    bk.stage(smem, lay.r1, r1, l * N, N);
    bk.stage(smem, lay.r2, r2, l * N, N);
    bk.stage(smem, lay.mu0, mu0, 0, 1);
  }
  sbdart_group::stage_wait();

  // ---- 1. alpha -+ beta, row i ------------------------------------------
  float inv_mu_i = k.inv_mu[0];
#pragma unroll
  for (int j = 1; j < N; ++j) inv_mu_i = (j == i) ? k.inv_mu[j] : inv_mu_i;
  float* ch = base + lay.ch;
  float cpr[N], cmr[N];
  sbdart_eig_group::get_row(ch, live ? i : 0, cpr);
  sbdart_eig_group::get_row(ch + N * ts, live ? i : 0, cmr);
  float amb[N], apb[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float a = cpr[j], b = cmr[j];
    const float e = (j == i) ? 1.0f : 0.0f;
    amb[j] = inv_mu_i * (e - k.w[j] * (a + b));
    apb[j] = inv_mu_i * (e - k.w[j] * (a - b));
  }

  // ---- 2-5. the chain: kk, G+- ------------------------------------------
  sbdart_eig_group::chain<N, G>(k, i, amb, apb, parts, ch, base + lay.kk);

  if constexpr (kBeam) {
    // ---- 6. reduced beam solve, lane i on row i -------------------------
    const float* tamb = ch + 2 * N * ts;
    float r1v[N], r2v[N], row[N];
    sbdart_eig_group::get_row(base + lay.r1, 0, r1v);
    sbdart_eig_group::get_row(base + lay.r2, 0, r2v);
    const float m0 = base[lay.mu0];
    const float inv0 = 1.0f / m0;
    const float inv0sq = inv0 * inv0;
    float sys[N + 1];
    sbdart_eig_group::get_row(tamb, 0, row);
#pragma unroll
    for (int j = 0; j < N; ++j) sys[j] = apb[0] * row[j];
#pragma unroll
    for (int q = 1; q < N; ++q) {
      sbdart_eig_group::get_row(tamb, q, row);
#pragma unroll
      for (int j = 0; j < N; ++j) sys[j] = sys[j] + apb[q] * row[j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) sys[j] = (j == i) ? sys[j] - inv0sq : sys[j];
    {
      float s = apb[0] * r1v[0];
#pragma unroll
      for (int q = 1; q < N; ++q) s = s + apb[q] * r1v[q];
      sys[N] = s - sbdart_eig_group::pick(r2v, i) * inv0;
    }
    float sol[N];
    sbdart_group::solve_rows<N>(sys, i, G, sol);
    if (live) {
      float s = amb[0] * sol[0];
#pragma unroll
      for (int q = 1; q < N; ++q) s = s + amb[q] * sol[q];
      const float d = (sbdart_eig_group::pick(r1v, i) - s) * m0;
      const float si = sbdart_eig_group::pick(sol, i);
      base[lay.zp + i] = 0.5f * (si + d);
      base[lay.zm + i] = 0.5f * (si - d);
    }
  }
  __syncthreads();
  bk.store(kk_out, l * N, N, 1, smem, lay.kk, 1);
  bk.store(gp_out, l * N * N, N, N, smem, lay.ch, ts);
  bk.store(gm_out, l * N * N, N, N, smem, lay.ch + N * ts, ts);
  if constexpr (kBeam) {
    bk.store(zp_out, l * N, N, 1, smem, lay.zp, 1);
    bk.store(zm_out, l * N, N, 1, smem, lay.zm, 1);
  }
}

template <int N, int G, bool kBeam>
cudaError_t launch(const float* cpp, const float* cpm, const float* r1,
                   const float* r2, const float* mu0, float* kk, float* gp,
                   float* gm, float* zp, float* zm, int nlyr, int ncol,
                   const EigChainConsts& k, cudaStream_t stream) {
  const int cols = kThreads / G;
  const int stride =
      sbdart_group::column_stride(beam_layout<N, kBeam>().floats, G);
  const size_t smem =
      sizeof(float) * ((size_t)cols * stride + (N - 1) * G);
  auto kernel = eig_beam_group_kernel<N, G, kBeam>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((ncol + cols - 1) / cols, nlyr);
  kernel<<<grid, kThreads, smem, stream>>>(cpp, cpm, r1, r2, mu0, kk, gp, gm,
                                           zp, zm, ncol, stride, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sbdart_eig_beam_group(
    const float* cpp, const float* cpm, const float* r1, const float* r2,
    const float* mu0, float* kk, float* gp, float* gm, float* zp, float* zm,
    int nlyr, int n, int ncol, const float* consts_host,
    cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  if (nlyr > 65535) return static_cast<int>(cudaErrorInvalidValue);
  EigChainConsts k;
  memcpy(&k, consts_host, sizeof(k));
  cudaError_t err;
  switch (n) {
    case 4:
      err = launch<4, 4, true>(cpp, cpm, r1, r2, mu0, kk, gp, gm, zp, zm,
                               nlyr, ncol, k, stream);
      break;
    case 6:
      err = launch<6, 8, true>(cpp, cpm, r1, r2, mu0, kk, gp, gm, zp, zm,
                               nlyr, ncol, k, stream);
      break;
    case 8:
      err = launch<8, 8, true>(cpp, cpm, r1, r2, mu0, kk, gp, gm, zp, zm,
                               nlyr, ncol, k, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// B9 at N = 4, 6, 8: the arguments of eig_chain.cu's sbdart_eig_chain.
extern "C" int sbdart_eig_chain_group(const float* cpp, const float* cpm,
                                      float* kk, float* gp, float* gm,
                                      int nlyr, int n, int ncol,
                                      const float* consts_host,
                                      cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  if (nlyr > 65535) return static_cast<int>(cudaErrorInvalidValue);
  EigChainConsts k;
  memcpy(&k, consts_host, sizeof(k));
  cudaError_t err;
  switch (n) {
    case 4:
      err = launch<4, 4, false>(cpp, cpm, nullptr, nullptr, nullptr, kk, gp,
                                gm, nullptr, nullptr, nlyr, ncol, k, stream);
      break;
    case 6:
      err = launch<6, 8, false>(cpp, cpm, nullptr, nullptr, nullptr, kk, gp,
                                gm, nullptr, nullptr, nlyr, ncol, k, stream);
      break;
    case 8:
      err = launch<8, 8, false>(cpp, cpm, nullptr, nullptr, nullptr, kk, gp,
                                gm, nullptr, nullptr, nlyr, ncol, k, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
