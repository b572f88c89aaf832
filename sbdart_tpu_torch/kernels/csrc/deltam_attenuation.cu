// The flux lane's thermal front end at nstr = 4, everything before B3: the
// delta-M scaling of each lane's optics and the beam's attenuation down
// the column, scaled and unscaled, written straight into the scan layout
// that B3 and the BVP's right-hand side read.  One thread per lane (batch
// element b); the loop over layers carries the two running optical depths
// in registers.
//
// Replaces no TPU kernel: the JAX package leaves solver/deltam.py and
// solver/fluxlane.py's tau scans to XLA, which fuses them.  In PyTorch the
// same glue is ~30 computing kernels a band-chunk solve (delta-M's clamps,
// products and divisions, two innermost-dim cumsums, the cats, exps and
// wheres of the attenuations) and leaves eb, eb_u and dtau* as transposed
// views, so every later reader ran ATen's strided elementwise kernel.
//
// What bounds it on Hopper: bytes.  A lane-layer reads dtau, ssalb and 5
// moments and writes dtau*, ssalb*, 4 moments g_l* and one level of each
// attenuation: 15 floats, ~0.19 GB at config 5's 3.15 M lane-layers, ~0.06
// ms at 3.35 TB/s; ~40 flops and two expf against 60 bytes.  The inputs
// are batch-major ([.., L] and [.., L, nmom]), read in place through their
// strides, so a lane's layers are neighbours in memory and a warp's lanes
// are not.  A block of 64 lanes therefore stages 8 layers at a time
// through shared memory: its threads copy the tile in the inputs' own
// order (each lane's 8 layers one 32-byte sector of dtau and ssalb, its
// 8 x 5 moments 160 contiguous bytes in config 5) with cp.async, all of a
// step's copies in flight at once, then each thread walks its own lane,
// and its stores to [L, B] rows are the warp's 128-byte lines.  (Plain
// loads, each stored to shared memory before the next was issued, waited
// out the memory's latency one by one: 0.162 ms at config 5's shape on an
// H100, 2.9x the bound.)  64 lanes and 16.6 KB a block let 13 blocks a
// SM, all of config 5's lanes, reside on the card at once.  Rows padded
// to an odd length keep the lane-per-thread reads of the tile free of
// bank conflicts.
//
// Numerics: the plain version's op order as ATen rounds it
// (sbdart_tpu_torch/kernels/deltam_attenuation.py:deltam_attenuation_plain,
// which runs solver/deltam.py:apply_deltam unchanged):
//   * clamp passes NaN through, else fminf(fmaxf(x, lo), hi), its bounds
//     the Python numbers rounded to float32 on the host;
//   * wf = w f; dtau* = (1 - wf) dtau; w* = (w (1 - f)) / (1 - wf), then
//     clamped; g_l* = (g_l - f) / (1 - f), IEEE divisions;
//   * tau is the running sum from a zero level, left to right, one add a
//     layer (the twin's explicit loop: ATen's cumsum fixes no order);
//   * eb = has_beam ? expf(-tau / mu0) : 0, an IEEE division; --fmad=false.

#include <cuda_runtime.h>

#include <cstring>

#include "ring.cuh"

namespace {

constexpr int kMaxDim = 6;
constexpr int kLanes = 64;     // lanes a block, one thread each
constexpr int kLayers = 8;     // layers staged a step
constexpr int kMoments = 5;    // g_0..g_3 and the truncated g_4
constexpr int kViews = 5;      // dtau, ssalb, pmom, mu0, has_beam

// Batch dims (size-1 dims dropped, mergeable neighbours merged by the
// wrapper), innermost last; each input's element strides along them, the
// layer strides of dtau, ssalb and pmom, and pmom's moment stride.
struct DeltaMIndex {
  int ndim;
  long long size[kMaxDim];
  long long bstride[kViews][kMaxDim];
  long long lstride[3];
  long long mstride;
};

// torch.clamp: a NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float attenuation(bool beam, float tau, float mu0) {
  return beam ? expf(-tau / mu0) : 0.0f;
}

__global__ void __launch_bounds__(kLanes)
deltam_attenuation_kernel(const float* __restrict__ dtau,
                          const float* __restrict__ ssalb,
                          const float* __restrict__ pmom,
                          const float* __restrict__ mu0,
                          const unsigned char* __restrict__ has_beam,
                          float* __restrict__ dts_out,   // [L, B]
                          float* __restrict__ ss_out,    // [L, B]
                          float* __restrict__ gl_out,    // [L, 4, B]
                          float* __restrict__ eb_out,    // [L+1, B]
                          float* __restrict__ ebu_out,   // [L+1, B]
                          int nlyr, int nmom, long long nb, int use_dm,
                          float ss_hi, float f_hi, DeltaMIndex ix) {
  __shared__ long long s_off[3][kLanes];
  __shared__ float s_dt[kLanes][kLayers + 1];
  __shared__ float s_ss[kLanes][kLayers + 1];
  __shared__ float s_pm[kLanes][kLayers * kMoments + 1];

  const int t = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * kLanes;
  const long long b = b0 + t;
  const bool live = b < nb;
  const int lanes = static_cast<int>(nb - b0 < kLanes ? nb - b0 : kLanes);
  const int nq = nmom < kMoments ? nmom : kMoments;

  long long o[kViews] = {0, 0, 0, 0, 0};
  if (live) {
    long long rest = b;
    for (int d = ix.ndim - 1; d >= 0; --d) {
      const long long c = rest % ix.size[d];
      rest /= ix.size[d];
#pragma unroll
      for (int a = 0; a < kViews; ++a) o[a] += c * ix.bstride[a][d];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) s_off[a][t] = o[a];
  const float m = live ? mu0[o[3]] : 1.0f;
  const bool beam = live && has_beam[o[4]] != 0;

  float tau_s = 0.0f, tau_u = 0.0f;
  if (live) {
    eb_out[b] = attenuation(beam, tau_s, m);
    ebu_out[b] = attenuation(beam, tau_u, m);
  }
  for (int l0 = 0; l0 < nlyr; l0 += kLayers) {
    const int nl = nlyr - l0 < kLayers ? nlyr - l0 : kLayers;
    __syncthreads();   // the offsets are in; the last step's reads done
    // every copy of the step in flight at once (cp.async: no register
    // holds them, no load waits for the one before)
    {
      const int j = t % kLayers;
      const long long l = l0 + j;
#pragma unroll
      for (int i = t / kLayers; i < kLanes; i += kLanes / kLayers) {
        if (i < lanes && j < nl) {
          sbdart_ring::copy4(&s_dt[i][j],
                             dtau + s_off[0][i] + l * ix.lstride[0]);
          sbdart_ring::copy4(&s_ss[i][j],
                             ssalb + s_off[1][i] + l * ix.lstride[1]);
        }
      }
    }
#pragma unroll 4
    for (int e = t; e < kLanes * kLayers * kMoments; e += kLanes) {
      const int i = e / (kLayers * kMoments);
      const int r = e % (kLayers * kMoments);
      const int j = r / kMoments, q = r % kMoments;
      if (i < lanes && j < nl && q < nq)
        sbdart_ring::copy4(&s_pm[i][r], pmom + s_off[2][i]
                           + (l0 + j) * ix.lstride[2] + q * ix.mstride);
    }
    sbdart_ring::commit();
    sbdart_ring::wait<0>();
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nl; ++j) {
      const float dt = s_dt[t][j];
      const float ss_raw = clampf(s_ss[t][j], 0.0f, ss_hi);
      float pm[kMoments];
#pragma unroll
      for (int q = 0; q < kMoments; ++q)
        pm[q] = q < nq ? s_pm[t][j * kMoments + q] : 0.0f;
      float dts, ss, g[4];
      if (use_dm) {
        const float f = clampf(pm[4], 0.0f, f_hi);
        const float wf = ss_raw * f;
        dts = (1.0f - wf) * dt;
        ss = clampf(ss_raw * (1.0f - f) / (1.0f - wf), 0.0f, ss_hi);
#pragma unroll
        for (int q = 0; q < 4; ++q) g[q] = (pm[q] - f) / (1.0f - f);
      } else {
        dts = dt;
        ss = ss_raw;
#pragma unroll
        for (int q = 0; q < 4; ++q) g[q] = pm[q];
      }
      const long long l = l0 + j;
      const long long at = l * nb + b;
      dts_out[at] = dts;
      ss_out[at] = ss;
#pragma unroll
      for (int q = 0; q < 4; ++q) gl_out[(l * 4 + q) * nb + b] = g[q];
      tau_s = tau_s + dts;
      tau_u = tau_u + dt;
      eb_out[at + nb] = attenuation(beam, tau_s, m);
      ebu_out[at + nb] = attenuation(beam, tau_u, m);
    }
  }
}

}  // namespace

// dims_host: ndim batch sizes, then each input's ndim batch strides
// (dtau, ssalb, pmom, mu0, has_beam), then the 3 layer strides (dtau,
// ssalb, pmom), then pmom's moment stride, in elements.  out: dtau*,
// ssalb* [L, B], g_l* [L, 4, B], eb, eb_u [L+1, B].
extern "C" int sbdart_deltam_attenuation(
    const float* dtau, const float* ssalb, const float* pmom,
    const float* mu0, const unsigned char* has_beam, float* dts, float* ss,
    float* gl, float* eb, float* ebu, int nlyr, int nmom, long long nb,
    int use_dm, float ss_hi, float f_hi, int ndim,
    const long long* dims_host, cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (ndim < 0 || ndim > kMaxDim || nlyr < 0 || nmom < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DeltaMIndex ix;
  memset(&ix, 0, sizeof(ix));
  ix.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    ix.size[d] = dims_host[d];
    for (int a = 0; a < kViews; ++a)
      ix.bstride[a][d] = dims_host[(a + 1) * ndim + d];
  }
  for (int a = 0; a < 3; ++a)
    ix.lstride[a] = dims_host[(kViews + 1) * ndim + a];
  ix.mstride = dims_host[(kViews + 1) * ndim + 3];
  const long long blocks = (nb + kLanes - 1) / kLanes;
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  deltam_attenuation_kernel<<<static_cast<unsigned>(blocks), kLanes, 0,
                              stream>>>(
      dtau, ssalb, pmom, mu0, has_beam, dts, ss, gl, eb, ebu, nlyr, nmom, nb,
      use_dm, ss_hi, f_hi, ix);
  return static_cast<int>(cudaGetLastError());
}
