// The band-integrated Planck function, one thread per output element of
// the broadcast shape of (wvnlo, wvnhi, temp).
//
// Replaces no TPU kernel: the JAX package leaves solver/planck.py to XLA,
// which fuses its elementwise ops into the surrounding computation.  In
// PyTorch the same function is ~450 separate elementwise kernels a call
// (two cumulative fractions: a 9-term Horner series and a 16-term
// exponential series, each step its own kernel), and the thermal flux
// solve calls it three times: once on the level field [C, B, k, L+1] and
// twice on the emission shape [C, B, k].
//
// What bounds it on Hopper: issue slots, barely.  The output is written
// once (4 bytes an element); the inputs are the caller's stride-0
// expanded views, read in place through their own strides (the level
// field reads a few KB), so no full-size copy is made.  Each element
// evaluates only the branch of each cumulative fraction that x selects: 9
// multiply-adds below x = 1, 16 expf and ~100 flops above.
//
// Numerics: the plain version's op order as ATen's CUDA kernels round it
// (sbdart_tpu_torch/kernels/planck.py:planck_band_plain), term by term:
// a tensor divided by a Python number is a multiply by its float
// reciprocal (ATen's div_true with a CPU scalar), which the wrapper
// computes on the host as ATen does; 6 / n^4 arrives rounded from double;
// Horner is a multiply then an add; IEEE expf and division; --fmad=false.
// NaN propagates as in the plain version: clamp_min keeps a NaN
// temperature, and a NaN x fails `x <= 1` and takes the exponential
// series, which keeps it NaN.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxDim = 8;
constexpr int kPowTerms = 9;
constexpr int kExpTerms = 16;
constexpr int kThreads = 256;

struct PlanckConsts {
  float c2;          // C2_RADIATION
  float sigma_pi;    // STEFAN_BOLTZMANN / pi
  float pi4_15;      // 15 / pi^4
  float tmin;        // the temperature clamp, 1e-6
  float xcut;        // the series switch, 1
  float three, six;  // the series' scalar factors
  float pow_coef[kPowTerms];
  float neg_n[kExpTerms];   // -n
  float inv_n1[kExpTerms];  // 1 / n
  float inv_n2[kExpTerms];  // 1 / n^2
  float inv_n3[kExpTerms];  // 1 / n^3
  float c4[kExpTerms];      // 6 / n^4
};

// Output dims (size-1 dims dropped, mergeable neighbours merged by the
// wrapper), innermost last, and each input's element strides along them.
struct PlanckIndex {
  int ndim;
  long long size[kMaxDim];
  long long stride[3][kMaxDim];
};

// F(0 -> x) = (15/pi^4) int_0^x t^3/(e^t - 1) dt, the branch x selects
// (planck.py:_cum_fraction's clamps are the identity on it).
__device__ __forceinline__ float cum_fraction(float x,
                                              const PlanckConsts& k) {
  if (x <= k.xcut) {
    float p = 0.0f;
#pragma unroll
    for (int i = kPowTerms - 1; i >= 0; --i) p = p * x + k.pow_coef[i];
    return k.pi4_15 * (x * (x * x)) * p;
  }
  const float x2 = x * x;
  const float x3 = x * x2;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kExpTerms; ++i) {
    const float e = expf(x * k.neg_n[i]);
    s = s + e * (x3 * k.inv_n1[i] + k.three * x2 * k.inv_n2[i]
                 + k.six * x * k.inv_n3[i] + k.c4[i]);
  }
  return 1.0f - k.pi4_15 * s;
}

__global__ void planck_band_kernel(
    const float* __restrict__ wvnlo, const float* __restrict__ wvnhi,
    const float* __restrict__ temp, float* __restrict__ out, long long n,
    PlanckIndex ix, PlanckConsts k) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n; i += step) {
    long long rest = i, o_lo = 0, o_hi = 0, o_t = 0;
    for (int d = ix.ndim - 1; d >= 0; --d) {
      const long long c = rest % ix.size[d];
      rest /= ix.size[d];
      o_lo += c * ix.stride[0][d];
      o_hi += c * ix.stride[1][d];
      o_t += c * ix.stride[2][d];
    }
    float t = temp[o_t];
    t = isnan(t) ? t : fmaxf(t, k.tmin);
    const float x1 = wvnlo[o_lo] * k.c2 / t;
    const float x2 = wvnhi[o_hi] * k.c2 / t;
    const float frac = cum_fraction(x2, k) - cum_fraction(x1, k);
    const float t2 = t * t;
    out[i] = k.sigma_pi * (t2 * t2) * frac;
  }
}

}  // namespace

// dims_host: ndim sizes, then each input's ndim strides (wvnlo, wvnhi,
// temp), in elements.
extern "C" int sbdart_planck_band(
    const float* wvnlo, const float* wvnhi, const float* temp, float* out,
    long long n, int ndim, const long long* dims_host,
    const float* consts_host, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (ndim < 0 || ndim > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  PlanckIndex ix;
  memset(&ix, 0, sizeof(ix));
  ix.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    ix.size[d] = dims_host[d];
    for (int a = 0; a < 3; ++a) ix.stride[a][d] = dims_host[(a + 1) * ndim + d];
  }
  PlanckConsts k;
  memcpy(&k, consts_host, sizeof(k));
  const long long blocks_needed = (n + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(
      blocks_needed < (1LL << 20) ? blocks_needed : (1LL << 20));
  planck_band_kernel<<<blocks, kThreads, 0, stream>>>(
      wvnlo, wvnhi, temp, out, n, ix, k);
  return static_cast<int>(cudaGetLastError());
}
