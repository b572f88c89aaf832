// The flux lane's thermal particular solution, azimuth mode 0: one thread
// per lane (batch element b, layer l), writing Y0+, Y0- and Y1 straight
// into the BVP's scan layout [L, N, B].
//
// Replaces no TPU kernel: the JAX package leaves solver/fluxlane.py's
// _thermal to XLA, which fuses it.  In PyTorch the same glue is ~128
// kernels a band-chunk solve (the C^pp/C^pm einsums, lane.lsolve's
// branch-free pivoting on [N, N+m, B] stacks rebuilt at every step, the
// copies into scan layout), ~8 GB of traffic at config 5's 3.15 M lanes.
//
// What bounds it on Hopper: bytes.  A lane reads its ssalb, dtau, nstr
// moments and the Planck radiance at its two levels (4 + 2N floats) and
// writes 3N; the two N x N pivoted solves stay in registers (the
// augmented systems are unrolled and indexed by constants only, so
// nothing goes to local memory).  At N = 2 that is ~0.16 GB a config 5
// solve, ~0.05 ms at 3.35 TB/s.  The inputs are batch-major [..., L],
// read in place through their strides; the output is layer-major.  The
// threads of a block are 32 lanes of b (threadIdx.x) by 8 layers
// (threadIdx.y): a warp's stores to out[l, i, b0..b0+31] are one 128-byte
// line, and its strided loads ssalb[b, l] fall in the 32-byte sectors the
// block's other 7 layers of the same b read too, so each sector comes
// from device memory once and the rest from L1.
//
// Numerics: the plain version's op order as ATen's CUDA kernels round it
// (sbdart_tpu_torch/kernels/thermal.py:thermal_particular_scan_plain,
// which runs solver/sources.py:thermal_particular and
// ops/lane.py:lsolve):
//   * C^pp/C^pm as the twin's explicit sums: term l is ((c_l [par_l])
//     ylm_li) ylm_lj, the terms added from l = 0 left to right;
//   * lsolve's pivot is the first row of maximal |entry|, a NaN winning
//     (ATen's argmax); a swapped-in pivot row is the masked sum of the
//     rows, so it carries x + 0 (-0 becomes +0), the unswapped one not;
//     the elimination adds (-factor) * pivot row; back-substitution
//     subtracts a product, then divides;
//   * 1/mu as ATen's reciprocal rounds it (the wrapper computes it on
//     the host), IEEE division, --fmad=false.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxN = 8;
constexpr int kMaxNstr = 16;
constexpr int kMaxDim = 6;
constexpr int kLanesX = 32;   // batch elements a block (a warp's width)
constexpr int kLayersY = 8;   // layers a block

struct ThermalConsts {
  float twol1[kMaxNstr];           // 2l + 1
  float ylm[kMaxNstr][kMaxN];      // mode-0 Lam_l(mu_i)
  float parity[kMaxNstr];          // (-1)^l
  float inv_mu[kMaxN];             // 1 / mu_i
  float w[kMaxN];                  // quadrature weights
  float tau_floor;                 // the slope's optical-depth floor
};

// Batch dims (size-1 dims dropped, mergeable neighbours merged by the
// wrapper), innermost last; each input's element strides along them
// (ssalb, dtau, gl, b_level), along the layer, and gl's along the moment.
struct ThermalIndex {
  int ndim;
  long long size[kMaxDim];
  long long bstride[4][kMaxDim];
  long long lstride[4];
  long long mstride;
};

// C^pp[i][j] and C^pm[i][j] of one lane, the twin's explicit sums.
template <int N>
__device__ __forceinline__ void scatter_entry(const float (&c)[2 * N],
                                              const float (&cp)[2 * N],
                                              int i, int j,
                                              const ThermalConsts& k,
                                              float& spp, float& spm) {
  spp = (c[0] * k.ylm[0][i]) * k.ylm[0][j];
  spm = (cp[0] * k.ylm[0][i]) * k.ylm[0][j];
#pragma unroll
  for (int l = 1; l < 2 * N; ++l) {
    spp = spp + (c[l] * k.ylm[l][i]) * k.ylm[l][j];
    spm = spm + (cp[l] * k.ylm[l][i]) * k.ylm[l][j];
  }
}

// ops/lane.py:lsolve on one lane's augmented system a = [A | B], N x
// (N + M), in registers; x gets the M solutions.  The pivot row comes up
// by a compare-and-swap with each row below, every index a compile-time
// constant: a row picked by a select chain on the pivot index (a[piv])
// let the compiler index the arrays at run time, which put both systems
// in local memory (ptxas: 64-608 bytes of stack, 0.143 against 0.107 ms
// at config 5's band chunk on an H100).  Columns left of the pivot are
// never read again, so they are not updated.
template <int N, int M>
__device__ __forceinline__ void lsolve(float (&a)[N][N + M],
                                       float (&x)[N][M]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int piv = k;
    float best = fabsf(a[k][k]);
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const float v = fabsf(a[r][k]);
      if (!isnan(best) && (isnan(v) || v > best)) {
        piv = r;
        best = v;
      }
    }
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const bool sw = piv == r;
#pragma unroll
      for (int c = k; c < N + M; ++c) {
        const float top = a[k][c], row = a[r][c];
        a[k][c] = sw ? row : top;
        a[r][c] = sw ? top : row;
      }
    }
    // a swapped-in row is the masked sum of the rows: x + 0, never
    // folded (-0 + 0 is +0)
    const bool stay = piv == k;
#pragma unroll
    for (int c = k; c < N + M; ++c)
      a[k][c] = stay ? a[k][c] : __fadd_rn(a[k][c], 0.0f);
    const float inv_piv = 1.0f / a[k][k];
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const float f = a[r][k] * inv_piv;
#pragma unroll
      for (int c = k + 1; c < N + M; ++c) a[r][c] = a[r][c] + (-f) * a[k][c];
    }
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float s = a[i][N + m];
#pragma unroll
      for (int j = i + 1; j < N; ++j) s = s - a[i][j] * x[j][m];
      x[i][m] = s / a[i][i];
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kLanesX * kLayersY)
thermal_particular_kernel(const float* __restrict__ ssalb,
                          const float* __restrict__ dtau,
                          const float* __restrict__ gl,
                          const float* __restrict__ b_level,
                          float* __restrict__ out, int nlyr, long long nb,
                          ThermalIndex ix, ThermalConsts k) {
  constexpr int NS = 2 * N;
  const long long b = static_cast<long long>(blockIdx.x) * kLanesX
                      + threadIdx.x;
  const int l = blockIdx.y * kLayersY + threadIdx.y;
  if (b >= nb || l >= nlyr) return;
  long long rest = b, o[4] = {0, 0, 0, 0};
  for (int d = ix.ndim - 1; d >= 0; --d) {
    const long long c = rest % ix.size[d];
    rest /= ix.size[d];
#pragma unroll
    for (int a = 0; a < 4; ++a) o[a] += c * ix.bstride[a][d];
  }
  const float w0 = ssalb[o[0] + l * ix.lstride[0]];
  const float dt = dtau[o[1] + l * ix.lstride[1]];
  const float* g = gl + o[2] + l * ix.lstride[2];
  const float b_top = b_level[o[3] + l * ix.lstride[3]];
  const float b_bot = b_level[o[3] + (l + 1) * ix.lstride[3]];

  // c = 0.5 w0 (2l+1) g_l, and c (-1)^l
  float c[NS], cp[NS];
  const float hw = 0.5f * w0;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    c[j] = (hw * k.twol1[j]) * g[j * ix.mstride];
    cp[j] = c[j] * k.parity[j];
  }

  // (alpha - beta) S = [2 (1-w0) b1 / mu, 2 (1-w0) Btop / mu]
  float amb[N][N + 2];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float spp, spm;
      scatter_entry<N>(c, cp, i, j, k, spp, spm);
      const float e = (i == j) ? 1.0f : 0.0f;
      amb[i][j] = k.inv_mu[i] * (e - (spp + spm) * k.w[j]);
    }
  }
  const float tau = isnan(dt) ? dt : fmaxf(dt, k.tau_floor);
  const float b1 = (b_bot - b_top) / tau;
  const float e2 = 2.0f * (1.0f - w0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    amb[i][N] = (e2 * b1) * k.inv_mu[i];
    amb[i][N + 1] = (e2 * b_top) * k.inv_mu[i];
  }
  float s[N][2];
  lsolve<N, 2>(amb, s);

  // (alpha + beta) D0 = S1, built after the first solve (fewer registers)
  float apb[N][N + 1];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float spp, spm;
      scatter_entry<N>(c, cp, i, j, k, spp, spm);
      const float e = (i == j) ? 1.0f : 0.0f;
      apb[i][j] = k.inv_mu[i] * (e - (spp - spm) * k.w[j]);
    }
    apb[i][N] = s[i][0];
  }
  float d[N][1];
  lsolve<N, 1>(apb, d);

  // out[0] = Y0+, out[1] = Y0-, out[2] = Y1, each [L, N, B]
  const long long plane = static_cast<long long>(nlyr) * N * nb;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const long long at = (static_cast<long long>(l) * N + i) * nb + b;
    out[at] = 0.5f * (s[i][1] + d[i][0]);
    out[plane + at] = 0.5f * (s[i][1] - d[i][0]);
    out[2 * plane + at] = 0.5f * s[i][0];
  }
}

template <int N>
int launch(const float* ssalb, const float* dtau, const float* gl,
           const float* b_level, float* out, int nlyr, long long nb,
           const ThermalIndex& ix, const ThermalConsts& k,
           cudaStream_t stream) {
  const dim3 block(kLanesX, kLayersY);
  const long long bx = (nb + kLanesX - 1) / kLanesX;
  const long long by = (nlyr + kLayersY - 1) / kLayersY;
  if (bx > 0x7fffffffLL || by > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  thermal_particular_kernel<N><<<grid, block, 0, stream>>>(
      ssalb, dtau, gl, b_level, out, nlyr, nb, ix, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dims_host: ndim batch sizes, then each input's ndim batch strides
// (ssalb, dtau, gl, b_level), then their 4 layer strides, then gl's
// moment stride, in elements.  out: [3, L, N, B] (Y0+, Y0-, Y1).
extern "C" int sbdart_thermal_particular(
    const float* ssalb, const float* dtau, const float* gl,
    const float* b_level, float* out, int n, int nlyr, long long nb,
    int ndim, const long long* dims_host, const float* consts_host,
    cudaStream_t stream) {
  if (nb <= 0 || nlyr <= 0) return 0;
  if (ndim < 0 || ndim > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  ThermalIndex ix;
  memset(&ix, 0, sizeof(ix));
  ix.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    ix.size[d] = dims_host[d];
    for (int a = 0; a < 4; ++a) ix.bstride[a][d] = dims_host[(a + 1) * ndim + d];
  }
  for (int a = 0; a < 4; ++a) ix.lstride[a] = dims_host[5 * ndim + a];
  ix.mstride = dims_host[5 * ndim + 4];
  ThermalConsts k;
  memcpy(&k, consts_host, sizeof(k));
  switch (n) {
    case 2: return launch<2>(ssalb, dtau, gl, b_level, out, nlyr, nb, ix, k, stream);
    case 4: return launch<4>(ssalb, dtau, gl, b_level, out, nlyr, nb, ix, k, stream);
    case 6: return launch<6>(ssalb, dtau, gl, b_level, out, nlyr, nb, ix, k, stream);
    case 8: return launch<8>(ssalb, dtau, gl, b_level, out, nlyr, nb, ix, k, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
