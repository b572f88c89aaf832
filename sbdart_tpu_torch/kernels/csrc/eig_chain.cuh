// The eigen chain (SOLEIG) of one (layer, column) in one thread at N = 2,
// B9's (eig_chain.cu); its constants block (EigChainConsts) and sweep
// count are shared with the lane-group chain (eig_group.cuh), which runs
// B4 and B9 at N = 4, 6, 8.
//
// Mirrors sbdart_tpu/pallas/eig.py:_eig_chain_core (with _chol_inline,
// _solve_ut_inline) at N = 2 and its plain torch twin
// sbdart_tpu_torch/kernels/eig_chain.py:chain.  Per (layer, column):
//   1. alpha -+ beta = M^-1 (I - (C^pp +- C^pm) W), with the reciprocal
//      quadrature cosines as constants (`alpha_beta`);
//   2. the sqrt(mu w) congruence, symmetrized; the trace ridge
//      (8 eps / n) tr on S-'s diagonal;
//   3. Cholesky S- = L L^T, then L^T S+ L, symmetrized;
//   4. the closed-form half-angle eigh (eig_n2_chain.cuh), as the
//      reference switches at pallas/eig.py:258-261; no sort;
//   5. kk = sqrt(max(k^2, 1e-30)), X = sqrt(mu w)^-1 L^-T V,
//      Y = -(alpha - beta) X / kk, G+- = (X +- Y) / 2.
//
// Numerics: every sum over a matrix index runs in order k = 0, 1, ..., as
// the plain torch version's, and each operation is the one the plain
// version performs; with IEEE sqrtf / division and --fmad=false the kernel
// rounds where it does.

#pragma once

#include <cuda_runtime.h>

#include "eig_n2_chain.cuh"

namespace sbdart_eig {

constexpr int kMaxN = 8;
// Jacobi sweeps of the lane-group chain: the reference's DEFAULT_SWEEPS,
// SWEEPS_F32 in eig_chain.py (float64 never reaches a kernel; its route
// runs the plain version)
constexpr int kSweeps = 3;

struct EigChainConsts {
  float inv_mu[kMaxN];     // 1 / mu_i (float32 of the float64 reciprocal)
  float w[kMaxN];          // quadrature weights
  float p[kMaxN];          // sqrt(mu w)
  float inv_p[kMaxN];      // 1 / sqrt(mu w)
  float ridge;             // 8 eps / n
  float eps;               // float32 epsilon
  float kk_floor;          // 1e-30
  float pad;
};

static_assert(sizeof(EigChainConsts) == 36 * 4, "consts layout");

// torch.clamp_min(x, lo): NaN stays NaN (fmaxf would give lo).
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// Step 1 from C^pp / C^pm [L, N, N, B] at (layer l, column col).
template <int N>
__device__ __forceinline__ void alpha_beta(const EigChainConsts& k,
                                           const float* __restrict__ cpp,
                                           const float* __restrict__ cpm,
                                           long long l, long long B, int col,
                                           float (&amb)[N][N],
                                           float (&apb)[N][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const long long at = ((l * N + i) * N + j) * B + col;
      const float a = cpp[at], b = cpm[at];
      const float e = (i == j) ? 1.0f : 0.0f;
      amb[i][j] = k.inv_mu[i] * (e - k.w[j] * (a + b));
      apb[i][j] = k.inv_mu[i] * (e - k.w[j] * (a - b));
    }
  }
}

// Steps 2-5 at N = 2: stores kk [L, N, B] and G+- [L, N, N, B] at
// (l, col).
template <int N>
__device__ __forceinline__ void eig_chain(const EigChainConsts& k,
                                          const float (&amb)[N][N],
                                          const float (&apb)[N][N],
                                          long long l, long long B, int col,
                                          float* __restrict__ kk_out,
                                          float* __restrict__ gp_out,
                                          float* __restrict__ gm_out) {
  static_assert(N == 2, "N >= 4 runs on the lane group (eig_group.cuh)");
  // ---- 2. congruence, symmetrization, ridge ----------------------------
  float sm[N][N], sp[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      sm[i][j] = k.inv_p[j] * (k.p[i] * amb[i][j]);
      sp[i][j] = k.inv_p[j] * (k.p[i] * apb[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j) {
      const float m_ij = 0.5f * (sm[i][j] + sm[j][i]);
      const float m_ji = 0.5f * (sm[j][i] + sm[i][j]);
      const float p_ij = 0.5f * (sp[i][j] + sp[j][i]);
      const float p_ji = 0.5f * (sp[j][i] + sp[i][j]);
      sm[i][j] = m_ij;
      sm[j][i] = m_ji;
      sp[i][j] = p_ij;
      sp[j][i] = p_ji;
    }
  }
  float trace = sm[0][0];
#pragma unroll
  for (int i = 1; i < N; ++i) trace = trace + sm[i][i];
  const float ridge = k.ridge * trace;
#pragma unroll
  for (int i = 0; i < N; ++i) sm[i][i] = sm[i][i] + ridge;

  // ---- 3. Cholesky of S-, then L^T S+ L ---------------------------------
  float lo[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) lo[i][j] = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = sm[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) s = s - lo[j][q] * lo[j][q];
    const float d = sqrtf(s);
    lo[j][j] = d;
    const float inv_d = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float s2 = sm[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) s2 = s2 - lo[i][q] * lo[j][q];
      lo[i][j] = s2 * inv_d;
    }
  }
  // T = L^T S+ (into sm), then A = T L (into sp), symmetrized into a
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = lo[0][i] * sp[0][j];
#pragma unroll
      for (int q = 1; q < N; ++q) s = s + lo[q][i] * sp[q][j];
      sm[i][j] = s;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = sm[i][0] * lo[0][j];
#pragma unroll
      for (int q = 1; q < N; ++q) s = s + sm[i][q] * lo[q][j];
      sp[i][j] = s;
    }
  }
  float a[N][N], v[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a[i][j] = 0.5f * (sp[i][j] + sp[j][i]);
      v[i][j] = (i == j) ? 1.0f : 0.0f;
    }
  }

  // ---- 4. the half-angle eigensolve, no sort ---------------------------
  const sbdart_n2::Eigh2 e =
      sbdart_n2::eigh2_half_angle(a[0][0], a[0][1], a[1][1]);
  a[0][0] = e.k2_1;
  a[1][1] = e.k2_2;
  v[0][0] = e.v11;
  v[0][1] = e.v12;
  v[1][0] = e.v21;
  v[1][1] = e.v22;

  // ---- 5. kk, X = P^-1 L^-T V, Y, G+- -----------------------------------
  float kk[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    kk[i] = sqrtf(clamp_min(a[i][i], k.kk_floor));
    kk_out[(l * N + i) * B + col] = kk[i];
  }
  // z (into a): L^T z = v, back substitution; lt[i][q] = lo[q][i]
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      float s = v[i][m];
#pragma unroll
      for (int q = i + 1; q < N; ++q) s = s - lo[q][i] * a[q][m];
      a[i][m] = s / lo[i][i];
    }
  }
  // x = inv_p z (into a)
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int m = 0; m < N; ++m) a[i][m] = k.inv_p[i] * a[i][m];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = amb[i][0] * a[0][j];
#pragma unroll
      for (int q = 1; q < N; ++q) s = s + amb[i][q] * a[q][j];
      const float y = -s / kk[j];
      const long long at = ((l * N + i) * N + j) * B + col;
      gp_out[at] = 0.5f * (a[i][j] + y);
      gm_out[at] = 0.5f * (a[i][j] - y);
    }
  }
}

}  // namespace sbdart_eig
