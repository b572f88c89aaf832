// The general-n eigen chain (SOLEIG) of one (layer, column) in one
// thread, B9's (eig_chain.cu: chain only, N = 2, 4, 6, 8).  B4 runs the
// same chain on a lane group (eig_group.cuh); its constants block
// (EigChainConsts) is shared.
//
// Mirrors sbdart_tpu/pallas/eig.py:_eig_chain_core (with _chol_inline,
// _leigh_inline, _solve_ut_inline) and its plain torch twin
// sbdart_tpu_torch/kernels/eig_chain.py:_chain.  Per (layer, column):
//   1. alpha -+ beta = M^-1 (I - (C^pp +- C^pm) W), with the reciprocal
//      quadrature cosines as constants (`alpha_beta`);
//   2. the sqrt(mu w) congruence, symmetrized; the trace ridge
//      (8 eps / n) tr on S-'s diagonal;
//   3. Cholesky S- = L L^T, then L^T S+ L, symmetrized;
//   4. at N >= 4 a fixed number of sweeps (3) of parallel-ordered cyclic
//      Jacobi with the round-robin pair schedule: per round, every row's
//      rotation parameters in the row form of tau and the `small` test,
//      then the whole-matrix row pass, column pass and eigenvector pass;
//      at N = 2 the closed-form half-angle eigh (eig_n2_chain.cuh), as the
//      reference switches at pallas/eig.py:258-261; no sort either way;
//   5. kk = sqrt(max(k^2, 1e-30)), X = sqrt(mu w)^-1 L^-T V,
//      Y = -(alpha - beta) X / kk, G+- = (X +- Y) / 2.
//
// Numerics: every sum over a matrix index runs in order k = 0, 1, ..., as
// the plain torch version's, and each operation is the one the plain
// version performs; with IEEE sqrtf / division and --fmad=false the kernels
// round where it does.

#pragma once

#include <cuda_runtime.h>

#include "eig_n2_chain.cuh"

namespace sbdart_eig {

constexpr int kMaxN = 8;
// Jacobi sweeps: the reference's DEFAULT_SWEEPS, SWEEPS_F32 in
// eig_chain.py (float64 never reaches a kernel; its route runs the plain
// version)
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
  int partner[kMaxN - 1][kMaxN];   // per Jacobi round: row i's partner
  float sgn[kMaxN - 1][kMaxN];     // -1 for the pair's p, +1 for its q
};

static_assert(sizeof(EigChainConsts) == 148 * 4, "consts layout");

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

// Steps 2-5: stores kk [L, N, B] and G+- [L, N, N, B] at (l, col).
template <int N>
__device__ __forceinline__ void eig_chain(const EigChainConsts& k,
                                          const float (&amb)[N][N],
                                          const float (&apb)[N][N],
                                          long long l, long long B, int col,
                                          float* __restrict__ kk_out,
                                          float* __restrict__ gp_out,
                                          float* __restrict__ gm_out) {
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

  // ---- 4. the eigensolve, no sort ---------------------------------------
  if constexpr (N == 2) {
    const sbdart_n2::Eigh2 e =
        sbdart_n2::eigh2_half_angle(a[0][0], a[0][1], a[1][1]);
    a[0][0] = e.k2_1;
    a[1][1] = e.k2_2;
    v[0][0] = e.v11;
    v[0][1] = e.v12;
    v[1][0] = e.v21;
    v[1][1] = e.v22;
  } else {
#pragma unroll 1
    for (int sweep = 0; sweep < kSweeps; ++sweep) {
      for (int r = 0; r < N - 1; ++r) {
        const int* partner = k.partner[r];
        const float* sgn = k.sgn[r];
        float crow[N], srow[N];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int pi = partner[i];
          const float d = a[i][i];
          const float off = a[i][pi];
          const float d_prm = a[pi][pi];
          const bool small =
              fabsf(off) <= k.eps * fmaxf(fabsf(d) + fabsf(d_prm), k.eps);
          const float tau =
              (-sgn[i] * (d_prm - d)) / (2.0f * (small ? 1.0f : off));
          const float tsgn = tau >= 0.0f ? 1.0f : -1.0f;
          float t = tsgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
          t = small ? 0.0f : t;
          crow[i] = 1.0f / sqrtf(1.0f + t * t);
          srow[i] = sgn[i] * (t * crow[i]);
        }
        // rows: sp <- J^T a  (sp is free scratch here)
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int pi = partner[i];
#pragma unroll
          for (int j = 0; j < N; ++j)
            sp[i][j] = crow[i] * a[i][j] + srow[i] * a[pi][j];
        }
        // columns: a <- sp J ; eigenvectors: v <- v J
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int pj = partner[j];
#pragma unroll
          for (int i = 0; i < N; ++i) {
            a[i][j] = crow[j] * sp[i][j] + srow[j] * sp[i][pj];
            sm[i][j] = crow[j] * v[i][j] + srow[j] * v[i][pj];
          }
        }
#pragma unroll
        for (int i = 0; i < N; ++i)
#pragma unroll
          for (int j = 0; j < N; ++j) v[i][j] = sm[i][j];
      }
    }
  }

  // ---- 5. kk, X = P^-1 L^-T V, Y, G+- -----------------------------------
  float kk[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    kk[i] = sqrtf(fmaxf(a[i][i], k.kk_floor));
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
