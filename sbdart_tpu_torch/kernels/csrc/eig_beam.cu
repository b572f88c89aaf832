// The general-n eigen chain + beam solve of the flux path (nstr 8/12/16,
// N = nstr/2 = 4, 6, 8), one thread per (layer, column).
//
// Replaces the TPU kernel sbdart_tpu/pallas/eig.py:_kernel_beam (the chain
// _eig_chain_core with _chol_inline, _leigh_inline, _solve_ut_inline, and
// the beam solve through blocktri.py:_solve_step).  Per (layer, column):
//   1. alpha -+ beta = M^-1 (I - (C^pp +- C^pm) W), with the reciprocal
//      quadrature cosines as constants;
//   2. the sqrt(mu w) congruence, symmetrized; the trace ridge
//      (8 eps / n) tr on S-'s diagonal;
//   3. Cholesky S- = L L^T, then L^T S+ L, symmetrized;
//   4. a fixed number of sweeps (3) of parallel-ordered cyclic Jacobi with
//      the round-robin pair schedule: per round, every row's rotation
//      parameters in the row form of tau and the `small` test, then the
//      whole-matrix row pass, column pass and eigenvector pass; no sort;
//   5. kk = sqrt(max(k^2, 1e-30)), X = sqrt(mu w)^-1 L^-T V,
//      Y = -(alpha - beta) X / kk, G+- = (X +- Y) / 2;
//   6. the reduced beam system [(a+b)(a-b) - I/mu0^2] S = (a+b) r1 - r2/mu0
//      by pivoted elimination (solve_step.cuh), D = (r1 - (a-b) S) mu0,
//      Z+- = (S +- D) / 2.
//
// What bounds it on Hopper: arithmetic and local memory.  At N = 8 a
// thread does ~4 * 8^3 flops for the products, 3 x 7 Jacobi rounds of
// ~3 * 8^2 multiply-adds each and the solves: ~12k flops against 2 N^2 + 2N
// + 1 floats read and 2 N^2 + 3 N written (~0.05 B/flop).  The working set
// (alpha -+ beta, S+-, L, the Jacobi matrix and eigenvectors: ~6 N^2
// floats) exceeds the register file at N = 8 and lives partly in local
// memory, which the L1 cache holds; the pair tables arrive in the
// constants block, so the partner indexing is dynamic.  Every tensor is
// column-minor [L, ..., B] so that a warp's global accesses are 32
// consecutive floats.  The TPU's lane tiles and padding lanes are gone:
// the kernel bounds-checks col < B.
//
// Numerics: every sum over a matrix index runs in order k = 0, 1, ...,
// as the plain torch version's (sbdart_tpu_torch/kernels/eig_beam.py),
// and each operation is the one the plain version performs; with IEEE
// sqrtf / division and --fmad=false the kernel rounds where it does.

#include <cuda_runtime.h>

#include <cstring>

#include "solve_step.cuh"

namespace {

constexpr int kMaxN = 8;
// Jacobi sweeps: the reference's DEFAULT_SWEEPS, SWEEPS_F32 in eig_beam.py
// (float64 never reaches the kernel; its route runs the plain version)
constexpr int kSweeps = 3;

struct EigBeamConsts {
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

static_assert(sizeof(EigBeamConsts) == 148 * 4, "consts layout");

template <int N>
__global__ void eig_beam_kernel(
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
    int ncol, EigBeamConsts k) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const long long l = blockIdx.y;
  const long long B = ncol;
  auto mat = [&](long long i, long long j) {
    return ((l * N + i) * N + j) * B + col;
  };
  auto vec = [&](long long i) { return (l * N + i) * B + col; };

  // ---- 1. alpha -+ beta ------------------------------------------------
  float amb[N][N], apb[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float a = cpp[mat(i, j)], b = cpm[mat(i, j)];
      const float e = (i == j) ? 1.0f : 0.0f;
      amb[i][j] = k.inv_mu[i] * (e - k.w[j] * (a + b));
      apb[i][j] = k.inv_mu[i] * (e - k.w[j] * (a - b));
    }
  }

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
  // T = L^T S+ (into sm), then A = T L (into sp), symmetrized into sm
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

  // ---- 4. parallel-ordered cyclic Jacobi, no sort -----------------------
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

  // ---- 5. kk, X = P^-1 L^-T V, Y, G+- -----------------------------------
  float kk[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    kk[i] = sqrtf(fmaxf(a[i][i], k.kk_floor));
    kk_out[vec(i)] = kk[i];
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
      gp_out[mat(i, j)] = 0.5f * (a[i][j] + y);
      gm_out[mat(i, j)] = 0.5f * (a[i][j] - y);
    }
  }

  // ---- 6. reduced beam solve --------------------------------------------
  const float m0 = mu0[col];
  const float inv0 = 1.0f / m0;
  const float inv0sq = inv0 * inv0;
  float rr1[N];
#pragma unroll
  for (int i = 0; i < N; ++i) rr1[i] = r1[vec(i)];
  float bm[N][N + 1];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float s = apb[i][0] * amb[0][j];
#pragma unroll
      for (int q = 1; q < N; ++q) s = s + apb[i][q] * amb[q][j];
      bm[i][j] = (i == j) ? s - inv0sq : s;
    }
    float s = apb[i][0] * rr1[0];
#pragma unroll
    for (int q = 1; q < N; ++q) s = s + apb[i][q] * rr1[q];
    bm[i][N] = s - r2[vec(i)] * inv0;
  }
  float sx[N][1];
  sbdart_la::solve_step<N, 1>(bm, sx);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = amb[i][0] * sx[0][0];
#pragma unroll
    for (int q = 1; q < N; ++q) s = s + amb[i][q] * sx[q][0];
    const float d = (rr1[i] - s) * m0;
    zp_out[vec(i)] = 0.5f * (sx[i][0] + d);
    zm_out[vec(i)] = 0.5f * (sx[i][0] - d);
  }
}

template <int N>
cudaError_t launch(const float* cpp, const float* cpm, const float* r1,
                   const float* r2, const float* mu0, float* kk, float* gp,
                   float* gm, float* zp, float* zm, int nlyr, int ncol,
                   const EigBeamConsts& k, cudaStream_t stream) {
  const int threads = 64;
  dim3 grid((ncol + threads - 1) / threads, nlyr);
  eig_beam_kernel<N><<<grid, threads, 0, stream>>>(
      cpp, cpm, r1, r2, mu0, kk, gp, gm, zp, zm, ncol, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sbdart_eig_beam(
    const float* cpp, const float* cpm, const float* r1, const float* r2,
    const float* mu0, float* kk, float* gp, float* gm, float* zp, float* zm,
    int nlyr, int n, int ncol, const float* consts_host,
    cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  EigBeamConsts k;
  memcpy(&k, consts_host, sizeof(k));
  cudaError_t err;
  switch (n) {
    case 4:
      err = launch<4>(cpp, cpm, r1, r2, mu0, kk, gp, gm, zp, zm, nlyr, ncol,
                      k, stream);
      break;
    case 6:
      err = launch<6>(cpp, cpm, r1, r2, mu0, kk, gp, gm, zp, zm, nlyr, ncol,
                      k, stream);
      break;
    case 8:
      err = launch<8>(cpp, cpm, r1, r2, mu0, kk, gp, gm, zp, zm, nlyr, ncol,
                      k, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
