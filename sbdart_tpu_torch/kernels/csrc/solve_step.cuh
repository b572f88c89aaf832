// Branchless-in-effect partial-pivoted Gaussian elimination of one small
// dense system per thread, shared by the one-thread kernels of B5
// (blocktri_rt.cu), B6 (blocktri_rt_streamed.cuh) and B10
// (block_thomas.cu).
//
// Mirrors sbdart_tpu/pallas/blocktri.py:_solve_step and its plain torch
// twin sbdart_tpu_torch/kernels/blocktri_rt.py:solve_step: implicit
// pivoting (rows are never exchanged; the pivot of step k is the FIRST row
// of maximal |a[i][k]| among the rows not yet eliminated, a NaN counting
// above every number as in torch.argmax and jnp.argmax), elimination of
// columns > k only (the shrinking form: column k is never read again), and
// back-substitution from the saved pivot rows.  Eliminated rows are left
// as they are, which equals the reference's update by a zero factor.

#pragma once

#include <cuda_runtime.h>

namespace sbdart_la {

// Solve A X = B for A = a[:, 0:M], B = a[:, M:M+R] (a is destroyed);
// writes X into x[M][R].
template <int M, int R>
__device__ __forceinline__ void solve_step(float (&a)[M][M + R],
                                           float (&x)[M][R]) {
  bool elim[M];
  int piv[M];
#pragma unroll
  for (int i = 0; i < M; ++i) elim[i] = false;
  for (int k = 0; k < M; ++k) {
    int p = 0;
    float best = -2.0f;
    for (int i = 0; i < M; ++i) {
      const float cand = elim[i] ? -1.0f : fabsf(a[i][k]);
      // torch.argmax's order: the first NaN wins, else the first maximum
      if (best == best && (cand > best || cand != cand)) {
        best = cand;
        p = i;
      }
    }
    const float inv = 1.0f / a[p][k];
    for (int i = 0; i < M; ++i) {
      if (elim[i] || i == p) continue;
      const float f = a[i][k] * inv;
      for (int c = k + 1; c < M + R; ++c) a[i][c] = a[i][c] - f * a[p][c];
    }
    elim[p] = true;
    piv[k] = p;
  }
  for (int i = M - 1; i >= 0; --i) {
    const int p = piv[i];
    for (int t = 0; t < R; ++t) {
      float s = a[p][M + t];
      for (int j = i + 1; j < M; ++j) s = s - a[p][j] * x[j][t];
      x[i][t] = s / a[p][i];
    }
  }
}

}  // namespace sbdart_la
