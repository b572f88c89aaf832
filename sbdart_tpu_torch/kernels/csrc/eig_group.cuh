// The general-n eigen chain (SOLEIG) of one (layer, column) on a group of
// G lanes (G a power of two, N <= G <= 32): lane i owns row i of every
// N x N matrix.  Used by B4 and B9 at N = 4, 6, 8 (eig_beam_group.cu: B9
// is B4's kernel without the beam solve); B9 at N = 2 keeps the
// one-thread half-angle chain of eig_chain.cuh.
//
// Mirrors sbdart_tpu/pallas/eig.py:_eig_chain_core and its plain torch twin
// sbdart_tpu_torch/kernels/eig_chain.py:chain, steps 2-5:
//   2. the sqrt(mu w) congruence, symmetrized; the trace ridge on S-'s
//      diagonal;
//   3. Cholesky S- = L L^T, then L^T S+ L, symmetrized;
//   4. 3 sweeps of parallel-ordered cyclic Jacobi with the round-robin
//      pair schedule (no sort);
//   5. kk = sqrt(max(k^2, 1e-30)), X = sqrt(mu w)^-1 L^-T V,
//      Y = -(alpha - beta) X / kk, G+- = (X +- Y) / 2.
//
// Design: N is a template argument and every loop over a row is unrolled,
// so each lane's rows (alpha -+ beta, S-+, L, the Jacobi matrix and its
// eigenvectors: at most 7 x 8 floats a lane) stay in registers with
// compile-time indices; where a lane needs the element of its own index
// (the diagonal, the partner's column) it selects it over the unrolled row
// (`pick`).  The Jacobi rounds are unrolled too and their pair table is
// the constexpr round-robin schedule `partner` (that of
// kernels/eig_chain.py:_jacobi_tables), so a column's partner is a
// constant; a row's partner, a lane's own, is read from a small table of
// the block's shared memory.  Cross-row reads go through shuffles inside
// the group (a row's partner row, the diagonal, Cholesky's row j) or
// through the problem's shared memory: its N x N tiles, 16-byte rows (the
// transposes of the symmetrizations, L's columns, S+, L and alpha - beta
// read a row at a time, 16 bytes a load, by every lane at once, V's
// columns), and each Jacobi round's rotations (c_j, s_j), written by lane
// j and read by all.  The rotation parameters, with their sqrt and
// divisions, are computed by the N lanes at once; the one-thread chain
// that B4 and B9 ran before computed them in series, its rows in local
// memory.
//
// Numerics: every element is computed by one lane, every sum over a
// matrix index in order k = 0, 1, ..., each operation the plain
// version's; with IEEE sqrtf / division and --fmad=false the chain rounds
// where the plain version does, and a NaN goes where the plain version's
// goes (torch.clamp_min keeps a NaN, so `clamp_min` does too).

#pragma once

#include <cuda_runtime.h>

#include "eig_chain.cuh"

namespace sbdart_eig_group {

using sbdart_eig::clamp_min;
using sbdart_eig::EigChainConsts;

constexpr unsigned kFull = 0xffffffffu;

// The round-robin schedule of ops/lane.py:_round_robin_pairs: round r
// pairs the players at positions k and n - 1 - k, where position 0 holds
// player 0 and the others hold 1 .. n - 1 turned right by r places.
__host__ __device__ constexpr int rr_player(int n, int r, int k) {
  return k == 0 ? 0 : 1 + (k - 1 + (n - 1) - r % (n - 1)) % (n - 1);
}
__host__ __device__ constexpr int rr_position(int n, int r, int x) {
  return x == 0 ? 0 : 1 + (x - 1 + r) % (n - 1);
}
// Row x's partner in round r (x itself for a lane past the rows).
__host__ __device__ constexpr int partner(int n, int r, int x) {
  return (x < 0 || x >= n) ? x
                           : rr_player(n, r, n - 1 - rr_position(n, r, x));
}

// v[i] for a lane's own index i, over the unrolled row (v[0] where i >= N).
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int i) {
  float out = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) out = (j == i) ? v[j] : out;
  return out;
}

// The row stride of the chain's N x N tiles: 16-byte rows, 4 floats of
// padding (lane i's row starts 4 i + 4 banks from row 0 and the rows of a
// group's 8 lanes meet distinct banks in a 16-byte access).
template <int N>
__host__ __device__ constexpr int tile_stride() {
  return ((N + 3) & ~3) + 4;
}

// Row i of a tile <- v (16-byte stores, the padding zeroed).
template <int N>
__device__ __forceinline__ void put_row(float* t, int i, const float (&v)[N]) {
  float* r = t + i * tile_stride<N>();
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    *reinterpret_cast<float4*>(r + j) = make_float4(
        v[j], j + 1 < N ? v[j + 1] : 0.0f, j + 2 < N ? v[j + 2] : 0.0f,
        j + 3 < N ? v[j + 3] : 0.0f);
  }
}

// v <- row q of a tile (16-byte loads; every lane of a group reads the
// same row, a broadcast).
template <int N>
__device__ __forceinline__ void get_row(const float* t, int q,
                                        float (&v)[N]) {
  const float* r = t + q * tile_stride<N>();
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 u = *reinterpret_cast<const float4*>(r + j);
    v[j] = u.x;
    if (j + 1 < N) v[j + 1] = u.y;
    if (j + 2 < N) v[j + 2] = u.z;
    if (j + 3 < N) v[j + 3] = u.w;
  }
}

// Floats of a problem's shared memory the chain takes: the tiles t0, t1
// and tamb, and two buffers of the rotations (c_j, s_j).
template <int N>
__host__ __device__ constexpr int chain_floats() {
  return 3 * N * tile_stride<N>() + 4 * ((N + 1) & ~1);
}

// The round-robin table of the block, (N - 1) x G ints in shared memory:
// row i's partner in round r at r * G + i (i itself past N), written by
// the block's first lanes, read after a __syncthreads().
template <int N, int G>
__device__ __forceinline__ void fill_partners(int* parts) {
  for (int e = threadIdx.x; e < (N - 1) * G; e += blockDim.x)
    parts[e] = partner(N, e / G, e % G);
}

// Steps 2-5 for one (layer, column).  Lane i < N enters with row i of
// alpha - beta (amb) and alpha + beta (apb); `parts` is the block's
// fill_partners table.  `sm` is the problem's
// chain_floats of shared memory (16-byte aligned): tiles t0 and t1, then
// tamb, which the chain fills with amb's rows and leaves so, then the
// rotations' buffers.  Writes kk[i], and column i of G+ and G- into the
// tiles t0 and t1 (a tile's stride), where the chain leaves them.  Every
// lane of the group takes part; the lanes past N store nothing.
template <int N, int G>
__device__ __forceinline__ void chain(const EigChainConsts& k, int i,
                                      const float (&amb)[N],
                                      const float (&apb)[N],
                                      const int* parts, float* sm_base,
                                      float* kk) {
  constexpr int ts = tile_stride<N>();
  float* t0 = sm_base;
  float* t1 = t0 + N * ts;
  float* tamb = t1 + N * ts;
  float* rot = tamb + N * ts;   // two buffers of 2N floats: c_j, s_j
  const bool live = i < N;

  // ---- 2. congruence, symmetrization, ridge ----------------------------
  float p_i = k.p[0];
#pragma unroll
  for (int j = 1; j < N; ++j) p_i = (j == i) ? k.p[j] : p_i;
  float sm[N], sp[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    sm[j] = k.inv_p[j] * (p_i * amb[j]);
    sp[j] = k.inv_p[j] * (p_i * apb[j]);
  }
  if (live) {
    put_row(t0, i, sm);
    put_row(t1, i, sp);
    put_row(tamb, i, amb);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    sm[j] = 0.5f * (sm[j] + t0[j * ts + i]);
    sp[j] = 0.5f * (sp[j] + t1[j * ts + i]);
  }
  {
    const float dg = pick(sm, i);
    float trace = __shfl_sync(kFull, dg, 0, G);
#pragma unroll
    for (int q = 1; q < N; ++q) trace = trace + __shfl_sync(kFull, dg, q, G);
    const float ridge = k.ridge * trace;
#pragma unroll
    for (int j = 0; j < N; ++j) sm[j] = (j == i) ? sm[j] + ridge : sm[j];
  }

  // ---- 3. Cholesky of S-, then L^T S+ L ---------------------------------
  float lo[N];
#pragma unroll
  for (int j = 0; j < N; ++j) lo[j] = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float lj[N];   // row j of L, its first j entries
#pragma unroll
    for (int q = 0; q < j; ++q) lj[q] = __shfl_sync(kFull, lo[q], j, G);
    float s = __shfl_sync(kFull, sm[j], j, G);
#pragma unroll
    for (int q = 0; q < j; ++q) s = s - lj[q] * lj[q];
    const float d = sqrtf(s);
    const float inv_d = 1.0f / d;
    float s2 = sm[j];
#pragma unroll
    for (int q = 0; q < j; ++q) s2 = s2 - lo[q] * lj[q];
    lo[j] = (i == j) ? d : ((i > j) ? s2 * inv_d : 0.0f);
  }
  __syncwarp();
  if (live) {
    put_row(t0, i, lo);
    put_row(t1, i, sp);
  }
  __syncwarp();
  float ar[N];
  {
    float lc[N];   // column i of L
#pragma unroll
    for (int q = 0; q < N; ++q) lc[q] = t0[q * ts + i];
    float tr[N], row[N];   // row i of T = L^T S+, each sum in order q
    get_row(t1, 0, row);
#pragma unroll
    for (int j = 0; j < N; ++j) tr[j] = lc[0] * row[j];
#pragma unroll
    for (int q = 1; q < N; ++q) {
      get_row(t1, q, row);
#pragma unroll
      for (int j = 0; j < N; ++j) tr[j] = tr[j] + lc[q] * row[j];
    }
    get_row(t0, 0, row);   // row i of T L
#pragma unroll
    for (int j = 0; j < N; ++j) ar[j] = tr[0] * row[j];
#pragma unroll
    for (int q = 1; q < N; ++q) {
      get_row(t0, q, row);
#pragma unroll
      for (int j = 0; j < N; ++j) ar[j] = ar[j] + tr[q] * row[j];
    }
  }
  __syncwarp();
  if (live) put_row(t1, i, ar);
  __syncwarp();
  float a[N], v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    a[j] = 0.5f * (ar[j] + t1[j * ts + i]);
    v[j] = (j == i) ? 1.0f : 0.0f;
  }

  // ---- 4. the eigensolve, no sort ---------------------------------------
  // Each round's rotations go through one of two buffers (by the round's
  // parity), so one __syncwarp() a round orders them.
  int parity = 0;
#pragma unroll 1
  for (int sweep = 0; sweep < sbdart_eig::kSweeps; ++sweep) {
#pragma unroll
    for (int r = 0; r < N - 1; ++r) {
      const int pi = parts[r * G + i];
      const float sg = (i < pi) ? -1.0f : 1.0f;
      const float d = pick(a, i);
      const float off = pick(a, pi);
      const float d_prm = __shfl_sync(kFull, d, pi, G);
      const bool small =
          fabsf(off) <= k.eps * clamp_min(fabsf(d) + fabsf(d_prm), k.eps);
      const float tau = (-sg * (d_prm - d)) / (2.0f * (small ? 1.0f : off));
      // +-1 / den as the reciprocal and its sign (IEEE rounding is
      // symmetric in the sign, so this is the plain version's quotient)
      const float rden = 1.0f / (fabsf(tau) + sqrtf(1.0f + tau * tau));
      float t = tau >= 0.0f ? rden : -rden;
      t = small ? 0.0f : t;
      const float c = 1.0f / sqrtf(1.0f + t * t);
      const float s = sg * (t * c);
      float* cs = rot + parity * 2 * ((N + 1) & ~1);
      parity ^= 1;
      if (live) *reinterpret_cast<float2*>(cs + 2 * i) = make_float2(c, s);
      // rows: J^T a (the partner's row by shuffle)
      float rw[N];
#pragma unroll
      for (int j = 0; j < N; ++j)
        rw[j] = c * a[j] + s * __shfl_sync(kFull, a[j], pi, G);
      __syncwarp();
      // columns: a <- rw J ; eigenvectors: v <- v J
      float cj[N], sj[N];
#pragma unroll
      for (int j = 0; j < N; j += 2) {
        const float4 u = *reinterpret_cast<const float4*>(cs + 2 * j);
        cj[j] = u.x;
        sj[j] = u.y;
        if (j + 1 < N) {
          cj[j + 1] = u.z;
          sj[j + 1] = u.w;
        }
      }
      float vn[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int pj = partner(N, r, j);
        a[j] = cj[j] * rw[j] + sj[j] * rw[pj];
        vn[j] = cj[j] * v[j] + sj[j] * v[pj];
      }
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = vn[j];
    }
  }

  // ---- 5. kk, X = P^-1 L^-T V, Y, G+- (lane i: column i) ----------------
  const float kk_i = sqrtf(clamp_min(pick(a, i), k.kk_floor));
  __syncwarp();
  if (live) {
    kk[i] = kk_i;
    put_row(t1, i, v);
  }
  __syncwarp();
  float x[N];
#pragma unroll
  for (int r = N - 1; r >= 0; --r) {   // L^T z = v_i, back substitution
    float s = t1[r * ts + i];
#pragma unroll
    for (int q = r + 1; q < N; ++q) s = s - t0[q * ts + r] * x[q];
    x[r] = s / t0[r * ts + r];
  }
#pragma unroll
  for (int r = 0; r < N; ++r) x[r] = k.inv_p[r] * x[r];
  __syncwarp();   // L and V are read no more: t0, t1 take G+ and G-
#pragma unroll
  for (int r = 0; r < N; ++r) {
    float row[N];
    get_row(tamb, r, row);
    float s = row[0] * x[0];
#pragma unroll
    for (int q = 1; q < N; ++q) s = s + row[q] * x[q];
    const float y = -s / kk_i;
    if (live) {
      t0[r * ts + i] = 0.5f * (x[r] + y);
      t1[r * ts + i] = 0.5f * (x[r] - y);
    }
  }
}

}  // namespace sbdart_eig_group
