// Fused nstr=4 (n = 2) front end of the flux solve, one thread per
// (layer, column).
//
// Replaces the TPU kernel sbdart_tpu/pallas/eig.py:_n2_deltam_scatter_kernel
// (with its chain _n2_chain_planar).  Per (layer, column) it applies
// Wiscombe delta-M to the raw optics, builds the 2x2 scattering matrices
// C^pp / C^pm and the beam right-hand side, runs the closed-form SOLEIG
// chain (trace-ridged 2x2 Cholesky, half-angle symmetric eigh with the
// `wa <= wb` select and no sort, triangular solve, G+-), solves the 2x2
// UPBEAM system by partial-pivoted elimination, and emits the per-mode
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

namespace {

struct EigN2Consts {
  float inv_mu[2];      // 1 / quadrature cosines (in float32)
  float w[2];           // quadrature weights
  float inv_p[2];       // 1 / sqrt(mu w)        (in float32)
  float p12, p21;       // p1 / p2, p2 / p1
  float ridge;          // (8 eps / n) with n = 2
  float cpp[4][4];      // [ij][l] = Lam_l(mu_i) Lam_l(mu_j)
  float cpm[4][4];      // [ij][l] = (-1)^l Lam_l(mu_i) Lam_l(mu_j)
  float ylm[4][2];      // [l][i]  = Lam_l(mu_i)
  float ylmpar[4][2];   // [l][i]  = (-1)^l Lam_l(mu_i)
  float par[4];         // (-1)^l
  float ss_hi;          // 1 - dither (ssalb clip)
  float f_hi;           // 1 - 1e-6  (delta-M fraction clip)
  float kk_floor;       // 1e-30     (k^2 floor before sqrt)
};

static_assert(sizeof(EigN2Consts) == 64 * sizeof(float), "consts layout");

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
  const float mu0p = mu0[col];
  const float scl = scale[col];

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

  // ---- scattering matrices + beam right-hand side ----------------------
  float c[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = (0.5f * (2 * q + 1)) * ss * gl[q];
  float cpp[4], cpm[4];
#pragma unroll
  for (int ij = 0; ij < 4; ++ij) {
    float sp = k.cpp[ij][0] * c[0];
    float sm = k.cpm[ij][0] * c[0];
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      sp = sp + k.cpp[ij][q] * c[q];
      sm = sm + k.cpm[ij][q] * c[q];
    }
    cpp[ij] = sp;
    cpm[ij] = sm;
  }
  const float y0[4] = {
      1.0f, mu0p, 0.5f * (3.0f * mu0p * mu0p - 1.0f),
      0.5f * mu0p * (5.0f * mu0p * mu0p - 3.0f)};
  float prod[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) prod[q] = c[q] * (k.par[q] * y0[q]);
  float x0p[2], x0m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sp = k.ylm[0][i] * prod[0];
    float sm = k.ylmpar[0][i] * prod[0];
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      sp = sp + k.ylm[q][i] * prod[q];
      sm = sm + k.ylmpar[q][i] * prod[q];
    }
    x0p[i] = sp * scl;
    x0m[i] = sm * scl;
  }
  const float r1a = (x0p[0] + x0m[0]) * k.inv_mu[0];
  const float r1b = (x0p[1] + x0m[1]) * k.inv_mu[1];
  const float r2a = (x0p[0] - x0m[0]) * k.inv_mu[0];
  const float r2b = (x0p[1] - x0m[1]) * k.inv_mu[1];

  // ---- closed-form n = 2 chain (_n2_chain_planar) -----------------------
  const float imu1 = k.inv_mu[0], imu2 = k.inv_mu[1];
  const float w1 = k.w[0], w2 = k.w[1];
  const float amb11 = (1.0f - (cpp[0] + cpm[0]) * w1) * imu1;
  const float amb12 = (-(cpp[1] + cpm[1]) * w2) * imu1;
  const float amb21 = (-(cpp[2] + cpm[2]) * w1) * imu2;
  const float amb22 = (1.0f - (cpp[3] + cpm[3]) * w2) * imu2;
  const float apb11 = (1.0f - (cpp[0] - cpm[0]) * w1) * imu1;
  const float apb12 = (-(cpp[1] - cpm[1]) * w2) * imu1;
  const float apb21 = (-(cpp[2] - cpm[2]) * w1) * imu2;
  const float apb22 = (1.0f - (cpp[3] - cpm[3]) * w2) * imu2;

  // symmetrized congruence P M P^-1, P = diag(p)
  float sm11 = amb11;
  const float sm12 = 0.5f * (amb12 * k.p12 + amb21 * k.p21);
  float sm22 = amb22;
  const float sp11 = apb11;
  const float sp12 = 0.5f * (apb12 * k.p12 + apb21 * k.p21);
  const float sp22 = apb22;

  const float tr = sm11 + sm22;
  const float ridge = k.ridge * tr;
  sm11 = sm11 + ridge;
  sm22 = sm22 + ridge;

  const float l11 = sqrtf(sm11);
  const float l21 = sm12 / l11;
  const float l22 = sqrtf(sm22 - l21 * l21);

  const float a11 = sp11 * l11 + sp12 * l21;
  const float a12 = sp12 * l22;
  const float a21 = sp12 * l11 + sp22 * l21;
  const float a22 = sp22 * l22;
  const float m11 = l11 * a11 + l21 * a21;
  const float m12v = l11 * a12 + l21 * a22;
  const float m21v = l22 * a21;
  const float m22 = l22 * a22;
  const float q12 = 0.5f * (m12v + m21v);

  const float diff = m11 - m22;
  const float rr = sqrtf(diff * diff + 4.0f * q12 * q12);
  const bool safe = rr > 0.0f;
  const float rs = safe ? rr : 1.0f;
  const float cos2 = safe ? diff / rs : 1.0f;
  const float sin2 = safe ? 2.0f * q12 / rs : 0.0f;
  const float cth = sqrtf(fmaxf(0.5f * (1.0f + cos2), 0.0f));
  const float sabs = sqrtf(fmaxf(0.5f * (1.0f - cos2), 0.0f));
  const float sth = sin2 >= 0.0f ? sabs : -sabs;
  const float wa = cth * cth * m11 + 2.0f * cth * sth * q12 + sth * sth * m22;
  const float wb = sth * sth * m11 - 2.0f * cth * sth * q12 + cth * cth * m22;
  const bool lo = wa <= wb;
  const float k2_1 = lo ? wa : wb;
  const float k2_2 = lo ? wb : wa;
  const float v11 = lo ? cth : -sth;
  const float v21 = lo ? sth : cth;
  const float v12 = lo ? -sth : cth;
  const float v22 = lo ? cth : sth;
  const float kk1 = sqrtf(fmaxf(k2_1, k.kk_floor));
  const float kk2 = sqrtf(fmaxf(k2_2, k.kk_floor));

  const float z21 = v21 / l22;
  const float z22 = v22 / l22;
  const float z11 = (v11 - l21 * z21) / l11;
  const float z12 = (v12 - l21 * z22) / l11;
  const float x11 = z11 * k.inv_p[0];
  const float x12 = z12 * k.inv_p[0];
  const float x21 = z21 * k.inv_p[1];
  const float x22 = z22 * k.inv_p[1];

  const float y11 = -(amb11 * x11 + amb12 * x21) / kk1;
  const float y12 = -(amb11 * x12 + amb12 * x22) / kk2;
  const float y21 = -(amb21 * x11 + amb22 * x21) / kk1;
  const float y22 = -(amb21 * x12 + amb22 * x22) / kk2;

  // ---- beam particular: [(a+b)(a-b) - I/mu0^2] S = (a+b) r1 - r2/mu0 ----
  const float inv0 = 1.0f / mu0p;
  const float inv0sq = inv0 * inv0;
  const float b11 = apb11 * amb11 + apb12 * amb21 - inv0sq;
  const float b12 = apb11 * amb12 + apb12 * amb22;
  const float b21 = apb21 * amb11 + apb22 * amb21;
  const float b22 = apb21 * amb12 + apb22 * amb22 - inv0sq;
  const float rb1 = apb11 * r1a + apb12 * r1b - r2a * inv0;
  const float rb2 = apb21 * r1a + apb22 * r1b - r2b * inv0;
  const bool swap = fabsf(b21) > fabsf(b11);
  const float t11 = swap ? b21 : b11;
  const float t12 = swap ? b22 : b12;
  const float tr1 = swap ? rb2 : rb1;
  const float t21 = swap ? b11 : b21;
  const float t22 = swap ? b12 : b22;
  const float tr2 = swap ? rb1 : rb2;
  const float fct = t21 / t11;
  const float d22 = t22 - fct * t12;
  const float s2 = (tr2 - fct * tr1) / d22;
  const float s1 = (tr1 - t12 * s2) / t11;
  const float d1 = (r1a - (amb11 * s1 + amb12 * s2)) * mu0p;
  const float d2 = (r1b - (amb21 * s1 + amb22 * s2)) * mu0p;

  // ---- outputs ----------------------------------------------------------
  kk_out[(l * 2 + 0) * B + col] = kk1;
  kk_out[(l * 2 + 1) * B + col] = kk2;
  gp_out[(l * 4 + 0) * B + col] = 0.5f * (x11 + y11);
  gp_out[(l * 4 + 1) * B + col] = 0.5f * (x12 + y12);
  gp_out[(l * 4 + 2) * B + col] = 0.5f * (x21 + y21);
  gp_out[(l * 4 + 3) * B + col] = 0.5f * (x22 + y22);
  gm_out[(l * 4 + 0) * B + col] = 0.5f * (x11 - y11);
  gm_out[(l * 4 + 1) * B + col] = 0.5f * (x12 - y12);
  gm_out[(l * 4 + 2) * B + col] = 0.5f * (x21 - y21);
  gm_out[(l * 4 + 3) * B + col] = 0.5f * (x22 - y22);
  zp_out[(l * 2 + 0) * B + col] = 0.5f * (s1 + d1);
  zp_out[(l * 2 + 1) * B + col] = 0.5f * (s2 + d2);
  zm_out[(l * 2 + 0) * B + col] = 0.5f * (s1 - d1);
  zm_out[(l * 2 + 1) * B + col] = 0.5f * (s2 - d2);
  dts_out[lb] = dts;
  ee_out[(l * 2 + 0) * B + col] = expf(-kk1 * dts);
  ee_out[(l * 2 + 1) * B + col] = expf(-kk2 * dts);
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
