// The nstr=4 (n = 2) closed-form eigen chain and beam solve of one lane
// (`n2_chain`), shared by the B1 (eig_n2_deltam.cu), B3 (eig_n2_scatter.cu)
// and B8 (eig_n2_planar.cu) kernels, and the scattering build and beam
// right-hand side that B1 and B3 put in front of it (`n2_scatter_chain`).
//
// Mirrors sbdart_tpu/pallas/eig.py:792-832 and _n2_chain_planar (627):
// C^pp / C^pm from the delta-M-scaled ssalb and moments, Lam_l(mu0), the
// reduced beam RHS r1/r2; then the trace-ridged 2x2 Cholesky, the
// half-angle symmetric eigh with the `wa <= wb` select and no sort, the
// triangular solve, G+-, and the partial-pivoted 2x2 UPBEAM elimination.
// The formulas and their operation order follow the plain torch version
// (sbdart_tpu_torch/kernels/eig_n2.py:_scatter_chain, _n2_chain) term by
// term; with IEEE sqrtf / division and --fmad=false the kernels round
// where the plain version does.

#pragma once

#include <cuda_runtime.h>

namespace sbdart_n2 {

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

struct N2Out {
  float kk[2];
  float gp[4];          // 11, 12, 21, 22
  float gm[4];
  float zp[2];
  float zm[2];
};

struct Eigh2 {
  float k2_1, k2_2;     // eigenvalues, in the `wa <= wb` select's order
  float v11, v12, v21, v22;   // eigenvector columns (v11, v21), (v12, v22)
};

// Closed-form symmetric 2x2 eigendecomposition of [[m11, q12], [q12, m22]]
// by half-angle algebra (pallas/eig.py:_eigh2_inline): theta = atan2(2q,
// m11 - m22) / 2 with cos(theta) >= 0, the `wa <= wb` select, no sort.
// Shared by n2_chain and the general chain at N = 2 (eig_chain.cuh).
__device__ __forceinline__ Eigh2 eigh2_half_angle(float m11, float q12,
                                                  float m22) {
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
  Eigh2 e;
  e.k2_1 = lo ? wa : wb;
  e.k2_2 = lo ? wb : wa;
  e.v11 = lo ? cth : -sth;
  e.v21 = lo ? sth : cth;
  e.v12 = lo ? -sth : cth;
  e.v22 = lo ? cth : sth;
  return e;
}

// The closed-form n = 2 chain (_n2_chain_planar) on prebuilt C^pp / C^pm
// entries (11, 12, 21, 22), the reduced beam RHS r = (r1_1, r1_2, r2_1,
// r2_2) and the beam cosine mu0p.
__device__ __forceinline__ N2Out n2_chain(
    const EigN2Consts& k, const float cpp[4], const float cpm[4],
    const float r[4], float mu0p) {
  const float imu1 = k.inv_mu[0], imu2 = k.inv_mu[1];
  const float r1a = r[0], r1b = r[1], r2a = r[2], r2b = r[3];
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

  const Eigh2 e = eigh2_half_angle(m11, q12, m22);
  const float k2_1 = e.k2_1, k2_2 = e.k2_2;
  const float v11 = e.v11, v12 = e.v12, v21 = e.v21, v22 = e.v22;
  N2Out o;
  o.kk[0] = sqrtf(fmaxf(k2_1, k.kk_floor));
  o.kk[1] = sqrtf(fmaxf(k2_2, k.kk_floor));

  const float z21 = v21 / l22;
  const float z22 = v22 / l22;
  const float z11 = (v11 - l21 * z21) / l11;
  const float z12 = (v12 - l21 * z22) / l11;
  const float x11 = z11 * k.inv_p[0];
  const float x12 = z12 * k.inv_p[0];
  const float x21 = z21 * k.inv_p[1];
  const float x22 = z22 * k.inv_p[1];

  const float y11 = -(amb11 * x11 + amb12 * x21) / o.kk[0];
  const float y12 = -(amb11 * x12 + amb12 * x22) / o.kk[1];
  const float y21 = -(amb21 * x11 + amb22 * x21) / o.kk[0];
  const float y22 = -(amb21 * x12 + amb22 * x22) / o.kk[1];
  o.gp[0] = 0.5f * (x11 + y11);
  o.gp[1] = 0.5f * (x12 + y12);
  o.gp[2] = 0.5f * (x21 + y21);
  o.gp[3] = 0.5f * (x22 + y22);
  o.gm[0] = 0.5f * (x11 - y11);
  o.gm[1] = 0.5f * (x12 - y12);
  o.gm[2] = 0.5f * (x21 - y21);
  o.gm[3] = 0.5f * (x22 - y22);

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
  o.zp[0] = 0.5f * (s1 + d1);
  o.zp[1] = 0.5f * (s2 + d2);
  o.zm[0] = 0.5f * (s1 - d1);
  o.zm[1] = 0.5f * (s2 - d2);
  return o;
}

// ss, gl: delta-M-scaled ssalb and moments l = 0..3; mu0p: beam cosine;
// scl: beam amplitude fbeam / (2 pi) (0 where there is no beam).
__device__ __forceinline__ N2Out n2_scatter_chain(
    const EigN2Consts& k, float ss, const float gl[4], float mu0p,
    float scl) {
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
  const float r[4] = {(x0p[0] + x0m[0]) * k.inv_mu[0],
                      (x0p[1] + x0m[1]) * k.inv_mu[1],
                      (x0p[0] - x0m[0]) * k.inv_mu[0],
                      (x0p[1] - x0m[1]) * k.inv_mu[1]};
  return n2_chain(k, cpp, cpm, r, mu0p);
}

// Store one (layer, column)'s chain outputs in the column-minor layout
// kk [L, 2, B], gp/gm [L, 4, B], zp/zm [L, 2, B].
__device__ __forceinline__ void n2_store(
    const N2Out& o, long long l, long long B, int col, float* kk, float* gp,
    float* gm, float* zp, float* zm) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kk[(l * 2 + i) * B + col] = o.kk[i];
    zp[(l * 2 + i) * B + col] = o.zp[i];
    zm[(l * 2 + i) * B + col] = o.zm[i];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    gp[(l * 4 + e) * B + col] = o.gp[e];
    gm[(l * 4 + e) * B + col] = o.gm[e];
  }
}

}  // namespace sbdart_n2
