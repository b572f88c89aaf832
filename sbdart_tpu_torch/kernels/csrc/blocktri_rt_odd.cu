// B5 (blocktri_rt.cuh) at odd N = 1, 3, 5, 7 (nstr 2, 6, 10, 14), in a
// translation unit of its own so that it compiles beside the even N.

#include "blocktri_rt.cuh"

extern "C" int sbdart_blocktri_rt_odd(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* ws, float* ys, float* xs, int nlyr, int n,
    int ncol, cudaStream_t stream) {
  cudaError_t err;
  switch (n) {
    case 1:
      err = launch<1>(gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol, stream);
      break;
    case 3:
      err = launch<3>(gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol, stream);
      break;
    case 5:
      err = launch<5>(gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol, stream);
      break;
    case 7:
      err = launch<7>(gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
