// B5 (blocktri_rt.cuh) at N = 2, 4, 6, 8; odd N dispatches to
// blocktri_rt_odd.cu.

#include "blocktri_rt.cuh"

extern "C" int sbdart_blocktri_rt_odd(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* ws, float* ys, float* xs, int nlyr, int n,
    int ncol, cudaStream_t stream);

extern "C" int sbdart_blocktri_rt(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* ws, float* ys, float* xs, int nlyr, int n,
    int ncol, cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  if (n % 2)
    return sbdart_blocktri_rt_odd(gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, n,
                                  ncol, stream);
  cudaError_t err;
  switch (n) {
    case 2:
      err = launch<2>(gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol, stream);
      break;
    case 4:
      err = launch<4>(gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol, stream);
      break;
    case 6:
      err = launch<6>(gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol, stream);
      break;
    case 8:
      err = launch<8>(gp, gm, ee, refl, rhs, ws, ys, xs, nlyr, ncol, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
