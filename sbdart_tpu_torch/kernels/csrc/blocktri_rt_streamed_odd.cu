// B6 (blocktri_rt_streamed.cuh) at odd N, in a translation unit of its own
// so that it compiles beside the even N: the backward kernel at N = 1, 3,
// 5, 7 (nstr 2, 6, 10, 14), the forward kernel at N = 1 and 3.

#include "blocktri_rt_streamed.cuh"

extern "C" int sbdart_blocktri_rt_fwd_odd(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* cs, float* ys, int nlyr, int n, int ncol,
    cudaStream_t stream) {
  cudaError_t err;
  switch (n) {
    case 1:
      err = launch_fwd<1>(gp, gm, ee, refl, rhs, cs, ys, nlyr, ncol, stream);
      break;
    case 3:
      err = launch_fwd<3>(gp, gm, ee, refl, rhs, cs, ys, nlyr, ncol, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" int sbdart_blocktri_rt_bwd_odd(
    const float* gp, const float* gm, const float* ee, const float* cs,
    const float* ys, float* xs, int nlyr, int n, int ncol,
    cudaStream_t stream) {
  cudaError_t err;
  switch (n) {
    case 1:
      err = launch_bwd<1>(gp, gm, ee, cs, ys, xs, nlyr, ncol, stream);
      break;
    case 3:
      err = launch_bwd<3>(gp, gm, ee, cs, ys, xs, nlyr, ncol, stream);
      break;
    case 5:
      err = launch_bwd<5>(gp, gm, ee, cs, ys, xs, nlyr, ncol, stream);
      break;
    case 7:
      err = launch_bwd<7>(gp, gm, ee, cs, ys, xs, nlyr, ncol, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
