// B6 forward (blocktri_rt_streamed.cuh) at odd N, N = 1 and 3 (nstr 2 and
// 6), in a translation unit of its own so that it compiles beside N = 2.

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
