// B6 (blocktri_rt_streamed.cuh), one thread per column: the backward
// kernel at N = 2, 4, 6, 8 and the forward kernel at N = 2 (it runs at
// N <= 3, where it measures faster than the group kernel of
// blocktri_rt_streamed_group.cu: kernels/blocktri_rt_streamed.py:
// FWD_ONE_THREAD_N); odd N dispatches to blocktri_rt_streamed_odd.cu.

#include "blocktri_rt_streamed.cuh"

extern "C" int sbdart_blocktri_rt_fwd_odd(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* cs, float* ys, int nlyr, int n, int ncol,
    cudaStream_t stream);
extern "C" int sbdart_blocktri_rt_bwd_odd(
    const float* gp, const float* gm, const float* ee, const float* cs,
    const float* ys, float* xs, int nlyr, int n, int ncol,
    cudaStream_t stream);

extern "C" int sbdart_blocktri_rt_fwd(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* cs, float* ys, int nlyr, int n, int ncol,
    cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  if (n % 2)
    return sbdart_blocktri_rt_fwd_odd(gp, gm, ee, refl, rhs, cs, ys, nlyr, n,
                                      ncol, stream);
  if (n != 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_fwd<2>(gp, gm, ee, refl, rhs, cs, ys, nlyr, ncol, stream));
}

extern "C" int sbdart_blocktri_rt_bwd(
    const float* gp, const float* gm, const float* ee, const float* cs,
    const float* ys, float* xs, int nlyr, int n, int ncol,
    cudaStream_t stream) {
  if (nlyr <= 0 || ncol <= 0) return 0;
  if (n % 2)
    return sbdart_blocktri_rt_bwd_odd(gp, gm, ee, cs, ys, xs, nlyr, n, ncol,
                                      stream);
  cudaError_t err;
  switch (n) {
    case 2:
      err = launch_bwd<2>(gp, gm, ee, cs, ys, xs, nlyr, ncol, stream);
      break;
    case 4:
      err = launch_bwd<4>(gp, gm, ee, cs, ys, xs, nlyr, ncol, stream);
      break;
    case 6:
      err = launch_bwd<6>(gp, gm, ee, cs, ys, xs, nlyr, ncol, stream);
      break;
    case 8:
      err = launch_bwd<8>(gp, gm, ee, cs, ys, xs, nlyr, ncol, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
