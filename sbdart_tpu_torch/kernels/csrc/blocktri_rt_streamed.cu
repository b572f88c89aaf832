// B6 forward (blocktri_rt_streamed.cuh), one thread per column, at N = 2
// (it runs at N <= 3, where it measures faster than the group kernel of
// blocktri_rt_streamed_group.cu: kernels/blocktri_rt_streamed.py:
// FWD_ONE_THREAD_N); odd N dispatches to blocktri_rt_streamed_odd.cu.

#include "blocktri_rt_streamed.cuh"

extern "C" int sbdart_blocktri_rt_fwd_odd(
    const float* gp, const float* gm, const float* ee, const float* refl,
    const float* rhs, float* cs, float* ys, int nlyr, int n, int ncol,
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
