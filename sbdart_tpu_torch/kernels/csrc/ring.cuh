// Asynchronous copies from device memory into a ring of shared-memory
// slots (cp.async), for the kernels that stream layers through one: B2
// (blocktri_rt_n2.cu) and B6 backward (blocktri_rt_bwd.cu).  A thread
// starts copies, closes them into a group (commit), and later waits until
// at most n of its groups are still in flight (wait<n>); the copies become
// visible to the other threads of its warp or block after a __syncwarp()
// or __syncthreads() that follows the wait.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace sbdart_ring {

// 16 bytes, both addresses 16-byte aligned; .cg: through L2 only (each
// byte is read once).
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// 4 bytes (the unaligned shapes).
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Whether every pointer is 16-byte aligned.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<std::uintptr_t>(p) & 15u) return false;
  return true;
}

}  // namespace sbdart_ring
