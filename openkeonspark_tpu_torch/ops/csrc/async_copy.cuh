// cp.async helpers shared by the kernels that stage device memory in shared
// memory while they compute (rank_count_rotate.cu, grouped_project.cu).
//
// cp.async (sm_80+) copies global -> shared without passing through
// registers; a thread commits its copies as a group and later waits for all
// but the newest N groups, so the copy of the next tile runs under the
// arithmetic of this one. src_bytes < the copy size zero-fills the rest of
// the destination (src_bytes = 0: a zero tile, no read), which is how
// ragged edges are handled.

#pragma once

#include <cuda_runtime.h>

namespace okst {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, L2 only (.cg); both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes (.ca: 4 and 8 byte copies may not bypass L1)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace okst
