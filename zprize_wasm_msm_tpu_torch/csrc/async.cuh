// Asynchronous global -> shared copies (cp.async, sm_80+) for the sweeps'
// prefetch, and the kernel attributes their entry points report.
//
// Each thread copies only into its own shared slots and reads only its own,
// so no barrier is needed between threads: cp.async.wait_all / wait_group
// (for every group this thread committed, or all but the newest N) is the
// only synchronisation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// 4-byte copy, cached in L1 (.ca: the only mode for sizes below 16).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// 16-byte copy past L1 (.cg): random reads of large state gain nothing there.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most N of this thread's newest committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// out[0..4] = registers per thread, local (stack + spill) bytes per thread,
// static shared bytes per block, resident blocks per SM at `threads` per
// block.  Returns the CUDA error code.
template <typename Kernel>
static int zp_kernel_info(Kernel kernel, int threads, int* out) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  if (err) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = blocks;
  return 0;
}
