// Collapse and finish kernels of the Pippenger MSM (CUDA, sm_90a).
//
// collapse_kernel replaces the TPU kernel
// zprize_wasm_msm_tpu/ops/msm/pl_reduce.py `_collapse_kernel`
// (finish_large stage A), and finish_kernel replaces `_finish_kernel`
// (finish: the whole (W, B) -> one point contract, and at B = 1 the window
// fold of finish_large stage B).
//
// The TPU versions run every phase through ONE generic masked body, a
// grid step per round, to keep the compiled program small, and move data
// between lanes with rolls.  Here the phases are written out plainly and
// lanes meet in shared memory:
//   collapse: one block per window of min(B, 128) threads; thread i takes
//     buckets b = i, i + 128, ...: a bit_length(B)-round double-and-add
//     ladder scales S_{w,b} by b+1 and the thread keeps a running sum, then
//     a tree sums the block's points.  Any power-of-two B: the sorted
//     engine's B = 2^(c-1) for c up to 16 goes through the same kernel.
//   finish:   one block.  Phase A: the same ladder on every (w, b) lane,
//     results parked in a scratch buffer.  Phase B: thread w sums its
//     window's B lanes, doubles the sum c*w times and keeps a running total
//     of the windows it owns.  Phase C: block tree sum.
//
// Bound: operations, and within them latency: the work is a few thousand
// group operations with a serial depth of c*(W-1) doublings, far too few to
// fill the card; bytes are W*B points in and one point out.

#include <cuda_runtime.h>

#include "group.cuh"

#define COLLAPSE_MAX_THREADS 128
#define FINISH_THREADS 128

// acc = k * s by MSB-first double-and-add over `bits` bits.
template <int NW>
__device__ __forceinline__ void ladder(Pt<NW>& acc, const Pt<NW>& s, int k, int bits) {
  pt_identity<NW>(acc);
  for (int i = bits - 1; i >= 0; --i) {
    pt_double<NW>(&acc, &acc);
    if ((k >> i) & 1) pt_add<NW>(&acc, &acc, &s);
  }
}

// S [3][NW][W*B] -> out [3][NW][W]; grid = W blocks of min(B, 128) threads.
template <int NW>
__global__ void __launch_bounds__(COLLAPSE_MAX_THREADS)
    collapse_kernel(const uint32_t* __restrict__ S, uint32_t* __restrict__ out, int W, int B,
                    int bits) {
  __shared__ Pt<NW> sh[COLLAPSE_MAX_THREADS];
  const int w = blockIdx.x, tid = threadIdx.x;
  Pt<NW> s, acc, total;
  pt_load_soa<NW>(s, S, (size_t)W * B, (size_t)w * B + tid);
  ladder<NW>(total, s, tid + 1, bits);
  for (int b = tid + blockDim.x; b < B; b += blockDim.x) {
    pt_load_soa<NW>(s, S, (size_t)W * B, (size_t)w * B + b);
    ladder<NW>(acc, s, b + 1, bits);
    pt_add<NW>(&total, &total, &acc);
  }
  block_sum<NW>(total, sh);
  if (tid == 0) pt_store_soa<NW>(out, (size_t)W, (size_t)w, total);
}

// S [3][NW][W*B] -> out [3][NW][1]; scratch [W*B][3*NW]; one block.
template <int NW>
__global__ void __launch_bounds__(FINISH_THREADS)
    finish_kernel(const uint32_t* __restrict__ S, uint32_t* __restrict__ scratch,
                  uint32_t* __restrict__ out, int W, int B, int c, int bits) {
  __shared__ Pt<NW> sh[FINISH_THREADS];
  const int tid = threadIdx.x;
  Pt<NW> s, acc, total;

  // phase A: (b+1)-ladder on every lane
  for (int lane = tid; lane < W * B; lane += blockDim.x) {
    pt_load_soa<NW>(s, S, (size_t)W * B, (size_t)lane);
    ladder<NW>(acc, s, lane % B + 1, bits);
    pt_store_aos<NW>(scratch + (size_t)lane * (3 * NW), acc);
  }
  __syncthreads();

  // phase B: per-window sum, c*w doublings, running total per thread
  pt_identity<NW>(total);
  for (int w = tid; w < W; w += blockDim.x) {
    pt_load_aos<NW>(acc, scratch + (size_t)w * B * (3 * NW));
    for (int b = 1; b < B; ++b) {
      pt_load_aos<NW>(s, scratch + ((size_t)w * B + b) * (3 * NW));
      pt_add<NW>(&acc, &acc, &s);
    }
    for (int i = 0; i < c * w; ++i) pt_double<NW>(&acc, &acc);
    pt_add<NW>(&total, &total, &acc);
  }

  // phase C: all-sum
  block_sum<NW>(total, sh);
  if (tid == 0) pt_store_soa<NW>(out, (size_t)1, (size_t)0, total);
}

// B a power of two; bits = bit_length(B).
extern "C" int zp_collapse(int nw, const uint32_t* host_consts, const uint32_t* S,
                           uint32_t* out, int W, int B, int bits, void* stream_ptr) {
  if (B < 1 || (B & (B - 1))) return -2;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  const int threads = B < COLLAPSE_MAX_THREADS ? B : COLLAPSE_MAX_THREADS;
#define CALL(NW_) collapse_kernel<NW_><<<W, threads, 0, stream>>>(S, out, W, B, bits)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

extern "C" int zp_finish(int nw, const uint32_t* host_consts, const uint32_t* S,
                         uint32_t* scratch, uint32_t* out, int W, int B, int c, int bits,
                         void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
#define CALL(NW_) \
  finish_kernel<NW_><<<1, FINISH_THREADS, 0, stream>>>(S, scratch, out, W, B, c, bits)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
