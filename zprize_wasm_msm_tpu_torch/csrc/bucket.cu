// Bucket sweep and lane reduction of the Pippenger MSM (CUDA, sm_90a).
//
// bucket_sweep_kernel replaces the TPU kernel
// zprize_wasm_msm_tpu/ops/msm/pl_bucket.py `_kernel` (main sweep), and
// lane_reduce_kernel replaces its tail steps and
// zprize_wasm_msm_tpu/ops/msm/pl_reduce.py `_lane_reduce_kernel`.
//
// What the TPU version is shaped by, and what takes its place here:
//   * a sequential grid carrying the bucket state in on-chip memory from
//     step to step  ->  blocks run in no order, so the loop over a lane's
//     points runs INSIDE one thread; thread (w, t) owns window w's lane t
//     and a private row of B buckets, so there are no atomics, no
//     conflicts, and the result is bit-reproducible;
//   * a B-way masked select because there is no per-lane gather  ->  the
//     thread indexes bucket |d|-1 directly;
//   * u16 packing and passes of 8 windows to fit on-chip memory  ->  the
//     state lives in device memory, W*T*B*3*NW*4 bytes, all windows in one
//     launch;
//   * roll-based tail steps  ->  a second kernel, one block per (w, b).
//
// Bound: operations.  One mixed add is 11 Montgomery products of 2*NW^2
// 32-bit multiply-adds; its memory traffic is one bucket read and one
// bucket write of 3*NW words.  Bucket indices are random, so the state is
// laid out bucket-contiguous per thread ([w][t][b][3*NW], 16-byte vector
// loads when 3*NW is a multiple of 4): every 32-byte sector fetched is
// used whole.  Points are read coalesced: lane t takes points t, t+T, ...
// so a warp's 32 lanes read 32 neighbouring points of the [NW][N] arrays.
// Blocks are 64 threads because a complete add keeps several NW-word
// operands live and wants most of the 255 registers a thread may have.

#include <cuda_runtime.h>

#include "group.cuh"

#define SWEEP_THREADS 64
#define REDUCE_THREADS 64

template <int NW>
__global__ void __launch_bounds__(SWEEP_THREADS)
    bucket_sweep_kernel(const int32_t* __restrict__ digits, const uint32_t* __restrict__ X,
                        const uint32_t* __restrict__ Y, uint32_t* __restrict__ state, int W,
                        int T, int N, int B) {
  const size_t gid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (size_t)W * T) return;
  const int w = (int)(gid / T), t = (int)(gid % T);
  uint32_t* mine = state + gid * (size_t)B * (3 * NW);

  Pt<NW> acc;
  pt_identity<NW>(acc);
  for (int b = 0; b < B; ++b) pt_store_aos<NW>(mine + (size_t)b * (3 * NW), acc);

  const int32_t* drow = digits + (size_t)w * N;
  for (int n = t; n < N; n += T) {
    const int d = drow[n];
    if (d == 0) continue;  // zero digit: the bucket row is left as it is
    Fe<NW> x, y;
    fe_load_soa<NW>(x, X, (size_t)N, (size_t)n);
    fe_load_soa<NW>(y, Y, (size_t)N, (size_t)n);
    if (d < 0) fe_neg<NW>(y, y);
    uint32_t* slot = mine + (size_t)((d < 0 ? -d : d) - 1) * (3 * NW);
    pt_load_aos<NW>(acc, slot);
    pt_add_mixed<NW>(&acc, &acc, &x, &y);
    pt_store_aos<NW>(slot, acc);
  }
}

// One block per (w, b): thread i sums lanes i, i+64, ... of that bucket, then
// the block's partial sums are added through shared memory.
template <int NW>
__global__ void __launch_bounds__(REDUCE_THREADS)
    lane_reduce_kernel(const uint32_t* __restrict__ state, uint32_t* __restrict__ out, int W,
                       int T, int B) {
  __shared__ Pt<NW> sh[REDUCE_THREADS];
  const int w = blockIdx.x / B, b = blockIdx.x % B;
  Pt<NW> acc, p;
  pt_identity<NW>(acc);
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    pt_load_aos<NW>(p, state + (((size_t)w * T + t) * B + b) * (3 * NW));
    pt_add<NW>(&acc, &acc, &p);
  }
  block_sum<NW>(acc, sh);
  if (threadIdx.x == 0) pt_store_soa<NW>(out, (size_t)W * B, (size_t)blockIdx.x, acc);
}

static int set_consts(const uint32_t* host_consts, cudaStream_t stream) {
  return (int)cudaMemcpyToSymbolAsync(c_fc, host_consts, sizeof(FieldConsts), 0,
                                      cudaMemcpyHostToDevice, stream);
}

// digits [W][N] int32, X / Y [NW][N] words, state [W][T][B][3*NW] words
// (scratch, fully written here).  N must be a multiple of T.  Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int zp_bucket_sweep(int nw, const uint32_t* host_consts, const int32_t* digits,
                               const uint32_t* X, const uint32_t* Y, uint32_t* state, int W,
                               int T, int N, int B, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = set_consts(host_consts, stream);
  if (err) return err;
  const size_t threads = (size_t)W * T;
  const unsigned blocks = (unsigned)((threads + SWEEP_THREADS - 1) / SWEEP_THREADS);
#define CALL(NW_) \
  bucket_sweep_kernel<NW_><<<blocks, SWEEP_THREADS, 0, stream>>>(digits, X, Y, state, W, T, N, B)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

// state [W][T][B][3*NW] words -> out [3][NW][W*B] words.
extern "C" int zp_lane_reduce(int nw, const uint32_t* host_consts, const uint32_t* state,
                              uint32_t* out, int W, int T, int B, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = set_consts(host_consts, stream);
  if (err) return err;
  const unsigned blocks = (unsigned)(W * B);
#define CALL(NW_) \
  lane_reduce_kernel<NW_><<<blocks, REDUCE_THREADS, 0, stream>>>(state, out, W, T, B)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
