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
// What bounds the sweep on the H100, and what the design does about it.
// The work is one mixed add (11 Montgomery products) per nonzero digit.
// Measured (csrc/diag/mul_variants.cu, its numbers in PERF.md): a thread
// running the inlined mixed add in a loop does ~19.7 K adds/s whether
// 23 552 or 50 688 threads run, i.e. each thread is bound by the latency of
// its own dependent chain, and the card's rate is the resident threads
// times that (1.0 G adds/s at 12 warps per SM).  One thread per (window,
// lane) is W*T threads.  Each step also needs a digit, a point (2 NW words) and a bucket
// (3 NW words) of a state far larger than L2, in a dependent order (digit
// -> bucket address).  Hence:
//   * the mixed add is inlined (group.cuh) over the field core
//     (field.cuh): nothing crosses a call through local memory, and the
//     carry-chain product keeps the registers at a level that leaves 6
//     blocks (12 warps) resident per SM;
//   * the kernel engine (ops/msm/pippenger.py _kernel_lanes) runs as many
//     lanes as one wave of resident threads holds, a power-of-two multiple
//     of 1024: path A's W*T = 23 552 becomes 47 104 threads (and the lane
//     reduction sums twice the lanes);
//   * software pipelining across steps: while step s's add runs, the
//     thread's cp.async copies of step s+1's point and bucket are in flight
//     into its own double-buffered slots in shared memory, and step s+2's
//     digit is loaded into a register.  In-flight loads occupy shared
//     memory, not the registers the add needs;
//   * the same-bucket hazard: the copy of step s+1's bucket is issued
//     before step s's add stores its result, so when both steps hit one
//     bucket that copy is stale; the kernel then skips it and carries the
//     accumulator over in registers (on 1 step in B with random digits, on
//     every step of a lane whose digits all hit one bucket).  A bucket
//     stored at step s and read again at step s+2 or later is read after
//     the store, by the same thread, in program order.
// Splitting a lane's buckets among G threads that share its row (each
// thread walking all the lane's digits for its own) was tried on the card
// and lost at both paths' shapes: the threads of a warp drift to different
// steps, their loads stop coalescing, and the longest of 32 uneven walks
// sets the warp's time.
// Bucket rows are laid out bucket-contiguous per thread ([w][t][b][3 NW]),
// so a bucket is whole 16-byte copies and 32-byte sectors; points are read
// coalesced ([NW][N] words, lane t takes points t, t+T, ...).  Shared slots
// are [buffer][word or 16-byte chunk][thread]: neighbouring threads hit
// neighbouring banks.
//
// Not used, and why: TMA copies tiles, and these are per-thread random
// gathers of 96-144 bytes; wgmma multiplies dense tiles of small types, and
// a Montgomery product is an integer carry chain (a tensor-core product on
// int8 limbs is research-grade and out of scope here).

#include <cuda_runtime.h>

#include "async.cuh"
#include "group.cuh"

#define SWEEP_THREADS 64
#define REDUCE_THREADS 64

// digits [W][N] int32, X / Y [NW][N] words, state [W][T][B][3*NW] words.
// Thread (w, t) takes points t, t+T, ... of window w into its row.
template <int NW>
__global__ void __launch_bounds__(SWEEP_THREADS)
    bucket_sweep_kernel(const int32_t* __restrict__ digits, const uint32_t* __restrict__ X,
                        const uint32_t* __restrict__ Y, uint32_t* __restrict__ state, int W,
                        int T, int N, int B) {
  constexpr int BW = 3 * NW;        // words of a bucket
  constexpr int BC = (BW + 3) / 4;  // its 16-byte chunks in shared memory
  __shared__ uint32_t sh_pt[2][2 * NW][SWEEP_THREADS];
  __shared__ uint4 sh_bk[2][BC][SWEEP_THREADS];

  const int tid = threadIdx.x;
  const size_t gid = (size_t)blockIdx.x * blockDim.x + tid;
  if (gid >= (size_t)W * T) return;
  const int w = (int)(gid / T), t = (int)(gid % T);
  uint32_t* row = state + gid * (size_t)B * BW;

  Pt<NW> acc;
  pt_identity<NW>(acc);
  for (int b = 0; b < B; ++b) pt_store_aos<NW>(row + (size_t)b * BW, acc);

  // copies of step s's point and (unless carried) bucket into buffer buf
  auto fetch = [&](int buf, int s, int d, bool bucket) {
    const size_t n = (size_t)t + (size_t)s * T;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      cp_async4(&sh_pt[buf][k][tid], X + (size_t)k * N + n);
      cp_async4(&sh_pt[buf][NW + k][tid], Y + (size_t)k * N + n);
    }
    if (!bucket) return;
    const uint32_t* src = row + (size_t)((d < 0 ? -d : d) - 1) * BW;
    if constexpr (BW % 4 == 0) {
#pragma unroll
      for (int k = 0; k < BC; ++k) cp_async16(&sh_bk[buf][k][tid], src + 4 * k);
    } else {
#pragma unroll
      for (int k = 0; k < BW; ++k)
        cp_async4(reinterpret_cast<uint32_t*>(&sh_bk[buf][k / 4][tid]) + k % 4, src + k);
    }
  };

  const int32_t* drow = digits + (size_t)w * N;
  const int S = N / T;  // steps
  int d0 = S > 0 ? drow[t] : 0;
  int d1 = S > 1 ? drow[(size_t)t + T] : 0;
  if (d0 != 0) fetch(0, 0, d0, true);
  cp_async_wait_all();
  bool carried = false;  // acc already holds step s's bucket (the hazard case)
  for (int s = 0; s < S; ++s) {
    const int cb = s & 1;
    const int d2 = s + 2 < S ? drow[(size_t)t + (size_t)(s + 2) * T] : 0;
    const int a0 = d0 < 0 ? -d0 : d0, a1 = d1 < 0 ? -d1 : d1;
    const bool carry_next = d0 != 0 && a1 == a0;
    if (d1 != 0) fetch(cb ^ 1, s + 1, d1, !carry_next);
    cp_async_commit();
    if (d0 != 0) {
      Fe<NW> x, y;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        x.w[k] = sh_pt[cb][k][tid];
        y.w[k] = sh_pt[cb][NW + k][tid];
      }
      if (d0 < 0) fe_neg<NW>(y, y);
      if (!carried) {
        if constexpr (BW % 4 == 0) {
          uint4* a4 = reinterpret_cast<uint4*>(&acc);
#pragma unroll
          for (int k = 0; k < BC; ++k) a4[k] = sh_bk[cb][k][tid];
        } else {
          uint32_t* a = reinterpret_cast<uint32_t*>(&acc);
#pragma unroll
          for (int k = 0; k < BW; ++k)
            a[k] = reinterpret_cast<const uint32_t*>(&sh_bk[cb][k / 4][tid])[k % 4];
        }
      }
      pt_add_mixed<NW>(acc, x, y);
      pt_store_aos<NW>(row + (size_t)(a0 - 1) * BW, acc);
    }
    cp_async_wait_all();
    carried = carry_next;
    d0 = d1;
    d1 = d2;
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

// digits [W][N] int32, X / Y [NW][N] words, state [W][T][B][3*NW] words
// (scratch, fully written here).  N must be a multiple of T.  Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int zp_bucket_sweep(int nw, const uint32_t* host_consts, const int32_t* digits,
                               const uint32_t* X, const uint32_t* Y, uint32_t* state, int W,
                               int T, int N, int B, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  const size_t threads = (size_t)W * T;
  const unsigned blocks = (unsigned)((threads + SWEEP_THREADS - 1) / SWEEP_THREADS);
#define CALL(NW_) \
  bucket_sweep_kernel<NW_><<<blocks, SWEEP_THREADS, 0, stream>>>(digits, X, Y, state, W, T, N, B)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

// out[0..4]: registers, local bytes, static shared bytes, resident blocks
// per SM of bucket_sweep_kernel<nw> (zp_kernel_info).
extern "C" int zp_bucket_sweep_info(int nw, int* out) {
#define CALL(NW_) return zp_kernel_info(bucket_sweep_kernel<NW_>, SWEEP_THREADS, out)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return -1;
}

// state [W][T][B][3*NW] words -> out [3][NW][W*B] words.
extern "C" int zp_lane_reduce(int nw, const uint32_t* host_consts, const uint32_t* state,
                              uint32_t* out, int W, int T, int B, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  const unsigned blocks = (unsigned)(W * B);
#define CALL(NW_) \
  lane_reduce_kernel<NW_><<<blocks, REDUCE_THREADS, 0, stream>>>(state, out, W, T, B)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
