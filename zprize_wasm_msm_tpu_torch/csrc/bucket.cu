// Bucket sweep and lane reduction of the Pippenger MSM (CUDA, sm_90a).
//
// bucket_sweep_kernel replaces the TPU kernel
// zprize_wasm_msm_tpu/ops/msm/pl_bucket.py `_kernel` (main sweep), and
// lane_reduce_kernel replaces its tail steps and
// zprize_wasm_msm_tpu/ops/msm/pl_reduce.py `_lane_reduce_kernel`.  The TPU
// kernels are generic over the coordinate field (ops/field/ktower.py
// kfield), so they also run G2 over Fq2: here bucket_sweep2_kernel and the
// EXT = 2 instantiations of the lane reduction are those forms (a mixed add
// is 11 Fq2 products, 33 Fq products, on one thread's chain).
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
//   * roll-based tail steps  ->  a second kernel over evenly split lanes
//     (lane_reduce_kernel, its design below the sweep).
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
#include "par.cuh"

#define SWEEP_THREADS 64
#define REDUCE_THREADS 128
// Over Fq2 (G2): one warp a block, so that a block's shared slots (864
// bytes a thread at NW = 12) stay under the 48 KB of static shared memory.
#define SWEEP2_THREADS 32
#define REDUCE2_THREADS 32

static_assert(SWEEP2_THREADS <= FQ2_BLOCK && REDUCE2_THREADS <= FQ2_BLOCK,
              "group2.cuh's scratch covers one warp a block");

template <int EXT>
__host__ __device__ constexpr int reduce_threads() {
  return EXT == 1 ? REDUCE_THREADS : REDUCE2_THREADS;
}

// Shared slots of the partial in flight in the lane reduction (double
// buffered over Fq, one over Fq2: lane_reduce_kernel)
template <int EXT>
__host__ __device__ constexpr int reduce_slots() {
  return EXT == 1 ? 2 : 1;
}

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
  // steps: the last may be ragged, and a lane's steps past N are zero digits
  const int S = (N + T - 1) / T;
  auto digit = [&](int s) {
    const size_t n = (size_t)t + (size_t)s * T;
    return n < (size_t)N ? drow[n] : 0;
  };
  int d0 = digit(0);
  int d1 = digit(1);
  if (d0 != 0) fetch(0, 0, d0, true);
  cp_async_wait_all();
  bool carried = false;  // acc already holds step s's bucket (the hazard case)
  for (int s = 0; s < S; ++s) {
    const int cb = s & 1;
    const int d2 = digit(s + 2);
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

// The sweep over Fq2 (G2): the schedule of bucket_sweep_kernel with the Fq2
// mixed add of group2.cuh, which reads its operands from the thread's shared
// slots and writes the sum back there.  Shared bytes a thread, not
// registers, set the residency of this kernel (a thread may use all 255
// registers: 8 one-warp blocks fill the register file), so its slots are
// few: the accumulator (the bucket's slot), the point in two buffers and
// the add's two scratch elements, 864 bytes at NW = 12, 8 warps a SM (a
// second bucket buffer would cost 3 of them).  Hence:
//   * the point of step s+2 is in flight by cp.async while step s adds, and
//     the digit two steps ahead is in a register, as over Fq;
//   * the bucket of step s+1 is copied into the accumulator's slot after
//     step s has stored its sum, and waited for: one copy's latency a step,
//     against a mixed add of thousands of dependent instructions, while
//     the SM's other warps issue.  When step s+1 hits step s's bucket the
//     sum is already in the slot and nothing is copied (same-bucket
//     forwarding, now a skipped copy); a bucket stored at an earlier step is
//     copied after its store, by the same thread, in program order.
// The lanes (pippenger.fit_lanes) fill whole waves of this residency.
template <int NW>
__global__ void __launch_bounds__(SWEEP2_THREADS, 1)
    bucket_sweep2_kernel(const int32_t* __restrict__ digits, const uint32_t* __restrict__ X,
                         const uint32_t* __restrict__ Y, uint32_t* __restrict__ state, int W,
                         int T, int N, int B) {
  constexpr int EW = 2 * NW;  // words of an element
  constexpr int BW = 3 * EW;  // words of a bucket
  __shared__ Pt<NW, 2> sh_acc[SWEEP2_THREADS];
  __shared__ AffinePt<NW, 2> sh_pt[2][SWEEP2_THREADS];
  __shared__ __align__(16) Fe2<NW> sh_s[SWEEP2_THREADS][g2s::MIXED_SCRATCH];

  const int tid = threadIdx.x;
  const size_t gid = (size_t)blockIdx.x * blockDim.x + tid;
  if (gid >= (size_t)W * T) return;
  const int w = (int)(gid / T), t = (int)(gid % T);
  uint32_t* row = state + gid * (size_t)B * BW;
  Pt<NW, 2>& acc = sh_acc[tid];
  pt_identity<NW>(acc);
  for (int b = 0; b < B; ++b) pt_store_aos<NW>(row + (size_t)b * BW, acc);

  auto fetch_pt = [&](int buf, int s) {
    const size_t n = (size_t)t + (size_t)s * T;
    uint32_t* px = reinterpret_cast<uint32_t*>(&sh_pt[buf][tid].x);
    uint32_t* py = reinterpret_cast<uint32_t*>(&sh_pt[buf][tid].y);
#pragma unroll
    for (int k = 0; k < EW; ++k) {
      cp_async4(px + k, X + (size_t)k * N + n);
      cp_async4(py + k, Y + (size_t)k * N + n);
    }
  };
  auto fetch_bucket = [&](int d) {
    const uint32_t* src = row + (size_t)((d < 0 ? -d : d) - 1) * BW;
    uint32_t* dst = reinterpret_cast<uint32_t*>(&acc);
#pragma unroll
    for (int k = 0; k < BW; k += 4) cp_async16(dst + k, src + k);
  };

  const int32_t* drow = digits + (size_t)w * N;
  // steps: the last may be ragged, and a lane's steps past N are zero digits
  const int S = (N + T - 1) / T;
  auto digit = [&](int s) {
    const size_t n = (size_t)t + (size_t)s * T;
    return n < (size_t)N ? drow[n] : 0;
  };
  int d0 = digit(0);
  int d1 = digit(1);
  if (d0 != 0) {
    fetch_pt(0, 0);
    fetch_bucket(d0);
  }
  cp_async_commit();
  if (d1 != 0) fetch_pt(1, 1);
  cp_async_commit();
  cp_async_wait_group<1>();  // step 0's point and bucket
  for (int s = 0; s < S; ++s) {
    const int cb = s & 1;
    const int d2 = digit(s + 2);
    const int a0 = d0 < 0 ? -d0 : d0, a1 = d1 < 0 ? -d1 : d1;
    if (d0 != 0) {
      AffinePt<NW, 2>& p = sh_pt[cb][tid];
      if (d0 < 0) {
        Fe2<NW> y;
        sh_get<NW>(y, p.y);
        fe_neg<NW>(y, y);
        sh_put<NW>(p.y, y);
      }
      pt2_add_mixed_sh<NW>(acc, p.x, sh_s[tid]);
      pt_store_aos<NW>(row + (size_t)(a0 - 1) * BW, acc);
    }
    // step s+1's bucket, unless it is this step's (then its sum is in the slot)
    if (d1 != 0 && !(d0 != 0 && a1 == a0)) fetch_bucket(d1);
    cp_async_commit();
    if (d2 != 0) fetch_pt(cb, s + 2);  // step s's buffer is free
    cp_async_commit();
    cp_async_wait_group<1>();  // all but step s+2's point
    d0 = d1;
    d1 = d2;
  }
}

// Lane reduction: state [W][T][B][3*NW] -> out [3][NW][W*B], the sum over T
// of each (w, b).  Bound: operations (T-1 complete adds per bucket, 2.5 M
// at the full path); the state is read once (358 MB at the full path,
// 0.11 ms at 3.35 TB/s).  Like the sweep, each thread's adds are one
// dependent chain whose rate hardly depends on how many warps share the SM
// (chip_smoke.py times this kernel at several lane counts), so the time is
// the longest chain of any thread, and lanes past one wave of resident
// threads, or a wave left half empty, cost a whole chain more.  Hence a
// flat split:
//   * N lanes (the wrapper's choice: one wave of resident threads, and at
//     least one lane per bucket), lane g sums the contiguous partials
//     [g F / N, (g+1) F / N) of the F = W B T partials in bucket-major
//     order: every lane the same count to within one, at most two buckets
//     (a head piece and, past a bucket's end, a tail piece), each piece
//     started from its first partial;
//   * a 5-round segmented __shfl_up_sync scan of the lanes' last pieces
//     over the warp (a segment starts at every piece that starts a
//     bucket), the K7 pattern: a bucket whose pieces start and end inside
//     one warp is written out there; the warp's first bucket, if it began
//     in an earlier warp, and its last, if it goes on in the next, leave
//     one piece each in `pieces`, and lane_combine_kernel adds a bucket's
//     pieces across warps (one or two adds at the paths' shapes); a lane
//     parks its head in `pieces` while it sums its tail, so the loop holds
//     one running point;
//   * the add is the inlined complete add on the carry-chain product
//     (group.cuh pt_add_acc<NW, true>), its partial read in place from
//     shared memory, and only two counters live through the loop: the
//     kernel fits 168 registers without a spill, so 12 warps stay resident
//     per SM (the 64-bit product form is faster per add but spills there);
//   * the next partial (a contiguous 3 NW words) is copied by cp.async into
//     the thread's own double-buffered shared slots while the add runs.
// Static schedule, no atomics: the result is the same on every run.
// Over Fq2 (EXT = 2, G2) the same schedule runs with the piece being summed
// in a shared slot of the thread's own (par.cuh work_point) and group2.cuh's
// complete add, whose every Fq2 product goes through shared memory; one warp
// a block (REDUCE2_THREADS), so that a block's slots stay in static shared
// memory, and shared memory, not registers, sets the residency.  So over
// Fq2 the partials have ONE slot (SLOTS = 1), the pattern of K1 Fq2 and K7
// Fq2: the next partial is copied into it as soon as the add that read it
// has finished, and waited for at the next step, one copy's latency a step
// against a complete add of 14 Fq2 products while the SM's other warps
// issue.  That keeps 864 bytes a thread at NW = 12 (the piece, the slot and
// the add's three scratch elements): 8 one-warp blocks a SM, the register
// file's limit at <= 255 registers, where two slots (1 152 bytes) left 6,
// and _reduce_lanes then fills a wave of 33 792 lanes on 132 SMs.
template <int NW, int EXT, int SLOTS = reduce_slots<EXT>()>
__global__ void __launch_bounds__(reduce_threads<EXT>(), EXT == 1 ? 3 : 1)
    lane_reduce_kernel(const uint32_t* __restrict__ state, uint32_t* __restrict__ out,
                       uint32_t* __restrict__ pieces, int W, int T, int B, int N) {
  constexpr int BW = 3 * EXT * NW, RT = reduce_threads<EXT>();
  // each thread's slots, a point each, read in place by the adds
  __shared__ Pt<NW, EXT> sh[SLOTS][RT];
  const int tid = threadIdx.x;
  const int g = blockIdx.x * RT + tid;
  if (g >= N) return;  // whole warps: N is a multiple of 32
  // F partials of 3 NW words each fit device memory, so F < 2^31
  const int F = W * B * T;
  auto addr = [&](int f) {
    const int bk = f / T;
    return state + (((size_t)(bk / B) * T + f % T) * B + bk % B) * BW;
  };
  auto fetch = [&](int buf, const uint32_t* src) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(&sh[buf][tid]);
    if constexpr (BW % 4 == 0) {
#pragma unroll
      for (int k = 0; k < BW / 4; ++k) cp_async16(dst + 4 * k, src + 4 * k);
    } else {
#pragma unroll
      for (int k = 0; k < BW; ++k) cp_async4(dst + k, src + k);
    }
  };
  auto park = [&] { return pieces + ((size_t)(N / 32) * 2 + g) * BW; };  // this lane's head

  // the piece being summed: in registers over Fq, in a shared slot of its
  // own over Fq2 (par.cuh work_point, group2.cuh)
  Pt<NW, EXT> acc_own;
  Pt<NW, EXT>& acc = work_point<NW, EXT, RT>(acc_own, tid);
  pt_identity<NW>(acc);
  {
    const int s = (int)((long)g * F / N), e = (int)((long)(g + 1) * F / N);
    if (e > s) {
      const int split = (s / T + 1) * T;  // the first partial of the tail
      const uint32_t* src = addr(s);      // the partial in flight
      fetch(0, src);
      if constexpr (SLOTS == 2) {
        if (e > s + 1) {
          src = s + 1 == split ? addr(split) : src + (size_t)B * BW;
          fetch(1, src);
        }
      }
      cp_async_commit();
      cp_async_wait_all();
      acc = sh[0][tid];
      // two counters live through the loop: partials left, and steps to the
      // tail's first partial (never 0 when there is no tail in this lane)
      int left = e - s - 1, to_tail = split - s - 1;
      if constexpr (SLOTS == 2) {
        int buf = 1;
        for (; left > 0; --left, --to_tail, buf ^= 1) {
          if (left > 1) {
            src = to_tail == 1 ? addr(e - left + 1) : src + (size_t)B * BW;
            fetch(buf ^ 1, src);
          }
          cp_async_commit();
          if (to_tail == 0) {  // the tail begins: park the head
            pt_store_aos<NW>(park(), acc);
            pt_identity<NW>(acc);
          }
          pt_add_acc<NW, true>(acc, sh[buf][tid]);
          cp_async_wait_all();
        }
      } else {
        // one slot: the partial read by a step is copied in after the step
        // before has added, and waited for at the step
        if (e > s + 1) {
          src = s + 1 == split ? addr(split) : src + (size_t)B * BW;
          fetch(0, src);
          cp_async_commit();
        }
        for (; left > 0; --left, --to_tail) {
          cp_async_wait_all();
          if (to_tail == 0) {  // the tail begins: park the head
            pt_store_aos<NW>(park(), acc);
            pt_identity<NW>(acc);
          }
          pt_add_acc<NW, true>(acc, sh[0][tid]);
          if (left > 1) {  // the slot is free again
            src = to_tail == 1 ? addr(e - left + 1) : src + (size_t)B * BW;
            fetch(0, src);
            cp_async_commit();
          }
        }
      }
    }
  }
  // this lane's bounds again, read afresh (not kept through the loop)
  int gg;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(gg));
  gg += blockIdx.x * RT;
  const int s = (int)((long)gg * F / N), e = (int)((long)(gg + 1) * F / N);
  const int split = (s / T + 1) * T;

  // segmented inclusive scan of the lanes' last pieces over the warp, the
  // neighbour's piece read from its slot in shared memory (no copy in
  // registers); the add is symmetric, so V + o is o + V bit for bit.  Only
  // s, e and split live through the adds here too: every other value is
  // worked out where it is used.
  const bool flag = e > split || (e > s && s % T == 0);  // a bucket starts in this lane
  bool f = flag;
  for (int d = 1; d < 32; d <<= 1) {
    __syncwarp();
    sh[0][tid] = acc;
    __syncwarp();
    const bool fo = __shfl_up_sync(0xFFFFFFFFu, (int)f, d) != 0;
    if (tid % 32 >= d) {
      if (!f) pt_add_acc<NW, true>(acc, sh[0][tid - d]);
      f = f || fo;
    }
  }
  __syncwarp();
  sh[0][tid] = acc;  // lane l's run so far; lane l+1 reads it as its incoming run
  __syncwarp();
  const bool started_here = (__ballot_sync(0xFFFFFFFFu, flag) & ((1u << (tid % 32)) - 1)) != 0;
  auto slot = [&] { return pieces + (size_t)(g / 32) * 2 * BW; };
  auto head_bucket = [&] { return s < F ? s / T : W * B - 1; };
  const bool last_end = e > s && e % T == 0;  // the last piece ends its bucket
  if (tid % 32 == 31 && !last_end) pt_store_aos<NW>(slot() + BW, acc);  // goes on in the next warp
  // the head's run, where it ends in this lane: complete if it began here
  // or in an earlier lane of the warp, else the warp's first piece
  if (e > split) {
    if (last_end) pt_store_soa<NW>(out, (size_t)W * B, (size_t)head_bucket() + 1, acc);  // the tail
    pt_load_aos<NW>(acc, park());
    if (s % T != 0 && tid % 32 > 0) pt_add_acc<NW, true>(acc, sh[0][tid - 1]);  // lane 0: none
  }
  if (e > split || last_end) {
    if ((e > s && s % T == 0) || started_here)
      pt_store_soa<NW>(out, (size_t)W * B, (size_t)head_bucket(), acc);
    else
      pt_store_aos<NW>(slot(), acc);
  }
}

// The buckets whose pieces span warps: one thread per bucket adds the last
// piece of the warp where it begins, the whole-warp pieces after it and
// the first piece of the warp where it ends.
template <int NW, int EXT>
__global__ void __launch_bounds__(reduce_threads<EXT>())
    lane_combine_kernel(const uint32_t* __restrict__ pieces, uint32_t* __restrict__ out, int W,
                        int T, int B, int N) {
  constexpr int BW = 3 * EXT * NW, RT = reduce_threads<EXT>();
  const long nb = (long)W * B, F = nb * T;
  const long b = (long)blockIdx.x * RT + threadIdx.x;
  if (b >= nb) return;
  // the lane holding partial x: the largest g with g F / N <= x
  auto lane_of = [&](long x) { return ((x + 1) * N - 1) / F; };
  const long i0 = lane_of(b * T) / 32, i1 = lane_of((b + 1) * T - 1) / 32;
  if (i0 == i1) return;  // written by its warp
  Pt<NW, EXT> acc_own, p_own;
  Pt<NW, EXT>& acc = work_point<NW, EXT, 2 * RT>(acc_own, threadIdx.x);
  Pt<NW, EXT>& p = work_point<NW, EXT, 2 * RT>(p_own, RT + threadIdx.x);
  pt_load_aos<NW>(acc, pieces + (size_t)i0 * 2 * BW + BW);
  for (long i = i0 + 1; i < i1; ++i) {
    pt_load_aos<NW>(p, pieces + (size_t)i * 2 * BW + BW);
    pt_add_acc<NW, true>(acc, p);
  }
  pt_load_aos<NW>(p, pieces + (size_t)i1 * 2 * BW);
  pt_add_acc<NW, true>(acc, p);
  pt_store_soa<NW>(out, (size_t)nb, (size_t)b, acc);
}

// digits [W][N] int32, X / Y [EXT NW][N] words, state [W][T][B][3 EXT NW]
// words (scratch, fully written here); any N (lane t takes points t, t+T,
// ... below N).  Returns
// the CUDA error code of the launch (0 = launched).
extern "C" int zp_bucket_sweep(int nw, int ext, const uint32_t* host_consts,
                               const int32_t* digits, const uint32_t* X, const uint32_t* Y,
                               uint32_t* state, int W, int T, int N, int B, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  const size_t threads = (size_t)W * T;
  const int bt = ext == 1 ? SWEEP_THREADS : SWEEP2_THREADS;
  const unsigned blocks = (unsigned)((threads + bt - 1) / bt);
#define CALL(NW_, EXT_)                                                                        \
  if constexpr (EXT_ == 1)                                                                     \
    bucket_sweep_kernel<NW_><<<blocks, bt, 0, stream>>>(digits, X, Y, state, W, T, N, B);      \
  else                                                                                         \
    bucket_sweep2_kernel<NW_><<<blocks, bt, 0, stream>>>(digits, X, Y, state, W, T, N, B)
  ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

// out[0..4]: registers, local bytes, static shared bytes, resident blocks
// per SM of the sweep kernel of (nw, ext) (zp_kernel_info).
extern "C" int zp_bucket_sweep_info(int nw, int ext, int* out) {
#define CALL(NW_, EXT_)                                                            \
  if constexpr (EXT_ == 1) return zp_kernel_info(bucket_sweep_kernel<NW_>, SWEEP_THREADS, out); \
  else return zp_kernel_info(bucket_sweep2_kernel<NW_>, SWEEP2_THREADS, out)
  ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  return -1;
}

// state [W][T][B][3 EXT NW] words -> out [3][EXT NW][W*B] words over N lanes
// (a multiple of 32, at least W*B); pieces: scratch of 3 EXT NW words twice
// per warp (the warps' first and last pieces), then once per lane (parked
// heads).
template <int NW, int EXT>
static void lane_reduce_launch(const uint32_t* state, uint32_t* out, uint32_t* pieces, int W,
                               int T, int B, int N, cudaStream_t stream) {
  constexpr int RT = reduce_threads<EXT>();
  lane_reduce_kernel<NW, EXT><<<(unsigned)((N + RT - 1) / RT), RT, 0, stream>>>(
      state, out, pieces, W, T, B, N);
  if (N > 32)
    lane_combine_kernel<NW, EXT><<<(unsigned)(((long)W * B + RT - 1) / RT), RT, 0, stream>>>(
        pieces, out, W, T, B, N);
}

extern "C" int zp_lane_reduce(int nw, int ext, const uint32_t* host_consts,
                              const uint32_t* state, uint32_t* out, uint32_t* pieces, int W,
                              int T, int B, int N, void* stream_ptr) {
  if (N % 32 || N < W * B) return -2;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
#define CALL(NW_, EXT_) lane_reduce_launch<NW_, EXT_>(state, out, pieces, W, T, B, N, stream)
  ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

// out[0..4]: registers, local bytes, static shared bytes, resident blocks
// per SM of lane_reduce_kernel<nw, ext> (which = 0) or lane_combine_kernel
// (which = 1) (zp_kernel_info).
extern "C" int zp_lane_reduce_info(int nw, int ext, int which, int* out) {
#define CALL(NW_, EXT_)                                                                        \
  if (which == 1)                                                                              \
    return zp_kernel_info(lane_combine_kernel<NW_, EXT_>, reduce_threads<EXT_>(), out);         \
  return zp_kernel_info(lane_reduce_kernel<NW_, EXT_>, reduce_threads<EXT_>(), out)
  ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  return -1;
}
