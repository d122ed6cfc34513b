// Sweep and segmented scan of the sorted-runs bucket engine (CUDA, sm_90a).
//
// sorted_sweep_kernel replaces the TPU kernel
// zprize_wasm_msm_tpu/ops/msm/pl_sorted.py `_sweep` (body `_sweep_kernel`),
// and segscan_kernel replaces `_segscan` (body `_segscan_kernel`).
//
// The engine sorts every window's points by bucket, so equal buckets form
// contiguous runs, cuts the sorted stream of a window into T chunks, and
// gives every (window, chunk) ONE running accumulator: no bucket array, so
// the bucket count is unbounded (c = 10..16).  What the TPU versions are
// shaped by, and what takes its place here:
//   * sweep: a sequential grid, one step per stream position, 1024 lanes
//     wide, the accumulators carried in on-chip memory, one window per call,
//     every slot of an (N,)-slot output written (dead writes included), the
//     sorted points gathered into a copy per window beforehand  ->  thread
//     (w, t) walks its chunk itself with the accumulator in registers, all
//     windows in one launch; it reads each point THROUGH the sort
//     permutation (no gathered copy), takes the sign from a bit of meta
//     (no negated copy of Y), and writes a partial sum only at a run
//     boundary, straight into its compacted slot (the host numbers the
//     flushes with a cumulative sum before the launch), so no (N,)-slot
//     output exists;
//   * segscan: ceil(log2 T) Hillis-Steele rounds of a masked complete add
//     over ALL K entries, a grid step per round, lanes shifted with rolls,
//     the whole array resident on chip (hence a size cap and a fallback
//     above it)  ->  one thread per segment head walks the segment's pieces
//     (<= T, typically 1-3) and stores the running sum: exactly one add
//     per piece beyond the first, no rounds, any K.  The host gives every
//     unused entry a segment id of its own, so padding costs a copy.
//
// Bound: operations.  The sweep does one mixed add (11 Montgomery products
// of 2 NW^2 + NW multiply-adds) per nonzero digit against ~100 + 8 bytes
// read; the points are stored point-contiguous ([N][2 NW] words, 16-byte
// loads) because the permutation makes every read a random one and a whole
// point then fills whole 32-byte sectors.  The scan is a few thousand adds
// with a short serial depth: latency.

#include <cuda_runtime.h>

#include "group.cuh"

#define SORTED_THREADS 64

#define META_BOUNDARY 1  // run (or chunk) ends after this position
#define META_ZERO 2      // zero digit: the point contributes nothing
#define META_NEG 4       // negative digit: add (x, -y)

template <int NW>
struct __align__(16) AffinePt {
  Fe<NW> x, y;
};

// pts [N][2*NW] words (x words, y words per point); perm, meta, slot [W][N]
// in sorted stream order; out [3][NW][W*K] words, pre-filled by the caller
// (identity) because only flushed slots are written.  Thread (w, t) walks
// positions [t*steps, (t+1)*steps) of window w, N = T * steps.
template <int NW>
__global__ void __launch_bounds__(SORTED_THREADS)
    sorted_sweep_kernel(const uint32_t* __restrict__ pts, const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ meta, const int32_t* __restrict__ slot,
                        uint32_t* __restrict__ out, int W, int T, int steps, int K) {
  const size_t gid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (size_t)W * T) return;
  const int w = (int)(gid / T), t = (int)(gid % T);
  const size_t base = (size_t)w * T * steps + (size_t)t * steps;

  Pt<NW> acc;
  pt_identity<NW>(acc);
  for (int j = 0; j < steps; ++j) {
    const int m = meta[base + j];
    if (!(m & META_ZERO)) {
      AffinePt<NW> p;
      const uint32_t* src = pts + (size_t)perm[base + j] * (2 * NW);
      if constexpr ((2 * NW) % 4 == 0) {
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        uint4* d4 = reinterpret_cast<uint4*>(&p);
#pragma unroll
        for (int k = 0; k < (2 * NW) / 4; ++k) d4[k] = s4[k];
      } else {
        uint32_t* d = reinterpret_cast<uint32_t*>(&p);
#pragma unroll
        for (int k = 0; k < 2 * NW; ++k) d[k] = src[k];
      }
      if (m & META_NEG) fe_neg<NW>(p.y, p.y);
      pt_add_mixed<NW>(&acc, &acc, &p.x, &p.y);
    }
    if (m & META_BOUNDARY) {
      const int s = slot[base + j];
      if (s >= 0) pt_store_soa<NW>(out, (size_t)W * K, (size_t)w * K + s, acc);
      pt_identity<NW>(acc);
    }
  }
}

// P, out [3][NW][W*K] words; seg [W][K], non-decreasing within a row.
// out = the inclusive segmented scan of P under the group add: the last
// entry of every segment holds the segment's sum.
template <int NW>
__global__ void __launch_bounds__(SORTED_THREADS)
    segscan_kernel(const uint32_t* __restrict__ P, const int32_t* __restrict__ seg,
                   uint32_t* __restrict__ out, int W, int K) {
  const size_t gid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)W * K;
  if (gid >= n) return;
  const int k = (int)(gid % K);
  const int s = seg[gid];
  if (k > 0 && seg[gid - 1] == s) return;  // not the head of its segment
  Pt<NW> acc, p;
  pt_load_soa<NW>(acc, P, n, gid);
  pt_store_soa<NW>(out, n, gid, acc);
  for (int j = 1; k + j < K && seg[gid + j] == s; ++j) {
    pt_load_soa<NW>(p, P, n, gid + j);
    pt_add<NW>(&acc, &acc, &p);
    pt_store_soa<NW>(out, n, gid + j, acc);
  }
}

static int set_consts(const uint32_t* host_consts, cudaStream_t stream) {
  return (int)cudaMemcpyToSymbolAsync(c_fc, host_consts, sizeof(FieldConsts), 0,
                                      cudaMemcpyHostToDevice, stream);
}

// Returns the CUDA error code of the launch (0 = launched).
extern "C" int zp_sorted_sweep(int nw, const uint32_t* host_consts, const uint32_t* pts,
                               const int32_t* perm, const int32_t* meta, const int32_t* slot,
                               uint32_t* out, int W, int T, int steps, int K,
                               void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = set_consts(host_consts, stream);
  if (err) return err;
  const size_t threads = (size_t)W * T;
  const unsigned blocks = (unsigned)((threads + SORTED_THREADS - 1) / SORTED_THREADS);
#define CALL(NW_)                                                                         \
  sorted_sweep_kernel<NW_><<<blocks, SORTED_THREADS, 0, stream>>>(pts, perm, meta, slot, \
                                                                  out, W, T, steps, K)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

extern "C" int zp_segscan(int nw, const uint32_t* host_consts, const uint32_t* P,
                          const int32_t* seg, uint32_t* out, int W, int K, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = set_consts(host_consts, stream);
  if (err) return err;
  const size_t threads = (size_t)W * K;
  const unsigned blocks = (unsigned)((threads + SORTED_THREADS - 1) / SORTED_THREADS);
#define CALL(NW_) segscan_kernel<NW_><<<blocks, SORTED_THREADS, 0, stream>>>(P, seg, out, W, K)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
