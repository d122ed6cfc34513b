// Sweep and segmented scan of the sorted-runs bucket engine (CUDA, sm_90a).
//
// sorted_sweep_kernel replaces the TPU kernel
// zprize_wasm_msm_tpu/ops/msm/pl_sorted.py `_sweep` (body `_sweep_kernel`),
// and segscan_tile_kernel + segscan_fix_kernel replace `_segscan` (body
// `_segscan_kernel`).
//
// The engine sorts every window's points by bucket, so equal buckets form
// contiguous runs, cuts the sorted stream of a window into T chunks, and
// gives every (window, chunk) ONE running sum: no bucket array, so the
// bucket count is unbounded (c = 10..16).  What the TPU versions are
// shaped by, and what takes its place here:
//   * sweep: a sequential grid, one step per stream position, 1024 lanes
//     wide, the accumulators carried in on-chip memory, one window per call,
//     every slot of an (N,)-slot output written (dead writes included), the
//     sorted points gathered into a copy per window beforehand  ->  a warp
//     per (window, chunk), all windows in one launch; points are read
//     THROUGH the sort permutation (no gathered copy), the sign comes from
//     a bit of meta (no negated copy of Y), and a partial sum is written
//     only at a run boundary, straight into its compacted slot (the host
//     numbers the flushes with a cumulative sum before the launch), so no
//     (N,)-slot output exists;
//   * segscan: ceil(log2 T) Hillis-Steele rounds of a masked complete add
//     over ALL K entries, a grid step per round, lanes shifted with rolls,
//     the whole array resident on chip (hence a size cap and a fallback
//     above it)  ->  tiles of 32 entries a one-warp block and levels of
//     tiles on growing strides, each lane adding only while its segment
//     reaches back (its design above segscan_tile_kernel): the dependent
//     adds follow from K, not from the segments' lengths, and any K fits.
//
// What bounds the sweep on the H100, and what the design does about it.
// The work is one mixed add (11 Montgomery products) per nonzero digit:
// integer issue.  One thread per chunk gives only W*T threads (15 360 at
// path B's shape, under one warp per scheduler), each step of which waits
// on meta, then perm, then a random 96-byte point.  Hence:
//   * each chunk is split across the S = 32 lanes of a warp: lane k walks
//     ceil(steps / S) consecutive positions (the ragged end masked), 32x the
//     threads;
//   * a run that lies wholly inside a lane's sub-chunk is flushed by that
//     lane, as before.  A run that crosses sub-chunk borders is combined
//     after the walk: every lane holds its carry (the sum after its last
//     boundary, or of its whole sub-chunk when it has none) and the sum up
//     to its first boundary (its head piece, parked in shared memory).  A
//     segmented inclusive scan of the carries over the warp (5 rounds of
//     shuffles and one complete add each, segments starting at lanes with a
//     boundary) gives every lane the sum of the crossing run before it, and
//     the lane adds its head piece to that and makes the run's one flush.
//     The scan has log2(S) depth, not S-1: at path B's shape a run spans
//     ~4 096 positions and crosses every lane of a chunk, so a serial
//     combine would take as long as the walk;
//   * prefetch: each lane stages its next TILE positions of perm / meta /
//     slot into shared memory with cp.async (one tile ahead), and copies its
//     next point through perm with cp.async one step ahead (double
//     buffered), so a step's add runs while the next step's data arrive.
// Points are point-contiguous ([n][2 NW] words): a permuted read is whole
// 16-byte copies and 32-byte sectors.  The adds are the inlined mixed add
// of group.cuh; the combine's complete adds (6 per lane, against ~64 mixed
// adds per lane at path B's shape) are group.cuh's out-of-line pt_add, in
// its carry-chain form (see pt_add).
//
// Over Fq2 (G2; the TPU kernels take the coordinate field from
// ops/field/ktower.py kfield, so `_sweep` and `_segscan` run G2 too):
// sorted_sweep2_kernel, the same schedule on the group ops of group2.cuh;
// the scan is one pair of kernels for both fields.
// A point is 72 words at NW = 12, so nothing of a point lives in registers:
// every Fq2 product reads and writes shared memory (see group2.cuh), the
// accumulator is the thread's own shared slot, and the
// scan's carries travel through shared memory instead of shuffles.  Blocks
// are one warp (FQ2_BLOCK), so that a block's slots fit static shared
// memory; shared bytes a thread, not registers, set the residency (a
// thread may use all 255 registers: 8 one-warp blocks fill the register
// file), so the sweep keeps 864 bytes a thread at NW = 12, 8 warps a SM
// (a second point buffer would cost 2 of them), hence:
//   * one point slot, which after the walk is the thread's exchange slot of
//     the scan (a union); the next position's point is copied into it as
//     soon as the add that read the slot has finished, and waited for at
//     the next step: one copy's latency a step, against a mixed add of
//     thousands of dependent instructions, while the SM's other warps issue;
//   * perm, meta and slot of the positions ahead in registers, loaded a step
//     before they are needed (no staged tiles);
//   * three scratch elements (group2.cuh: the complete add of the scan needs
//     three beside the element its step loop holds in registers);
//   * the head piece is not parked in shared memory: every flush, the first
//     included, is stored to its slot in `out`, and the first is read back
//     from there once, after the scan, to add the run that comes into it.

#include <cuda_runtime.h>

#include "async.cuh"
#include "group2.cuh"
#include "limbs.cuh"

#define SORTED_THREADS 64  // two warps: two (window, chunk) pairs per block
#define SUBCHUNKS 32       // S: lanes per chunk, one warp
#define TILE 8             // stream positions a lane stages per copy group

#define META_BOUNDARY 1  // run (or chunk) ends after this position
#define META_ZERO 2      // zero digit: the point contributes nothing
#define META_NEG 4       // negative digit: add (x, -y)

template <int NW>
__device__ __forceinline__ void pt_shfl_up(Pt<NW>& r, const Pt<NW>& a, int d) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&a);
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int k = 0; k < 3 * NW; ++k) o[k] = __shfl_up_sync(0xFFFFFFFFu, s[k], d);
}

// pts [N][2*NW] words (x words, y words per point); perm, meta, slot [W][N]
// in sorted stream order; out [3][NW][W*K] words, pre-filled by the caller
// (identity) because only flushed slots are written.  Warp (w, t) owns
// positions [t*steps, (t+1)*steps) of window w, N = T * steps; its lane k
// walks the k-th sub-chunk of ceil(steps / S) positions.
template <int NW>
__global__ void __launch_bounds__(SORTED_THREADS)
    sorted_sweep_kernel(const uint32_t* __restrict__ pts, const int32_t* __restrict__ perm,
                        const int32_t* __restrict__ meta, const int32_t* __restrict__ slot,
                        uint32_t* __restrict__ out, int W, int T, int steps, int K) {
  constexpr int PC = (2 * NW) / 4;  // 16-byte chunks of a point
  __shared__ uint4 sh_pt[2][PC][SORTED_THREADS];
  __shared__ int32_t sh_ix[2][3][TILE][SORTED_THREADS];  // perm, meta, slot
  __shared__ uint32_t sh_head[3 * NW][SORTED_THREADS];

  const int tid = threadIdx.x, lane = tid % SUBCHUNKS;
  const size_t chunk = ((size_t)blockIdx.x * blockDim.x + tid) / SUBCHUNKS;
  if (chunk >= (size_t)W * T) return;  // whole warps only
  const int w = (int)(chunk / T);
  const int sub = (steps + SUBCHUNKS - 1) / SUBCHUNKS;
  const int lo = min(lane * sub, steps), n = min(lo + sub, steps) - lo;
  const size_t p0 = chunk * steps + lo;
  const size_t nout = (size_t)W * K;

  auto stage = [&](int buf, int j0) {
    for (int i = 0; i < TILE && j0 + i < n; ++i) {
      cp_async4(&sh_ix[buf][0][i][tid], perm + p0 + j0 + i);
      cp_async4(&sh_ix[buf][1][i][tid], meta + p0 + j0 + i);
      cp_async4(&sh_ix[buf][2][i][tid], slot + p0 + j0 + i);
    }
  };
  auto fetch = [&](int buf, int idx) {
    const uint32_t* src = pts + (size_t)idx * (2 * NW);
#pragma unroll
    for (int k = 0; k < PC; ++k) cp_async16(&sh_pt[buf][k][tid], src + 4 * k);
  };

  Pt<NW> acc;
  pt_identity<NW>(acc);
  bool has_b = false;  // a boundary lies in this sub-chunk
  int first_slot = -1;
  if (n > 0) {
    stage(0, 0);
    cp_async_wait_all();
    if (!(sh_ix[0][1][0][tid] & META_ZERO)) fetch(0, sh_ix[0][0][0][tid]);
    cp_async_wait_all();
  }
  for (int j = 0; j < n; ++j) {
    const int tb = (j / TILE) & 1, ti = j % TILE, cb = j & 1;
    const int m = sh_ix[tb][1][ti][tid], sl = sh_ix[tb][2][ti][tid];
    // the next tile lands by the end of this step, before any step reads it
    if (ti == 0 && j + TILE < n) stage(tb ^ 1, j + TILE);
    if (j + 1 < n) {
      const int tb1 = ((j + 1) / TILE) & 1, ti1 = (j + 1) % TILE;
      if (!(sh_ix[tb1][1][ti1][tid] & META_ZERO)) fetch(cb ^ 1, sh_ix[tb1][0][ti1][tid]);
    }
    cp_async_commit();
    if (!(m & META_ZERO)) {
      AffinePt<NW> p;
      uint4* p4 = reinterpret_cast<uint4*>(&p);
#pragma unroll
      for (int k = 0; k < PC; ++k) p4[k] = sh_pt[cb][k][tid];
      if (m & META_NEG) fe_neg<NW>(p.y, p.y);
      pt_add_mixed<NW>(acc, p.x, p.y);
    }
    if (m & META_BOUNDARY) {
      if (!has_b) {  // the head piece: its run may have begun in an earlier lane
        has_b = true;
        first_slot = sl;
        const uint32_t* a = reinterpret_cast<const uint32_t*>(&acc);
#pragma unroll
        for (int k = 0; k < 3 * NW; ++k) sh_head[k][tid] = a[k];
      } else if (sl >= 0) {
        pt_store_soa<NW>(out, nout, (size_t)w * K + sl, acc);
      }
      pt_identity<NW>(acc);
    }
    cp_async_wait_all();
  }

  // Segmented inclusive scan of the carries over the warp: a segment starts
  // at every lane with a boundary (its carry begins a new run).
  Pt<NW> v = acc, o;
  bool f = has_b;
  for (int d = 1; d < SUBCHUNKS; d <<= 1) {
    pt_shfl_up<NW>(o, v, d);
    const bool fo = __shfl_up_sync(0xFFFFFFFFu, (int)f, d) != 0;
    if (lane >= d) {
      if (!f) pt_add<NW, true>(&v, &o, &v);
      f = f || fo;
    }
  }
  // lane k's incoming run: the scan up to lane k - 1
  pt_shfl_up<NW>(o, v, 1);
  if (lane == 0) pt_identity<NW>(o);
  if (has_b && first_slot >= 0) {
    Pt<NW> h;
    uint32_t* a = reinterpret_cast<uint32_t*>(&h);
#pragma unroll
    for (int k = 0; k < 3 * NW; ++k) a[k] = sh_head[k][tid];
    pt_add<NW, true>(&h, &o, &h);
    pt_store_soa<NW>(out, nout, (size_t)w * K + first_slot, h);
  }
}

// The thread's shared slot of the Fq2 sweep: the walk's point, the scan's
// exchange slot after it.
template <int NW>
union Sweep2Slot {
  AffinePt<NW, 2> pt;
  Pt<NW, 2> ex;
};

// The head's read-back and store after the scan, a word at a time in a
// loop that is not unrolled: ptxas holds an unrolled copy (pt_load_soa /
// pt_store_soa) of the whole 72-word point in registers there and spills
// 48 bytes at NW = 12.  They run once a lane.
template <int NW>
__device__ __forceinline__ void pt2_get_soa(Pt<NW, 2>& a, const uint32_t* base, size_t n,
                                            size_t i) {
  uint32_t* d = reinterpret_cast<uint32_t*>(&a);
#pragma unroll 1
  for (int k = 0; k < 6 * NW; ++k) d[k] = base[(size_t)k * n + i];
}

template <int NW>
__device__ __forceinline__ void pt2_put_soa(uint32_t* base, size_t n, size_t i,
                                            const Pt<NW, 2>& a) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&a);
#pragma unroll 1
  for (int k = 0; k < 6 * NW; ++k) base[(size_t)k * n + i] = s[k];
}

// sorted_sweep_kernel over Fq2: pts [N][4 NW] words (x's c0, c1 words, then
// y's), perm, meta, slot [W][N], out [3][2 NW][W*K] words pre-filled with
// the identity.  One block (one warp) per (window, chunk); the same walk,
// flushes and segmented scan as the Fq form.  A lane's perm, meta and slot
// of the next position are loaded into registers a step ahead; its point is
// copied into its one point slot (cp.async) when the slot is free, right
// after the step before has added, and waited for before the add.
template <int NW>
__global__ void __launch_bounds__(FQ2_BLOCK, 1)
    sorted_sweep2_kernel(const uint32_t* __restrict__ pts, const int32_t* __restrict__ perm,
                         const int32_t* __restrict__ meta, const int32_t* __restrict__ slot,
                         uint32_t* __restrict__ out, int W, int T, int steps, int K) {
  static_assert(FQ2_BLOCK == SUBCHUNKS, "a block is the warp of one chunk");
  constexpr int PW = 4 * NW;  // words of an affine Fq2 point
  __shared__ Sweep2Slot<NW> sh_slot[FQ2_BLOCK];
  __shared__ Pt<NW, 2> sh_acc[FQ2_BLOCK];

  const int lane = threadIdx.x;
  const size_t chunk = blockIdx.x;
  if (chunk >= (size_t)W * T) return;  // whole blocks only
  const int w = (int)(chunk / T);
  const int sub = (steps + SUBCHUNKS - 1) / SUBCHUNKS;
  const int lo = min(lane * sub, steps), n = min(lo + sub, steps) - lo;
  const size_t p0 = chunk * steps + lo;
  const size_t nout = (size_t)W * K;
  Fe2<NW>* S = stage_elems<NW>();

  auto fetch = [&](int idx) {
    const uint32_t* src = pts + (size_t)idx * PW;
    uint32_t* dst = reinterpret_cast<uint32_t*>(&sh_slot[lane].pt);
#pragma unroll
    for (int k = 0; k < PW; k += 4) cp_async16(dst + k, src + k);
    cp_async_commit();
  };

  Pt<NW, 2>& acc = sh_acc[lane];
  pt_identity<NW>(acc);
  bool has_b = false;  // a boundary lies in this sub-chunk
  int first_slot = -1;
  // position j's meta, perm index and slot; position j+1's meta and perm
  // index, loaded one step ahead
  int m = n > 0 ? meta[p0] : 0, sl = n > 0 ? slot[p0] : 0;
  int m1 = n > 1 ? meta[p0 + 1] : 0, i1 = n > 1 ? perm[p0 + 1] : 0;
  if (n > 0 && !(m & META_ZERO)) fetch(perm[p0]);
  for (int j = 0; j < n; ++j) {
    const int sl1 = j + 1 < n ? slot[p0 + j + 1] : 0;
    const int m2 = j + 2 < n ? meta[p0 + j + 2] : 0, i2 = j + 2 < n ? perm[p0 + j + 2] : 0;
    if (!(m & META_ZERO)) {
      cp_async_wait_all();
      AffinePt<NW, 2>& p = sh_slot[lane].pt;
      if (m & META_NEG) {
        Fe2<NW> y;
        sh_get<NW>(y, p.y);
        fe_neg<NW>(y, y);
        sh_put<NW>(p.y, y);
      }
      pt2_add_mixed_sh<NW>(acc, p.x, S);
    }
    if (j + 1 < n && !(m1 & META_ZERO)) fetch(i1);  // the slot is free again
    if (m & META_BOUNDARY) {
      if (!has_b) {  // the head piece: its run may have begun in an earlier lane
        has_b = true;
        first_slot = sl;
      }
      if (sl >= 0) pt_store_soa<NW>(out, nout, (size_t)w * K + sl, acc);
      pt_identity<NW>(acc);
    }
    m = m1;
    sl = sl1;
    m1 = m2;
    i1 = i2;
  }

  // Segmented inclusive scan of the carries over the warp, each round's
  // values exchanged through the lanes' slots (the point slots are free
  // once every lane has left the walk: the first __syncwarp).
  bool f = has_b;
  for (int d = 1; d < SUBCHUNKS; d <<= 1) {
    __syncwarp();
    sh_slot[lane].ex = acc;
    __syncwarp();
    const bool fo = __shfl_up_sync(0xFFFFFFFFu, (int)f, d) != 0;
    if (lane >= d) {
      if (!f) pt2_add_sh<NW>(acc, sh_slot[lane - d].ex, S);
      f = f || fo;
    }
  }
  __syncwarp();
  sh_slot[lane].ex = acc;  // lane k's run so far; lane k+1's incoming run
  __syncwarp();
  // the head's run: its stored piece plus the run coming in from the lanes
  // before (none for lane 0)
  if (has_b && first_slot >= 0 && lane > 0) {
    const size_t i = (size_t)w * K + first_slot;
    pt2_get_soa<NW>(acc, out, nout, i);
    pt2_add_sh<NW>(acc, sh_slot[lane - 1].ex, S);
    pt2_put_soa<NW>(out, nout, i, acc);
  }
}

// The segmented scan (K8): a fixed schedule of log depth, whatever the
// segments' lengths.  One thread a segment head walking its segment takes as
// long as the longest segment's chain of adds while the card idles: 11 adds
// at path B's shape and 150 over Fq2 at path G2-sorted's, but 512 over Fq
// and 1 024 over Fq2 when one bucket spans every chunk (scalars that are all
// 0 or 1, as a Groth16 witness has).  Here the K entries of a row are cut
// into tiles of SCAN_TILE = 32 in levels:
//   * level 0 scans every tile of the entries, a one-warp block a tile
//     (segscan_tile_kernel): segmented Hillis-Steele over the warp (K7's
//     carry scan).  A lane adds in round d only while its segment reaches
//     back d entries inside the tile, and the warp stops after the round its
//     deepest lane needs: a tile of singletons costs a copy in and out;
//   * level L + 1 takes the last entry of every whole tile of level L (its
//     carry: the tile's part of its last segment) and scans those the same
//     way, in place, until a level fits one tile.  Level L's elements are
//     the entries (i + 1) 32^L - 1, and two of them belong together exactly
//     when their segment ids are equal (ids do not decrease along a row), so
//     every level is the same segmented scan on another stride;
//   * from the top level down, every tile whose first segment began in an
//     earlier tile adds, on each of its entries of that segment, the entry
//     just before the tile once (segscan_fix_kernel): that entry is final,
//     being the last of a whole tile one level up.  The last entry of a
//     whole tile is already final and is left alone.
// At K = 1 536 (paths B and G2-sorted): 48 tiles a row, then 48 carries in
// two tiles, then one; the dependent adds are at most 5 + 5 + 1 + 1 = 12,
// against one add a piece of the longest segment before.  No host
// synchronisation and no launch shape taken from the data: the levels
// follow from K alone.
//
// One kernel pair runs every level and fix-up of both fields, over the
// level's stride: each lane keeps its running point and its exchange slot in
// shared memory, and a round's values pass through the slots.  Over Fq2 (72
// words a point at NW = 12) beside group2.cuh's one-lane complete add and
// its three scratch elements: 864 bytes a thread, 8 one-warp blocks a SM
// (the register file's limit at <= 255 registers, as K1 Fq2 and K7 Fq2).
// Over Fq the add is group.cuh's inlined one (pt_add_acc) on the 64-bit-row
// product: its shorter dependent path took 13 % off the scan against the
// carry chains (csrc/diag/ab_fq2_reductions.py, edit scan_fq_carry_chains).
// Points kept in registers and passed by shuffles (K7's carry scan) were no
// faster over Fq, and spilled with that product at NW = 12.
// 41 472 Fq2 entries at path G2-sorted's shape are 1 296 blocks at level 0,
// against 1 056 resident.  Blocks go tile-major (block b takes tile b / W
// of row b % W): the host numbers a row's flushes from its first entry and
// leaves the padding ids at its end, so a second wave takes the last tiles
// of every row, mostly padding, and the long segments of any row start in
// the first.  The levels above hold at most W K / 32 points on a nearly
// idle card; a level-parallel add there (par.cuh, 8 lanes a point) was timed
// against the one-lane form over Fq2 (csrc/diag/ab_fq2_reductions.py) and
// saved too little of the scan to keep a second kernel pair.
// The scan reads its pieces and writes its sums as the package's 16-bit
// limbs (limbs.cuh): packing the pieces to words before the launch and
// unpacking after it were a large part of the wrapper's time.
#define SCAN_TILE 32  // elements a tile

// The product of the scan's complete add: over Fq the 64-bit rows
// (field.cuh fe_mul, the shorter dependent path: a round waits on its
// adds), not the carry chains of the sweeps; over Fq2 the add has one.
template <int EXT>
__device__ __forceinline__ constexpr bool scan_carry_chains() {
  return EXT == 2;
}

// A point's words from limbs and back: unrolled over Fq (every load in
// flight at once), a word at a time in a loop that is not unrolled over Fq2
// (an unrolled copy of a 72-word point is held in registers).
template <int NW, int EXT>
__device__ __forceinline__ void pt_get_limbs(Pt<NW, EXT>& a, const Limbs& in, uint32_t n,
                                             uint32_t i) {
  uint32_t* d = reinterpret_cast<uint32_t*>(&a);
  if constexpr (EXT == 1) {
#pragma unroll
    for (int k = 0; k < 3 * NW; ++k) d[k] = limb_word<NW>(in, k, n, i);
  } else {
#pragma unroll 1
    for (int k = 0; k < 3 * EXT * NW; ++k) d[k] = limb_word<EXT * NW>(in, k, n, i);
  }
}

template <int NW, int EXT>
__device__ __forceinline__ void pt_put_limbs(int64_t* out, uint32_t n, uint32_t i,
                                             const Pt<NW, EXT>& a) {
  const uint32_t* d = reinterpret_cast<const uint32_t*>(&a);
  if constexpr (EXT == 1) {
#pragma unroll
    for (int k = 0; k < 3 * NW; ++k) limb_put(out, k, n, i, d[k]);
  } else {
#pragma unroll 1
    for (int k = 0; k < 3 * EXT * NW; ++k) limb_put(out, k, n, i, d[k]);
  }
}

// The sums, [3][2 EXT NW][n] limbs, as the scan's next input.
template <int NW, int EXT>
__host__ __device__ __forceinline__ Limbs scan_limbs(const int64_t* out, uint32_t n) {
  constexpr uint32_t CL = 2 * EXT * NW;  // limbs of a coordinate
  return Limbs{out, out + CL * n, out + 2 * CL * n};
}

// Level (n, s): n elements a row, element i at entry (i + 1) s - 1 (level
// 0: n = K, s = 1).  Reads `in` (level 0: the pieces; above: the sums in
// out, in place) and writes the tile's sums to out.  Grid: W * ceil(n /
// 32) one-warp blocks.
template <int NW, int EXT>
__global__ void __launch_bounds__(SCAN_TILE, 1)
    segscan_tile_kernel(Limbs in, const int32_t* __restrict__ seg, int64_t* out, int W, int K,
                        int n, int s) {
  static_assert(FQ2_BLOCK == SCAN_TILE, "a block is the warp of one tile");
  __shared__ Pt<NW, EXT> sh_acc[SCAN_TILE], sh_ex[SCAN_TILE];
  const int lane = threadIdx.x;
  // tile-major: block b takes tile b / W of row b % W
  const int w = blockIdx.x % W, i = (int)(blockIdx.x / W) * SCAN_TILE + lane;
  const bool live = i < n;  // the last tile of a row may be ragged
  const uint32_t nout = (uint32_t)W * K, e = (uint32_t)w * K + (uint32_t)(i + 1) * s - 1;
  const int id = live ? seg[e] : -1;
  // reach: how far this lane's segment goes back inside the tile
  const int before = __shfl_up_sync(0xFFFFFFFFu, id, 1);
  const unsigned starts = __ballot_sync(0xFFFFFFFFu, lane == 0 || before != id);
  const int reach = live ? lane - (31 - __clz(starts & (0xFFFFFFFFu >> (31 - lane)))) : 0;
  const int top = __reduce_max_sync(0xFFFFFFFFu, reach);
  Pt<NW, EXT>& acc = sh_acc[lane];
  if (live) pt_get_limbs<NW>(acc, in, nout, e);
  for (int d = 1; d <= top; d <<= 1) {
    __syncwarp();
    sh_ex[lane] = acc;
    __syncwarp();
    if (reach >= d) pt_add_acc<NW, scan_carry_chains<EXT>()>(acc, sh_ex[lane - d]);
  }
  if (live) pt_put_limbs<NW>(out, nout, e, acc);
}

// The fix-up of level (n, s) once the level above is final: tile t >= 1
// of a row whose first segment began before it adds its element 32 t - 1
// (final) to each of its elements of that segment but a whole tile's
// last.  Grid: W * (ceil(n / 32) - 1) one-warp blocks, n > 32.
template <int NW, int EXT>
__global__ void __launch_bounds__(SCAN_TILE, 1)
    segscan_fix_kernel(const int32_t* __restrict__ seg, int64_t* out, int W, int K, int n, int s) {
  __shared__ Pt<NW, EXT> sh_acc[SCAN_TILE];
  __shared__ Pt<NW, EXT> sh_in;
  const int lane = threadIdx.x;
  const int w = blockIdx.x % W, i0 = (int)(blockIdx.x / W + 1) * SCAN_TILE;  // tile-major
  const uint32_t nout = (uint32_t)W * K, row = (uint32_t)w * K;
  auto at = [&](int i) { return row + (uint32_t)(i + 1) * s - 1; };
  const int id = seg[at(i0 - 1)];
  if (seg[at(i0)] != id) return;  // the tile's first segment begins in it: the whole block
  const int i = i0 + lane;
  const Limbs sums = scan_limbs<NW, EXT>(out, nout);
  if (lane == 0) pt_get_limbs<NW>(sh_in, sums, nout, at(i0 - 1));
  __syncwarp();
  if (lane == SCAN_TILE - 1 || i >= n || seg[at(i)] != id) return;
  Pt<NW, EXT>& acc = sh_acc[lane];
  pt_get_limbs<NW>(acc, sums, nout, at(i));
  pt_add_acc<NW, scan_carry_chains<EXT>()>(acc, sh_in);
  pt_put_limbs<NW>(out, nout, at(i), acc);
}

// The levels of the scan over K entries: n[l] elements at stride s[l];
// returns their count (level l + 1 exists while level l spans tiles).
static int scan_levels(int K, int* n, int* s) {
  int L = 0;
  n[0] = K;
  s[0] = 1;
  while (n[L] > SCAN_TILE) {
    n[L + 1] = n[L] / SCAN_TILE;
    s[L + 1] = s[L] * SCAN_TILE;
    ++L;
  }
  return L + 1;
}

// Entry points take the field's word count and extension degree (1: Fq,
// 2: Fq2).  Each returns the CUDA error code of the launch (0 = launched).
extern "C" int zp_sorted_sweep(int nw, int ext, const uint32_t* host_consts,
                               const uint32_t* pts, const int32_t* perm, const int32_t* meta,
                               const int32_t* slot, uint32_t* out, int W, int T, int steps,
                               int K, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  const size_t threads = (size_t)W * T * SUBCHUNKS;
  const int bt = ext == 1 ? SORTED_THREADS : FQ2_BLOCK;
  const unsigned blocks = (unsigned)((threads + bt - 1) / bt);
#define CALL(NW_, EXT_)                                                                     \
  if constexpr (EXT_ == 1)                                                                  \
    sorted_sweep_kernel<NW_><<<blocks, bt, 0, stream>>>(pts, perm, meta, slot, out, W, T,  \
                                                        steps, K);                          \
  else                                                                                      \
    sorted_sweep2_kernel<NW_><<<blocks, bt, 0, stream>>>(pts, perm, meta, slot, out, W, T, \
                                                         steps, K)
  ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

// out[0..4]: registers, local bytes, static shared bytes, resident blocks
// per SM of the sweep kernel of (nw, ext) (zp_kernel_info).
extern "C" int zp_sorted_sweep_info(int nw, int ext, int* out) {
#define CALL(NW_, EXT_)                                                                   \
  if constexpr (EXT_ == 1) return zp_kernel_info(sorted_sweep_kernel<NW_>, SORTED_THREADS, out); \
  else return zp_kernel_info(sorted_sweep2_kernel<NW_>, FQ2_BLOCK, out)
  ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  return -1;
}

// The segmented scan: pieces x, y, z, each [2 EXT NW][W*K] int64 16-bit
// limbs; out [3][2 EXT NW][W*K] limbs.  A tile kernel a level (none for a
// level of one element) and a fix-up a level below the top, in that order;
// *kernels (not NULL) gets the number of kernels launched.
extern "C" int zp_segscan_limbs(int nw, int ext, const uint32_t* host_consts, const int64_t* x,
                                const int64_t* y, const int64_t* z, const int32_t* seg,
                                int64_t* out, int W, int K, int* kernels, void* stream_ptr) {
  if ((long long)6 * ext * nw * W * K >= (1ll << 32)) return -2;  // limbs.cuh's offsets
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  int n[8], s[8], launched = 0;
  const int levels = scan_levels(K, n, s);
  auto blocks = [&](int l, int skip) {
    return (unsigned)((size_t)W * ((n[l] + SCAN_TILE - 1) / SCAN_TILE - skip));
  };
  const Limbs P{x, y, z};
#define CALL(NW_, EXT_)                                                                       \
  const Limbs sums = scan_limbs<NW_, EXT_>(out, (uint32_t)W * K);                             \
  for (int l = 0; l < levels; ++l) {                                                          \
    if (l > 0 && n[l] == 1) continue;                                                         \
    segscan_tile_kernel<NW_, EXT_><<<blocks(l, 0), SCAN_TILE, 0, stream>>>(l ? sums : P, seg, \
                                                                           out, W, K, n[l],   \
                                                                           s[l]);             \
    ++launched;                                                                               \
  }                                                                                           \
  for (int l = levels - 2; l >= 0; --l) {                                                     \
    segscan_fix_kernel<NW_, EXT_><<<blocks(l, 1), SCAN_TILE, 0, stream>>>(seg, out, W, K,     \
                                                                          n[l], s[l]);        \
    ++launched;                                                                               \
  }
  ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  if (kernels) *kernels = launched;
  return (int)cudaGetLastError();
}

// out[0..4] as zp_sorted_sweep_info, of the segmented scan of (nw, ext):
// which = 0 its tile kernel, 1 its fix-up.
extern "C" int zp_segscan_info(int nw, int ext, int which, int* out) {
#define CALL(NW_, EXT_)                                                                     \
  if (which == 0) return zp_kernel_info(segscan_tile_kernel<NW_, EXT_>, SCAN_TILE, out);    \
  else return zp_kernel_info(segscan_fix_kernel<NW_, EXT_>, SCAN_TILE, out)
  ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  return -1;
}
