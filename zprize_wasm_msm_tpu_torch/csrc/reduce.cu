// Collapse and finish kernels of the Pippenger MSM (CUDA, sm_90a).
//
// collapse_kernel + combine_kernel replace the TPU kernel
// zprize_wasm_msm_tpu/ops/msm/pl_reduce.py `_collapse_kernel` (finish_large
// stage A: per window sum_b (b+1) S_{w,b}), and with finish_kernel they
// replace `_finish_kernel` (finish: the whole (W, B) -> one point contract,
// and at B = 1 the window fold of finish_large stage B).
//
// The TPU versions run every phase through ONE generic masked body, a
// grid step per round, to keep the compiled program small, and move data
// between lanes with rolls.  Here the phases are written out plainly:
//   collapse: runs of m buckets, a group of lanes each, over the whole card:
//     a walk per run, then a tree over a window's runs (below);
//   finish:   finish_kernel: ONE warp folds the window sums (at B > 1 the
//     collapse's, an entry call before) by Horner's rule,
//     acc <- 2^c acc + S_w from the top window down: c (W-1) doublings and
//     W-1 additions, as many as the depth of the sum.
//
// Bound: operations, and within them latency: the work is a few thousand
// group operations with a serial depth of tens to hundreds of group ops,
// far too few to fill the card's integer units; bytes are W*B points in and
// W points (or one) out.  So each chain is made short: every group op is
// level-parallel (par.cuh: two levels of independent products, spread over
// the lanes of a group), each product's instructions shared by the lanes
// of a quarter warp (coop.cuh), every operand in registers or shared
// memory (no call, no stack).  A lone warp's doubling takes ~2.1 us and its
// addition ~2.6 us this way (chip_smoke.py's link_us); a warp that shares
// its scheduler with others waits for them (each warp issues one
// instruction after another), so the collapse keeps its groups near one
// warp per scheduler and lengthens its runs instead.

#include <cuda_runtime.h>

#include "async.cuh"
#include "par.cuh"

#define FOLD_THREADS 32

// sums [3][NW][W] -> out [3][NW][1]: sum_w 2^(c w) sums_w by Horner's rule;
// one warp (each of its groups runs the same fold).
template <int NW>
__global__ void __launch_bounds__(FOLD_THREADS)
    finish_kernel(const uint32_t* __restrict__ sums, uint32_t* __restrict__ out, int W, int c,
                  uint32_t b3k) {
  constexpr int PL = coop_lanes<NW>();  // cooperative products (coop.cuh)
  const int sub = threadIdx.x % (8 * PL);
  Pt<NW> acc, s;
  pt_load_soa<NW>(acc, sums, (size_t)W, (size_t)(W - 1));
  for (int w = W - 2; w >= 0; --w) {
    pt_load_soa<NW>(s, sums, (size_t)W, (size_t)w);
    for (int i = 0; i < c; ++i) pt_double_par<NW, PL>(acc, sub, b3k);
    pt_add_par<NW, PL>(acc, acc, s, sub, b3k);
  }
  if (threadIdx.x == 0) pt_store_soa<NW>(out, (size_t)1, (size_t)0, acc);
}

// ---- collapse: sum_b (b+1) S_{w,b} per window over the whole card --------
//
// A run of `len` consecutive buckets lo .. lo + len - 1 of one window is
// held as the pair (A, Rs): A = sum (b - lo + 1) S_b, Rs = len * sum S_b.
// Two neighbouring runs of equal length combine as
//   (A_L, Rs_L) + (A_R, Rs_R) = (A_L + A_R + Rs_R, 2 (Rs_L + Rs_R)):
// the upper run's weights rise by len_L, and its Rs is len_L times its sum.
// So a level of the tree is three additions and one doubling, whatever the
// runs' length.  A group of 8 PL lanes (par.cuh; PL = coop_lanes, the
// cooperative product) holds one run:
//   collapse_kernel: group G takes the run of m buckets G m .. G m + m - 1
//     (runs never cross a window: m divides B), walks it from the top
//     bucket down (R += S_b, A += R: 2 (m - 1) additions), Rs = m R
//     (log2 m doublings); then the groups of a block combine their runs in
//     a tree through shared memory (both partners compute the parent, so
//     every lane of the block runs every op: the shuffles need them all).
//     Where a window's runs fit one block (B / m <= GB) the block writes the
//     window sums; else its pair goes to `pieces`;
//   combine_kernel: the same tree over the blocks' pairs, a group per pair,
//     until one pair per window is left (one or two launches at the paths'
//     shapes).
// m is the host's choice (pl_reduce._collapse_run): the smallest power of
// two for which the W B / m groups take at most one warp per scheduler of
// the card.  More groups make each link slower than their shorter chain
// saves, fewer lengthen the walk; chip_smoke.py times the collapse at every
// run length up to 64 beside it.  Each bucket of the run is staged in shared
// memory by the group's lanes, so only the walk's two points stay in
// registers.

#define COLLAPSE_THREADS 128

// The buckets the collapse reads: the package's int64 16-bit limbs, one
// [2 NW][n] array a coordinate, read as they are (the wrappers then pack
// nothing; a word is two limbs).
struct Limbs {
  const int64_t* x;
  const int64_t* y;
  const int64_t* z;
};

// Word k (coordinate k / NW) of point i of n; 2 NW n limbs a coordinate
// fit 32-bit offsets (the host checks it).
template <int NW>
__device__ __forceinline__ uint32_t limb_word(const Limbs& s, int k, uint32_t n, uint32_t i) {
  const int64_t* c = k < NW ? s.x : k < 2 * NW ? s.y : s.z;
  const uint32_t at = 2 * (k % NW) * n + i;
  return (uint32_t)c[at] | ((uint32_t)c[at + n] << 16);
}

// Combine the runs held by the groups of this block over `levels` levels:
// partners g ^ 1, g ^ 2, ...  The last level's Rs is computed only where
// keep_rs (a later launch combines the block's pair).
template <int NW, int PL>
__device__ __forceinline__ void run_tree(Pt<NW>& A, Pt<NW>& Rs, Pt<NW>* shA, Pt<NW>* shR, int g,
                                         int levels, bool keep_rs, int sub, uint32_t b3k) {
  for (int l = 0; l < levels; ++l) {
    __syncthreads();  // the previous level's reads are done
    if (sub == 0) {
      shA[g] = A;
      shR[g] = Rs;
    }
    __syncthreads();
    const int p = g ^ (1 << l), hi = g | (1 << l);  // partner, upper run
    pt_add_par<NW, PL>(A, A, shA[p], sub, b3k);
    pt_add_par<NW, PL>(A, A, shR[hi], sub, b3k);
    if (l + 1 < levels || keep_rs) {
      pt_add_par<NW, PL>(Rs, Rs, shR[p], sub, b3k);
      pt_double_par<NW, PL>(Rs, sub, b3k);
    }
  }
}

// After the block's tree: the window sums (runs per window <= GB: the
// first group of each window writes its A), else the block's pair.
template <int NW, int GB>
__device__ __forceinline__ void run_store(const Pt<NW>& A, const Pt<NW>& Rs, uint32_t* out,
                                          uint32_t* pieces, int cap, long G, long total,
                                          int per_window, int W, int g, int sub) {
  if (sub != 0) return;
  if (per_window <= GB) {
    if (G < total && G % per_window == 0)
      pt_store_soa<NW>(out, (size_t)W, (size_t)(G / per_window), A);
  } else if (g == 0) {
    pt_store_soa<NW>(pieces, (size_t)cap, (size_t)blockIdx.x, A);
    pt_store_soa<NW>(pieces + (size_t)3 * NW * cap, (size_t)cap, (size_t)blockIdx.x, Rs);
  }
}

// S (W*B points, limbs) -> out [3][NW][W] (B / m <= GB), else pieces: the
// blocks' pairs, A at [3][NW][cap], Rs after it.  One group per run of m
// buckets.
template <int NW>
__global__ void __launch_bounds__(COLLAPSE_THREADS)
    collapse_kernel(Limbs S, uint32_t* __restrict__ out, uint32_t* __restrict__ pieces, int cap,
                    int W, int B, int m, uint32_t b3k) {
  constexpr int PL = coop_lanes<NW>(), GL = 8 * PL, GB = COLLAPSE_THREADS / GL;
  __shared__ Pt<NW> shA[GB], shR[GB], shS[GB];
  const int sub = threadIdx.x % GL, g = threadIdx.x / GL;
  const int runs = B / m;  // per window
  const long total = (long)W * runs, G = (long)blockIdx.x * GB + g;
  const bool live = G < total;
  const uint32_t n = W * B, lo = live ? G * m : 0;  // w B + j m = G m
  Pt<NW> A, R;
  for (int i = m - 1; i >= 0; --i) {  // the same trip count for every group
    __syncwarp();                      // the last bucket's readers are done
    uint32_t* st = reinterpret_cast<uint32_t*>(&shS[g]);
    for (int k = sub; k < 3 * NW; k += GL) {  // word k: coordinate k / NW
      const uint32_t one = k / NW == 1 ? c_fc.one[k % NW] : 0u;
      st[k] = live ? limb_word<NW>(S, k, n, lo + i) : one;
    }
    __syncwarp();
    if (i == m - 1) {
      R = shS[g];
      A = R;
    } else {
      pt_add_par<NW, PL>(R, R, shS[g], sub, b3k);
      pt_add_par<NW, PL>(A, A, R, sub, b3k);
    }
  }
  for (int k = m; k > 1; k >>= 1) pt_double_par<NW, PL>(R, sub, b3k);  // Rs = m R
  const int levels = 31 - __clz(min(GB, runs));
  run_tree<NW, PL>(A, R, shA, shR, g, levels, runs > GB, sub, b3k);
  run_store<NW, GB>(A, R, out, pieces, cap, G, total, runs, W, g, sub);
}

// in: per_window pairs per window ([3][NW][cap] A, then Rs) -> out
// [3][NW][W] (per_window <= GB), else the blocks' pairs into `pieces`.
template <int NW>
__global__ void __launch_bounds__(COLLAPSE_THREADS)
    combine_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   uint32_t* __restrict__ pieces, int cap, int W, int per_window, uint32_t b3k) {
  constexpr int PL = coop_lanes<NW>(), GL = 8 * PL, GB = COLLAPSE_THREADS / GL;
  __shared__ Pt<NW> shA[GB], shR[GB];
  const int sub = threadIdx.x % GL, g = threadIdx.x / GL;
  const long total = (long)W * per_window, G = (long)blockIdx.x * GB + g;
  Pt<NW> A, Rs;
  if (G < total) {
    pt_load_soa<NW>(A, in, (size_t)cap, (size_t)G);
    pt_load_soa<NW>(Rs, in + (size_t)3 * NW * cap, (size_t)cap, (size_t)G);
  } else {
    pt_identity<NW>(A);
    pt_identity<NW>(Rs);
  }
  const int levels = 31 - __clz(min(GB, per_window));
  run_tree<NW, PL>(A, Rs, shA, shR, g, levels, per_window > GB, sub, b3k);
  run_store<NW, GB>(A, Rs, out, pieces, cap, G, total, per_window, W, g, sub);
}

// The launches of one collapse: collapse_kernel, then combine_kernel until
// one pair per window is left.  scratch: two halves of 2 x [3][NW][cap]
// words, cap = W B / (m GB) (at least 1).
template <int NW>
static int collapse_launches(const Limbs& S, uint32_t* out, uint32_t* scratch, int W, int B,
                             int m, uint32_t b3k, cudaStream_t stream) {
  constexpr int GB = COLLAPSE_THREADS / (8 * coop_lanes<NW>());
  int per_window = B / m;
  const long groups = (long)W * per_window;
  const int cap = (int)max(1L, groups / GB);
  uint32_t* half[2] = {scratch, scratch + (size_t)2 * 3 * NW * cap};
  collapse_kernel<NW><<<(unsigned)((groups + GB - 1) / GB), COLLAPSE_THREADS, 0, stream>>>(
      S, out, half[0], cap, W, B, m, b3k);
  int err = (int)cudaGetLastError();
  for (int h = 0; !err && per_window > GB; h ^= 1) {
    per_window /= GB;  // the pairs the last launch left per window
    const long n = (long)W * per_window;
    combine_kernel<NW><<<(unsigned)((n + GB - 1) / GB), COLLAPSE_THREADS, 0, stream>>>(
        half[h], out, half[h ^ 1], cap, W, per_window, b3k);
    err = (int)cudaGetLastError();
  }
  return err;
}

// words [rows][n] -> limbs [2 rows][n]: limb 2r = the low half of word r.
__global__ void words_to_limbs_kernel(const uint32_t* __restrict__ words,
                                      int64_t* __restrict__ limbs, int rows, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * n) return;
  const int r = t / n, i = t % n;
  limbs[(size_t)(2 * r) * n + i] = words[t] & 0xFFFFu;
  limbs[(size_t)(2 * r + 1) * n + i] = words[t] >> 16;
}

// x, y, z: [2 NW][W*B] int64 limbs each -> the window sums, [3][NW][W]
// words at the head of scratch, and (out not NULL) as [3][2 NW][W] int64
// limbs in out; the combine launches' pairs follow the sums in scratch;
// B and m powers of two, m <= B; b3k = 3b as an integer (0 refuses the
// launch).
extern "C" int zp_collapse(int nw, const uint32_t* host_consts, uint32_t b3k, const int64_t* x,
                           const int64_t* y, const int64_t* z, int64_t* out, uint32_t* scratch,
                           int W, int B, int m, void* stream_ptr) {
  if (b3k == 0) return -5;
  if (B < 1 || (B & (B - 1)) || m < 1 || (m & (m - 1)) || m > B) return -2;
  if ((long long)2 * nw * W * B >= (1ll << 32)) return -2;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  const Limbs S = {x, y, z};
  uint32_t* rest = scratch + (size_t)3 * nw * W;
#define CALL(NW_) err = collapse_launches<NW_>(S, scratch, rest, W, B, m, b3k, stream)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  if (err || !out) return err;
  const int rows = 3 * nw;
  words_to_limbs_kernel<<<(rows * W + 127) / 128, 128, 0, stream>>>(scratch, out, rows, W);
  return (int)cudaGetLastError();
}

// out[0..4] as zp_kernel_info: which = 0 collapse_kernel, 1 combine_kernel.
extern "C" int zp_collapse_info(int nw, int which, int* out) {
#define CALL(NW_)                                                               \
  return which ? zp_kernel_info(combine_kernel<NW_>, COLLAPSE_THREADS, out)     \
               : zp_kernel_info(collapse_kernel<NW_>, COLLAPSE_THREADS, out)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return -1;
}

// The window sums S [3][NW][W] words -> out [3][NW][1]; b3k = 3b as an
// integer (0 refuses the launch: 3b does not fit a word).
extern "C" int zp_finish(int nw, const uint32_t* host_consts, uint32_t b3k, const uint32_t* S,
                         uint32_t* out, int W, int c, void* stream_ptr) {
  if (b3k == 0) return -5;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
#define CALL(NW_) finish_kernel<NW_><<<1, FOLD_THREADS, 0, stream>>>(S, out, W, c, b3k)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

// out[0..4] as zp_kernel_info for the fold (finish_kernel).
extern "C" int zp_finish_info(int nw, int* out) {
#define CALL(NW_) return zp_kernel_info(finish_kernel<NW_>, FOLD_THREADS, out)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return -1;
}
