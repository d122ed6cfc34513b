// Collapse and finish kernels of the Pippenger MSM (CUDA, sm_90a).
//
// collapse_kernel + combine_kernel replace the TPU kernel
// zprize_wasm_msm_tpu/ops/msm/pl_reduce.py `_collapse_kernel` (finish_large
// stage A: per window sum_b (b+1) S_{w,b}), and with finish_kernel they
// replace `_finish_kernel` (finish: the whole (W, B) -> one point contract,
// and at B = 1 the window fold of finish_large stage B).
//
// The TPU kernels are generic over the coordinate field, so they also run
// G2 over Fq2; here the collapse's bodies serve both (EXT = 1, 2): over Fq2
// on par.cuh's Fq2 doubling and addition, with the points in the groups'
// shared slots (collapse2_kernel, combine2_kernel).  The fold over Fq2 is a
// kernel of its own, finish2_kernel, on fold2.cuh's links: each Fq2
// product's three Karatsuba products side by side on a block of warps.
//
// The TPU versions run every phase through ONE generic masked body, a
// grid step per round, to keep the compiled program small, and move data
// between lanes with rolls.  Here the phases are written out plainly:
//   collapse: runs of m buckets, a group of lanes each, over the whole card:
//     a walk per run, then a tree over a window's runs (below);
//   finish:   finish_kernel (finish2_kernel over Fq2): ONE warp (one block)
//     folds the window sums (at B > 1 the collapse's, an entry call before)
//     by Horner's rule, acc <- 2^c acc + S_w from the top window down:
//     c (W-1) doublings and W-1 additions, as many as the depth of the sum.
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
#include "fold2.cuh"
#include "limbs.cuh"

#define FOLD_THREADS 32

// sums [3][NW][W] -> out [3][NW][1]: sum_w 2^(c w) sums_w by Horner's rule
// over Fq; one warp (each of its groups runs the same fold, the points in
// registers).  The fold over Fq2 is finish2_kernel below.
template <int NW>
__global__ void __launch_bounds__(FOLD_THREADS)
    finish_kernel(const uint32_t* __restrict__ sums, uint32_t* __restrict__ out, int W, int c,
                  uint32_t b3k) {
  constexpr int PL = coop_lanes<NW>(), GL = 8 * PL;
  const int sub = threadIdx.x % GL;
  Pt<NW> acc, s;
  pt_load_soa<NW>(acc, sums, (size_t)W, (size_t)(W - 1));
  for (int w = W - 2; w >= 0; --w) {
    pt_load_soa<NW>(s, sums, (size_t)W, (size_t)w);
    for (int i = 0; i < c; ++i) pt_double_par<NW, PL>(acc, sub, b3k);
    pt_add_par<NW, PL>(acc, acc, s, sub, b3k);
  }
  if (threadIdx.x == 0) pt_store_soa<NW>(out, (size_t)1, (size_t)0, acc);
}

// The fold's link form over Fq2 (fold2.cuh): a block of FOLD2_THREADS, each
// Fq product on coop_lanes lanes (96: three warps) or on one lane (32: one
// warp).  On BLS12-381 G2 the three warps' fold took about 0.7 of the one
// warp's time (csrc/diag/ab_fq2_reductions.py, edit fold_lane_form;
// chip_smoke.py's link_us times both forms).
#define FOLD2_THREADS 96
template <int NW>
__host__ __device__ constexpr int fold2_lanes() {
  return FOLD2_THREADS == 32 ? 1 : coop_lanes<NW>();
}

// finish_kernel's contract over Fq2: sums [3][2 NW][W] -> out [3][2 NW][1],
// the two points and the links' exchange in shared memory; b3k = k where
// 3b = k (1 + u), else 0 (par.cuh b3_as_additions).
template <int NW>
__global__ void __launch_bounds__(FOLD2_THREADS, 1)
    finish2_kernel(const uint32_t* __restrict__ sums, uint32_t* __restrict__ out, int W, int c,
                   uint32_t b3k) {
  constexpr int PL = fold2_lanes<NW>();
  __shared__ PtK<NW> acc, s;
  __shared__ Fold2Sh<NW> sh;
  fold2_load<NW>(acc, sums, (size_t)W, (size_t)(W - 1));
  for (int w = W - 2; w >= 0; --w) {
    fold2_load<NW>(s, sums, (size_t)W, (size_t)w);
    for (int i = 0; i < c; ++i) fold2_link_double<NW, PL, FOLD2_THREADS>(&acc, &sh, b3k);
    fold2_link_add<NW, PL, FOLD2_THREADS>(&acc, &acc, &s, &sh, b3k);
  }
  if (threadIdx.x == 0) fold2_store<NW>(out, (size_t)1, (size_t)0, acc);
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

// The collapse's links.  Over Fq2 they are out of line, one body of each
// op for every call site: inlined at its seven (the walk's two additions,
// the tree's three, two doublings), the collapse took 1.6 times as long at
// path G2-sorted's shape (csrc/diag/ab_fq2_reductions.py, edit
// inline_links), while one link alone takes the same time at 1, 2 and 4
// warps a SM (chip_smoke.py, link_us_by_warps_a_sm): the kernel's code, not
// the SM's shared pipes, made the difference.  Over Fq they stay inlined,
// the points in registers.
template <int EXT>
__device__ __forceinline__ constexpr bool links_out_of_line() {
  return EXT == 2;
}

template <int NW, int PL>
__device__ __noinline__ void pt2_link_add(Pt<NW, 2>* r, const Pt<NW, 2>* p, const Pt<NW, 2>* q,
                                          int sub, uint32_t b3k) {
  pt_add_par<NW, PL>(*r, *p, *q, sub, b3k);
}

template <int NW, int PL>
__device__ __noinline__ void pt2_link_double(Pt<NW, 2>* p, int sub, uint32_t b3k) {
  pt_double_par<NW, PL>(*p, sub, b3k);
}

template <int NW, int PL, int EXT>
__device__ __forceinline__ void link_add(Pt<NW, EXT>& r, const Pt<NW, EXT>& p,
                                         const Pt<NW, EXT>& q, int sub, uint32_t b3k) {
  if constexpr (links_out_of_line<EXT>()) pt2_link_add<NW, PL>(&r, &p, &q, sub, b3k);
  else pt_add_par<NW, PL>(r, p, q, sub, b3k);
}

template <int NW, int PL, int EXT>
__device__ __forceinline__ void link_double(Pt<NW, EXT>& p, int sub, uint32_t b3k) {
  if constexpr (links_out_of_line<EXT>()) pt2_link_double<NW, PL>(&p, sub, b3k);
  else pt_double_par<NW, PL>(p, sub, b3k);
}

// Combine the runs held by the groups of this block over `levels` levels:
// partners g ^ 1, g ^ 2, ...  The last level's Rs is computed only where
// keep_rs (a later launch combines the block's pair).
template <int NW, int PL, int EXT>
__device__ __forceinline__ void run_tree(Pt<NW, EXT>& A, Pt<NW, EXT>& Rs, Pt<NW, EXT>* shA,
                                         Pt<NW, EXT>* shR, int g, int levels, bool keep_rs,
                                         int sub, uint32_t b3k) {
  for (int l = 0; l < levels; ++l) {
    __syncthreads();  // the previous level's reads are done
    if (sub == 0) {
      shA[g] = A;
      shR[g] = Rs;
    }
    __syncthreads();
    const int p = g ^ (1 << l), hi = g | (1 << l);  // partner, upper run
    link_add<NW, PL, EXT>(A, A, shA[p], sub, b3k);
    link_add<NW, PL, EXT>(A, A, shR[hi], sub, b3k);
    if (l + 1 < levels || keep_rs) {
      link_add<NW, PL, EXT>(Rs, Rs, shR[p], sub, b3k);
      link_double<NW, PL, EXT>(Rs, sub, b3k);
    }
  }
}

// After the block's tree: the window sums (runs per window <= GB: the
// first group of each window writes its A), else the block's pair.
template <int NW, int GB, int EXT>
__device__ __forceinline__ void run_store(const Pt<NW, EXT>& A, const Pt<NW, EXT>& Rs,
                                          uint32_t* out, uint32_t* pieces, int cap, long G,
                                          long total, int per_window, int W, int g, int sub) {
  if (sub != 0) return;
  if (per_window <= GB) {
    if (G < total && G % per_window == 0)
      pt_store_soa<NW>(out, (size_t)W, (size_t)(G / per_window), A);
  } else if (g == 0) {
    pt_store_soa<NW>(pieces, (size_t)cap, (size_t)blockIdx.x, A);
    pt_store_soa<NW>(pieces + (size_t)3 * EXT * NW * cap, (size_t)cap, (size_t)blockIdx.x, Rs);
  }
}

// Over Fq2 the walk's bucket loads are off its chain: bucket i - 1's limbs
// are copied (cp.async, the low 32 bits of each) into the group's second
// buffer while bucket i's two additions run, and only turned into words
// when the walk reaches them (2-5 % of the collapse at path G2-sorted's
// shape, runs of 32 buckets; within 3 % either way at path G2's, runs of 4:
// ab_fq2_reductions.py, edit no_prefetch).  Over Fq each bucket is read
// when it is needed.
template <int EXT>
__device__ __forceinline__ constexpr bool walk_prefetch() {
  return EXT == 2;
}

// The two limb buffers of group g: 2 x 2 (3 EW) words.
template <int EW, int GB>
__device__ __forceinline__ uint32_t* walk_buffers(int g) {
  __shared__ uint32_t buf[GB][2][2 * 3 * EW];
  return buf[g][0];
}

// S (W*B points, limbs) -> out [3][EXT NW][W] (B / m <= GB), else pieces:
// the blocks' pairs, A at [3][EXT NW][cap], Rs after it.  One group per run
// of m buckets; over Fq2 the walk's two points are the group's shared slots
// (par.cuh work_point).  The body of collapse_kernel (Fq) and
// collapse2_kernel (Fq2).
template <int NW, int EXT>
__device__ __forceinline__ void collapse_body(const Limbs& S, uint32_t* __restrict__ out,
                                              uint32_t* __restrict__ pieces, int cap, int W,
                                              int B, int m, uint32_t b3k) {
  constexpr int PL = coop_lanes<NW>(), GL = 8 * PL, GB = COLLAPSE_THREADS / GL, EW = EXT * NW;
  constexpr int BW = 2 * 3 * EW;  // words of a limb buffer
  __shared__ Pt<NW, EXT> shA[GB], shR[GB], shS[GB];
  const int sub = threadIdx.x % GL, g = threadIdx.x / GL;
  const int runs = B / m;  // per window
  const long total = (long)W * runs, G = (long)blockIdx.x * GB + g;
  const bool live = G < total;
  const uint32_t n = W * B, lo = live ? G * m : 0;  // w B + j m = G m
  Pt<NW, EXT> A_own, R_own;
  Pt<NW, EXT>& A = work_point<NW, EXT, 2 * GB>(A_own, g);
  Pt<NW, EXT>& R = work_point<NW, EXT, 2 * GB>(R_own, GB + g);
  uint32_t* st = reinterpret_cast<uint32_t*>(&shS[g]);
  auto one = [&](int k) { return k / EW == 1 && k % EW < NW ? c_fc.one[k % EW] : 0u; };
  uint32_t* buf = nullptr;
  auto fetch = [&](int i) {  // bucket i's limbs into buffer i & 1
    uint32_t* b = buf + (i & 1) * BW;
    for (int k = sub; k < 3 * EW; k += GL) {
      const int64_t* c = limb_at<EW>(S, k, n, lo + i);
      cp_async4(b + 2 * k, c);
      cp_async4(b + 2 * k + 1, c + n);
    }
    cp_async_commit();
  };
  if constexpr (walk_prefetch<EXT>()) {
    buf = walk_buffers<EW, GB>(g);
    if (live) fetch(m - 1);
  }
  for (int i = m - 1; i >= 0; --i) {  // the same trip count for every group
    __syncwarp();                      // the last bucket's readers are done
    if constexpr (walk_prefetch<EXT>()) {
      cp_async_wait_all();
      const uint32_t* b = buf + (i & 1) * BW;
      for (int k = sub; k < 3 * EW; k += GL) st[k] = live ? b[2 * k] | (b[2 * k + 1] << 16) : one(k);
      __syncwarp();
      if (live && i > 0) fetch(i - 1);
    } else {
      for (int k = sub; k < 3 * EW; k += GL)  // word k: coordinate k / EW
        st[k] = live ? limb_word<EW>(S, k, n, lo + i) : one(k);
      __syncwarp();
    }
    if (i == m - 1) {
      R = shS[g];
      A = R;
    } else {
      link_add<NW, PL, EXT>(R, R, shS[g], sub, b3k);
      link_add<NW, PL, EXT>(A, A, R, sub, b3k);
    }
  }
  for (int k = m; k > 1; k >>= 1) link_double<NW, PL, EXT>(R, sub, b3k);  // Rs = m R
  const int levels = 31 - __clz(min(GB, runs));
  run_tree<NW, PL, EXT>(A, R, shA, shR, g, levels, runs > GB, sub, b3k);
  run_store<NW, GB, EXT>(A, R, out, pieces, cap, G, total, runs, W, g, sub);
}

// in: per_window pairs per window ([3][EXT NW][cap] A, then Rs) -> out
// [3][EXT NW][W] (per_window <= GB), else the blocks' pairs into `pieces`.
// The body of combine_kernel (Fq) and combine2_kernel (Fq2).
template <int NW, int EXT>
__device__ __forceinline__ void combine_body(const uint32_t* __restrict__ in,
                                             uint32_t* __restrict__ out,
                                             uint32_t* __restrict__ pieces, int cap, int W,
                                             int per_window, uint32_t b3k) {
  constexpr int PL = coop_lanes<NW>(), GL = 8 * PL, GB = COLLAPSE_THREADS / GL;
  __shared__ Pt<NW, EXT> shA[GB], shR[GB];
  const int sub = threadIdx.x % GL, g = threadIdx.x / GL;
  const long total = (long)W * per_window, G = (long)blockIdx.x * GB + g;
  Pt<NW, EXT> A_own, Rs_own;
  Pt<NW, EXT>& A = work_point<NW, EXT, 2 * GB>(A_own, g);
  Pt<NW, EXT>& Rs = work_point<NW, EXT, 2 * GB>(Rs_own, GB + g);
  if (G < total) {
    pt_load_soa<NW>(A, in, (size_t)cap, (size_t)G);
    pt_load_soa<NW>(Rs, in + (size_t)3 * EXT * NW * cap, (size_t)cap, (size_t)G);
  } else {
    pt_identity<NW>(A);
    pt_identity<NW>(Rs);
  }
  const int levels = 31 - __clz(min(GB, per_window));
  run_tree<NW, PL, EXT>(A, Rs, shA, shR, g, levels, per_window > GB, sub, b3k);
  run_store<NW, GB, EXT>(A, Rs, out, pieces, cap, G, total, per_window, W, g, sub);
}

template <int NW>
__global__ void __launch_bounds__(COLLAPSE_THREADS)
    collapse_kernel(Limbs S, uint32_t* __restrict__ out, uint32_t* __restrict__ pieces, int cap,
                    int W, int B, int m, uint32_t b3k) {
  collapse_body<NW, 1>(S, out, pieces, cap, W, B, m, b3k);
}

template <int NW>
__global__ void __launch_bounds__(COLLAPSE_THREADS)
    combine_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   uint32_t* __restrict__ pieces, int cap, int W, int per_window, uint32_t b3k) {
  combine_body<NW, 1>(in, out, pieces, cap, W, per_window, b3k);
}

// Over Fq2, one block per SM is the floor, so that a thread may take all 255
// registers (with the bound of the Fq kernels ptxas held the collapse to
// 168 and spilled at NW = 12); the points are in shared memory.
template <int NW>
__global__ void __launch_bounds__(COLLAPSE_THREADS, 1)
    collapse2_kernel(Limbs S, uint32_t* __restrict__ out, uint32_t* __restrict__ pieces, int cap,
                     int W, int B, int m, uint32_t b3k) {
  collapse_body<NW, 2>(S, out, pieces, cap, W, B, m, b3k);
}

template <int NW>
__global__ void __launch_bounds__(COLLAPSE_THREADS, 1)
    combine2_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                    uint32_t* __restrict__ pieces, int cap, int W, int per_window, uint32_t b3k) {
  combine_body<NW, 2>(in, out, pieces, cap, W, per_window, b3k);
}

// The launches of one collapse: collapse_kernel, then combine_kernel until
// one pair per window is left (their Fq2 forms over Fq2).  scratch: two halves of 2 x [3][EXT NW][cap]
// words, cap = W B / (m GB) (at least 1).
template <int NW, int EXT>
static int collapse_launches(const Limbs& S, uint32_t* out, uint32_t* scratch, int W, int B,
                             int m, uint32_t b3k, cudaStream_t stream) {
  constexpr int GB = COLLAPSE_THREADS / (8 * coop_lanes<NW>());
  int per_window = B / m;
  const long groups = (long)W * per_window;
  const int cap = (int)max(1L, groups / GB);
  uint32_t* half[2] = {scratch, scratch + (size_t)2 * 3 * EXT * NW * cap};
  const unsigned blocks = (unsigned)((groups + GB - 1) / GB);
  if constexpr (EXT == 1)
    collapse_kernel<NW><<<blocks, COLLAPSE_THREADS, 0, stream>>>(S, out, half[0], cap, W, B, m, b3k);
  else
    collapse2_kernel<NW><<<blocks, COLLAPSE_THREADS, 0, stream>>>(S, out, half[0], cap, W, B, m, b3k);
  int err = (int)cudaGetLastError();
  for (int h = 0; !err && per_window > GB; h ^= 1) {
    per_window /= GB;  // the pairs the last launch left per window
    const long n = (long)W * per_window;
    const unsigned cblocks = (unsigned)((n + GB - 1) / GB);
    if constexpr (EXT == 1)
      combine_kernel<NW><<<cblocks, COLLAPSE_THREADS, 0, stream>>>(half[h], out, half[h ^ 1], cap, W,
                                                                  per_window, b3k);
    else
      combine2_kernel<NW><<<cblocks, COLLAPSE_THREADS, 0, stream>>>(half[h], out, half[h ^ 1], cap,
                                                                   W, per_window, b3k);
    err = (int)cudaGetLastError();
  }
  return err;
}

// words [rows][n] -> limbs [2 rows][n]: limb 2r = the low half of word r.
__global__ void words_to_limbs_kernel(const uint32_t* __restrict__ words,
                                      int64_t* __restrict__ limbs, int rows, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * n) return;
  limb_put(limbs, t / n, n, t % n, words[t]);
}

// x, y, z: [2 EXT NW][W*B] int64 limbs each -> the window sums,
// [3][EXT NW][W] words at the head of scratch, and (out not NULL) as
// [3][2 EXT NW][W] int64 limbs in out; the combine launches' pairs follow
// the sums in scratch; B and m powers of two, m <= B; b3k = 3b as an
// integer over Fq (0 refuses the launch), over Fq2 k where 3b = k (1 + u),
// else 0 (the level of products by 3b).
extern "C" int zp_collapse(int nw, int ext, const uint32_t* host_consts, uint32_t b3k,
                           const int64_t* x, const int64_t* y, const int64_t* z, int64_t* out,
                           uint32_t* scratch, int W, int B, int m, void* stream_ptr) {
  if (ext == 1 && b3k == 0) return -5;
  if (B < 1 || (B & (B - 1)) || m < 1 || (m & (m - 1)) || m > B) return -2;
  if ((long long)2 * ext * nw * W * B >= (1ll << 32)) return -2;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  const Limbs S = {x, y, z};
  uint32_t* rest = scratch + (size_t)3 * ext * nw * W;
#define CALL(NW_, EXT_) err = collapse_launches<NW_, EXT_>(S, scratch, rest, W, B, m, b3k, stream)
  ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  if (err || !out) return err;
  const int rows = 3 * ext * nw;
  words_to_limbs_kernel<<<(rows * W + 127) / 128, 128, 0, stream>>>(scratch, out, rows, W);
  return (int)cudaGetLastError();
}

// out[0..4] as zp_kernel_info: which = 0 the collapse kernel, 1 the combine
// kernel (of the extension degree ext).
extern "C" int zp_collapse_info(int nw, int ext, int which, int* out) {
#define CALL(NW_, EXT_)                                                                      \
  if constexpr (EXT_ == 1)                                                                   \
    return which ? zp_kernel_info(combine_kernel<NW_>, COLLAPSE_THREADS, out)                \
                 : zp_kernel_info(collapse_kernel<NW_>, COLLAPSE_THREADS, out);              \
  else                                                                                       \
    return which ? zp_kernel_info(combine2_kernel<NW_>, COLLAPSE_THREADS, out)               \
                 : zp_kernel_info(collapse2_kernel<NW_>, COLLAPSE_THREADS, out)
  ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  return -1;
}

// The window sums S [3][EXT NW][W] words -> out [3][EXT NW][1]; b3k = 3b as
// an integer over Fq (0 refuses the launch: 3b does not fit a word), over
// Fq2 k where 3b = k (1 + u), else 0.  Over Fq one warp (finish_kernel),
// over Fq2 one block of FOLD2_THREADS (finish2_kernel).
extern "C" int zp_finish(int nw, int ext, const uint32_t* host_consts, uint32_t b3k,
                         const uint32_t* S, uint32_t* out, int W, int c, void* stream_ptr) {
  if (ext == 1 && b3k == 0) return -5;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
#define CALL(NW_, EXT_)                                                        \
  if constexpr (EXT_ == 1)                                                     \
    finish_kernel<NW_><<<1, FOLD_THREADS, 0, stream>>>(S, out, W, c, b3k);    \
  else                                                                         \
    finish2_kernel<NW_><<<1, FOLD2_THREADS, 0, stream>>>(S, out, W, c, b3k)
  ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

// out[0..4] as zp_kernel_info for the fold (finish_kernel, over Fq2
// finish2_kernel).
extern "C" int zp_finish_info(int nw, int ext, int* out) {
#define CALL(NW_, EXT_)                                                 \
  if constexpr (EXT_ == 1)                                              \
    return zp_kernel_info(finish_kernel<NW_>, FOLD_THREADS, out);       \
  else                                                                  \
    return zp_kernel_info(finish2_kernel<NW_>, FOLD2_THREADS, out)
  ZP_DISPATCH_NW_EXT(nw, ext, CALL)
#undef CALL
  return -1;
}
