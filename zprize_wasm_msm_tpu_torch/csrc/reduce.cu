// Collapse and finish kernels of the Pippenger MSM (CUDA, sm_90a).
//
// collapse_kernel replaces the TPU kernel
// zprize_wasm_msm_tpu/ops/msm/pl_reduce.py `_collapse_kernel`
// (finish_large stage A), and finish_weight_kernel + finish_kernel replace
// `_finish_kernel` (finish: the whole (W, B) -> one point contract, and at
// B = 1 the window fold of finish_large stage B).
//
// The TPU versions run every phase through ONE generic masked body, a
// grid step per round, to keep the compiled program small, and move data
// between lanes with rolls.  Here the phases are written out plainly:
//   collapse: one block per window of min(B, 128) threads; thread i takes
//     buckets b = i, i + 128, ...: a bit_length(B)-round double-and-add
//     ladder scales S_{w,b} by b+1 and the thread keeps a running sum, then
//     a tree sums the block's points.  Any power-of-two B: the sorted
//     engine's B = 2^(c-1) for c up to 16 goes through the same kernel.
//   finish:   two launches (one at B = 1).  finish_weight_kernel: one block
//     per window, every (w, b) lane on its own group of eight lanes (the
//     level-parallel ops of par.cuh, a product to a lane), a
//     bit_length(B)-round ladder scales S_{w,b} by b+1, a tree per window
//     leaves sum_b (b+1) S_{w,b}.  finish_kernel: ONE warp folds the window
//     sums by Horner's rule, acc <- 2^c acc + S_w from the top window down:
//     c (W-1) doublings and W-1 additions, as many as the depth of the sum,
//     each product shared by FOLD_PL lanes (coop.cuh).
//
// Bound: operations, and within them latency: the work is a few thousand
// group operations with a serial depth of c*(W-1) doublings, far too few to
// fill the card; bytes are W*B points in and one point out.  So the fold is
// one chain, and what it does about it is cut each link: two levels of
// independent products per doubling and per addition, spread over the
// lanes of a group (par.cuh), each product's instructions shared by the
// lanes of a quarter warp (coop.cuh), every operand in registers (no call,
// no stack), the next window sum loaded while the doublings run.

#include <cuda_runtime.h>

#include "async.cuh"
#include "par.cuh"

#define COLLAPSE_MAX_THREADS 128
#define WEIGHT_THREADS 128
#define FOLD_THREADS 32

// lanes per product in the fold: the cooperative product (coop.cuh)
template <int NW>
constexpr int FOLD_PL = coop_lanes<NW>();

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

// S [3][NW][W*B] -> sums [3][NW][W]: sum_b (b+1) S_{w,b}; grid = W blocks.
// Group g of the block (eight lanes) takes buckets b = g, g + 16, ...
template <int NW>
__global__ void __launch_bounds__(WEIGHT_THREADS)
    finish_weight_kernel(const uint32_t* __restrict__ S, uint32_t* __restrict__ sums, int W,
                         int B, int bits, uint32_t b3k) {
  constexpr int GROUP = 8, GROUPS = WEIGHT_THREADS / GROUP;  // a product to a lane
  __shared__ Pt<NW> sh[WEIGHT_THREADS / 32];
  const int w = blockIdx.x, tid = threadIdx.x, sub = tid % GROUP, warp = tid / 32;
  Pt<NW> acc, s, l;
  for (int b0 = 0; b0 < B; b0 += GROUPS) {  // the same trip count for every group
    const int b = b0 + tid / GROUP;
    if (b < B) pt_load_soa<NW>(s, S, (size_t)W * B, (size_t)w * B + b);
    else pt_identity<NW>(s);
    ladder_par<NW, 1>(l, s, b + 1, bits, sub, b3k);
    if (b0 == 0) acc = l;
    else pt_add_par<NW, 1>(acc, acc, l, sub, b3k);
  }
  // the four groups of a warp, then the warps of the block
  for (int off = GROUP; off < 32; off <<= 1) {
    pt_shfl_xor<NW>(l, acc, off);
    pt_add_par<NW, 1>(acc, acc, l, sub, b3k);
  }
  if (tid % 32 == 0) sh[warp] = acc;
  __syncthreads();
  if (warp != 0) return;
  for (int j = 1; j < WEIGHT_THREADS / 32; ++j) pt_add_par<NW, 1>(acc, acc, sh[j], sub, b3k);
  if (tid == 0) pt_store_soa<NW>(sums, (size_t)W, (size_t)w, acc);
}

// sums [3][NW][W] -> out [3][NW][1]: sum_w 2^(c w) sums_w by Horner's rule;
// one warp (each of its groups runs the same fold).
template <int NW>
__global__ void __launch_bounds__(FOLD_THREADS)
    finish_kernel(const uint32_t* __restrict__ sums, uint32_t* __restrict__ out, int W, int c,
                  uint32_t b3k) {
  constexpr int PL = FOLD_PL<NW>;
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

// S [3][NW][W*B] -> out [3][NW][1]; scratch [3][NW][W] (used when B > 1);
// b3k = 3b as an integer (0 refuses the launch: 3b does not fit a word).
extern "C" int zp_finish(int nw, const uint32_t* host_consts, uint32_t b3k, const uint32_t* S,
                         uint32_t* scratch, uint32_t* out, int W, int B, int c, int bits,
                         void* stream_ptr) {
  if (b3k == 0) return -5;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  if (B > 1) {
#define CALL(NW_) \
  finish_weight_kernel<NW_><<<W, WEIGHT_THREADS, 0, stream>>>(S, scratch, W, B, bits, b3k)
    ZP_DISPATCH_NW(nw, CALL)
#undef CALL
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  const uint32_t* sums = B > 1 ? scratch : S;
#define CALL(NW_) finish_kernel<NW_><<<1, FOLD_THREADS, 0, stream>>>(sums, out, W, c, b3k)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

// out[0..4] as zp_kernel_info: which = 0 the fold (finish_kernel), 1 the
// weighting launch (finish_weight_kernel).
extern "C" int zp_finish_info(int nw, int which, int* out) {
#define CALL(NW_)                                                                   \
  return which ? zp_kernel_info(finish_weight_kernel<NW_>, WEIGHT_THREADS, out) \
               : zp_kernel_info(finish_kernel<NW_>, FOLD_THREADS, out)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return -1;
}
