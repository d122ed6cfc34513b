// Elementwise field kernels (CUDA, sm_90a).
//
// mont_mul_kernel and mont_square_kernel replace the TPU kernels
// zprize_wasm_msm_tpu/ops/field/kernels.py `mont_mul` / `mont_square`
// (bodies `_mul_kernel` / `_square_kernel`): the elementwise Montgomery
// product a * b * R^{-1} mod q (and a^2 * R^{-1}) over a batch, canonical
// output.  The TPU versions block the batch as (L, S, 128) tiles, keep the
// product accumulator in on-chip memory and pad the batch to 1024; none of
// that has a counterpart here: one thread per element runs fe_mul in its
// registers, any n, no padding.  Word j of neighbouring elements is
// contiguous ([NW][n]), so a warp's loads and stores coalesce as they are.
// Bound: bytes.  An element moves 3 * 4 * NW bytes (2 * 4 * NW for the
// square) against 2 NW^2 + NW multiply-adds: at NW = 12 the card's memory
// takes twice as long as its integer units.
//
// field_pow_kernel raises every element of a batch to one host-known
// exponent.  With the exponent q - 2 it is the field inversion of
// zprize_wasm_msm_tpu/ops/field/mont.py `inverse` (Fermat), which the JAX
// package runs on the device as a compiled loop.  In eager PyTorch the same
// ladder is ~1.5 bits(q) dependent Montgomery products of a few hundred
// small launches each — seconds for the ONE element that
// mont.batch_inverse inverts at the root of its product tree — so the whole
// ladder runs inside one thread here: one launch, nothing leaves the card.
//
// Bound: latency.  One element is bits(q) - 1 squarings and
// popcount(q - 2) - 1 products in a single dependent chain on one thread;
// bytes are one element in and one out.  Batches get one thread per
// element; the exponent is uniform, so a warp never diverges.

#include <cuda_runtime.h>

#include "group.cuh"

#define POW_THREADS 64

struct Exponent {
  uint32_t w[ZP_MAX_NW];
};

// a, r: [NW][n] words.  r = a^e (Montgomery form in and out), e given as
// `bits` = bit_length(e) >= 1 little-endian bits: MSB-first
// square-and-multiply, the multiply skipped on zero bits.
template <int NW>
__global__ void __launch_bounds__(POW_THREADS)
    field_pow_kernel(Exponent e, int bits, const uint32_t* __restrict__ a,
                     uint32_t* __restrict__ r, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<NW> x, acc;
  fe_load_soa<NW>(x, a, (size_t)n, (size_t)i);
  acc = x;  // the top bit is 1
  for (int k = bits - 2; k >= 0; --k) {
    fe_mul<NW>(acc, acc, acc);
    if ((e.w[k >> 5] >> (k & 31)) & 1u) fe_mul<NW>(acc, acc, x);
  }
  fe_store_soa<NW>(r, (size_t)n, (size_t)i, acc);
}

#define MUL_THREADS 128

// a [NW][n], b [NW][n] (or [NW][1] when b_broadcast: one constant operand
// for the whole batch, read by every thread from the same address),
// r [NW][n].  r = a * b * R^{-1} mod q.
template <int NW>
__global__ void __launch_bounds__(MUL_THREADS)
    mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ r, size_t n, int b_broadcast) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<NW> x, y;
  fe_load_soa<NW>(x, a, n, i);
  if (b_broadcast) {
    fe_load_soa<NW>(y, b, (size_t)1, (size_t)0);
  } else {
    fe_load_soa<NW>(y, b, n, i);
  }
  fe_mul<NW>(x, x, y);
  fe_store_soa<NW>(r, n, i, x);
}

// a, r: [NW][n].  r = a^2 * R^{-1} mod q.
template <int NW>
__global__ void __launch_bounds__(MUL_THREADS)
    mont_square_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ r, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<NW> x;
  fe_load_soa<NW>(x, a, n, i);
  fe_mul<NW>(x, x, x);
  fe_store_soa<NW>(r, n, i, x);
}

extern "C" int zp_mont_mul(int nw, const uint32_t* host_consts, const uint32_t* a,
                           const uint32_t* b, uint32_t* r, long long n, int b_broadcast,
                           void* stream_ptr) {
  if (n <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  const unsigned blocks = (unsigned)((n + MUL_THREADS - 1) / MUL_THREADS);
#define CALL(NW_) \
  mont_mul_kernel<NW_><<<blocks, MUL_THREADS, 0, stream>>>(a, b, r, (size_t)n, b_broadcast)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

extern "C" int zp_mont_square(int nw, const uint32_t* host_consts, const uint32_t* a,
                              uint32_t* r, long long n, void* stream_ptr) {
  if (n <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  const unsigned blocks = (unsigned)((n + MUL_THREADS - 1) / MUL_THREADS);
#define CALL(NW_) mont_square_kernel<NW_><<<blocks, MUL_THREADS, 0, stream>>>(a, r, (size_t)n)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

// exp_words: ZP_MAX_NW host words of the exponent, bits = its bit length.
extern "C" int zp_field_pow(int nw, const uint32_t* host_consts, const uint32_t* exp_words,
                            int bits, const uint32_t* a, uint32_t* r, int n, void* stream_ptr) {
  if (bits < 1 || bits > 32 * ZP_MAX_NW) return -3;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  Exponent e;
  for (int k = 0; k < ZP_MAX_NW; ++k) e.w[k] = exp_words[k];
  const unsigned blocks = (unsigned)((n + POW_THREADS - 1) / POW_THREADS);
#define CALL(NW_) field_pow_kernel<NW_><<<blocks, POW_THREADS, 0, stream>>>(e, bits, a, r, n)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
