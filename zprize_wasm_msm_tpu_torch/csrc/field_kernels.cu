// Elementwise field kernels (CUDA, sm_90a).
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

// exp_words: ZP_MAX_NW host words of the exponent, bits = its bit length.
extern "C" int zp_field_pow(int nw, const uint32_t* host_consts, const uint32_t* exp_words,
                            int bits, const uint32_t* a, uint32_t* r, int n, void* stream_ptr) {
  if (bits < 1 || bits > 32 * ZP_MAX_NW) return -3;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = (int)cudaMemcpyToSymbolAsync(c_fc, host_consts, sizeof(FieldConsts), 0,
                                         cudaMemcpyHostToDevice, stream);
  if (err) return err;
  Exponent e;
  for (int k = 0; k < ZP_MAX_NW; ++k) e.w[k] = exp_words[k];
  const unsigned blocks = (unsigned)((n + POW_THREADS - 1) / POW_THREADS);
#define CALL(NW_) field_pow_kernel<NW_><<<blocks, POW_THREADS, 0, stream>>>(e, bits, a, r, n)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}
