// Elementwise field kernels (CUDA, sm_90a).
//
// mont_mul_kernel and mont_square_kernel replace the TPU kernels
// zprize_wasm_msm_tpu/ops/field/kernels.py `mont_mul` / `mont_square`
// (bodies `_mul_kernel` / `_square_kernel`): the elementwise Montgomery
// product a * b * R^{-1} mod q (and a^2 * R^{-1}) over a batch, canonical
// output.  The TPU versions block the batch as (L, S, 128) tiles, keep the
// product accumulator in on-chip memory and pad the batch to 1024; none of
// that has a counterpart here: one thread per element runs fe_mul (fe_sqr)
// in its registers, any n, no padding.  Word j (limb j) of neighbouring
// elements is contiguous ([NW][n], [2 NW][n]), so a warp's loads and stores
// coalesce as they are.
// Bound: bytes.  The product moves 3 * 4 * NW bytes an element on packed
// words against 2 NW^2 + NW multiply-adds: at NW = 12 the card's memory
// takes twice as long as its integer units.  The square reads and writes
// the package's int64 limbs itself (2 * 2 NW * 8 bytes an element), so its
// wrapper packs nothing: one launch where packing words around it took
// three.
//
// field_inverse_kernel is the field inversion of
// zprize_wasm_msm_tpu/ops/field/mont.py `inverse`: a^{-1} in Montgomery form
// per batch element, 0 -> 0.  The JAX package raises to q - 2 (Fermat)
// because a Euclid loop whose trip count follows the data suits neither
// SIMT nor XLA; that ladder is ~1.5 bits(q) dependent Montgomery products.
// Here it is a binary extended GCD of FIXED length (Pornin, "Optimized
// Binary GCD for Modular Inversion", IACR ePrint 2020/972, algorithm 2):
// the inverse is unique and canonical, so the words equal the ladder's bit
// for bit.  One thread per element; every thread runs the same
// instructions, so a warp never diverges.
//
//   a = x, b = q, u = 1, v = 0 (invariants a = u x, b = v x, up to a power
//   of two).  `steps` = ceil((2 bits(q) - 1) / 31) outer steps, each:
//   1. 64-bit approximations of a and b: their low 31 bits and the 33 bits
//      below the top of the longer (n = max(len a, len b, 64)); exact once
//      both fit 64 bits;
//   2. 31 inner iterations of the binary GCD on the approximations alone
//      (if a odd: swap a, b where a < b; a -= b; then a /= 2), the same
//      moves recorded as a matrix of signed factors f0 g0 / f1 g1,
//      |f| + |g| <= 2^31 per row;
//   3. a, b <- (f0 a + g0 b) / 2^31, (f1 a + g1 b) / 2^31 on NW + 1 signed
//      words (exact divisions), negated with their row where negative;
//   4. u, v <- (f0 u + g0 v) / 2^32, (f1 u + g1 v) / 2^32 mod q: a negative
//      factor takes q - u in place of u, so the sums are unsigned and below
//      2^31 q, and one Montgomery word reduction (np) divides by 2^32.
//   After the last step b = gcd = 1 and v = x^{-1} 2^{-steps} (each step
//   halves the scale: 2^31 in a, b against 2^32 in u, v).  With x = aR the
//   wanted a^{-1} R is x^{-1} R^2 = v * (2^steps R^3 mod q) * R^{-1}: one
//   Montgomery product by a constant the host computes per field.  x = 0
//   keeps v = 0 and is also mapped to 0 explicitly.
//
// Bound: latency.  One element is ~2 bits(q) dependent iterations of a few
// 64-bit operations and `steps` updates of ~8 NW word products, on one
// thread; bytes are one element in and one out.

#include <cuda_runtime.h>

#include "async.cuh"
#include "group.cuh"

#define INV_THREADS 64

struct InverseConsts {
  uint32_t fix[ZP_MAX_NW];  // 2^steps R^3 mod q
  int steps;                // outer steps of 31 iterations
};

// (f a + g b) / 2^31 for a, b < 2^(32 NW - 1) and |f| + |g| <= 2^31, the
// low 31 bits of the sum zero: r = its absolute value; returns true where
// the sum was negative.  Each word's sum fits int64: |a_j f + b_j g| <=
// (2^32 - 1) 2^31 and the carry is below 2^31 in size.
template <int NW>
__device__ __forceinline__ bool lin_shift(uint32_t (&r)[NW], const uint32_t (&a)[NW],
                                          const uint32_t (&b)[NW], int64_t f, int64_t g) {
  uint32_t t[NW + 1];
  int64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int64_t s = (int64_t)a[j] * f + (int64_t)b[j] * g + c;
    t[j] = (uint32_t)s;
    c = s >> 32;  // arithmetic
  }
  t[NW] = (uint32_t)c;
  const uint32_t neg = c < 0 ? 0xFFFFFFFFu : 0u;
  // shift right by 31 and take the absolute value: (t ^ neg) + (neg & 1)
  uint32_t carry = neg & 1u;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t w = ((t[j] >> 31) | (t[j + 1] << 1)) ^ neg;
    const uint64_t s = (uint64_t)w + carry;
    r[j] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  return neg != 0u;
}

// (f u + g v) / 2^32 mod q for u, v < q, |f| + |g| <= 2^31: a negative
// factor takes q - u (<= q) for u, so the sum t = |f| u' + |g| v' < 2^31 q
// is unsigned; m = t_0 np clears its low word, (t + m q) / 2^32 < 2q, and
// one conditional subtract makes it canonical.
template <int NW>
__device__ __forceinline__ void lin_mod(Fe<NW>& r, const Fe<NW>& u, const Fe<NW>& v, int64_t f,
                                        int64_t g) {
  uint32_t uu[NW], vv[NW];
  fe_q<NW>(uu);
  fe_q<NW>(vv);
  Chains<NW>::sub(uu, u.w);  // q - u
  Chains<NW>::sub(vv, v.w);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uu[j] = f < 0 ? uu[j] : u.w[j];
    vv[j] = g < 0 ? vv[j] : v.w[j];
  }
  const uint64_t fa = (uint64_t)(f < 0 ? -f : f), ga = (uint64_t)(g < 0 ? -g : g);
  // two chains in one pass: t = fa u' + ga v' (carry c1), then t + m q
  // shifted down one word (carry c2)
  uint64_t c1 = 0, c2 = 0;
  uint32_t m = 0, t[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint64_t s1 = (uint64_t)uu[j] * fa + (uint64_t)vv[j] * ga + c1;  // < 2^63 + 2^32
    c1 = s1 >> 32;
    const uint32_t tj = (uint32_t)s1;
    if (j == 0) m = tj * c_fc.np;
    const uint64_t s2 = (uint64_t)m * c_fc.q[j] + tj + c2;  // <= 2^64 - 1
    c2 = s2 >> 32;
    if (j > 0) t[j - 1] = (uint32_t)s2;
  }
  t[NW - 1] = (uint32_t)(c1 + c2);  // the sum is below 2q < 2^(32 NW)
  fe_reduce_once<NW>(r, t);
}

// a, r: [2 NW][n] int64 16-bit limbs (the package's public layout: the
// wrapper then needs no packing launches around this one); r = a^{-1} in
// Montgomery form (0 -> 0).
template <int NW>
__global__ void __launch_bounds__(INV_THREADS)
    field_inverse_kernel(InverseConsts k, const int64_t* __restrict__ a, int64_t* __restrict__ r,
                         int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<NW> x, u, v, fix;
#pragma unroll
  for (int j = 0; j < NW; ++j)
    x.w[j] = (uint32_t)a[(size_t)(2 * j) * n + i] | ((uint32_t)a[(size_t)(2 * j + 1) * n + i] << 16);
  uint32_t A[NW], B[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    A[j] = x.w[j];
    B[j] = c_fc.q[j];
    u.w[j] = j == 0 ? 1u : 0u;
    v.w[j] = 0u;
    fix.w[j] = k.fix[j];
  }
  constexpr uint64_t LOW31 = (1ull << 31) - 1;
  for (int step = 0; step < k.steps; ++step) {
    // n = max(len a, len b, 64); the 33 bits at n - 33 .. n - 1 of each
    int top = 0;
    uint32_t topw = A[0] | B[0];
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      if (A[j] | B[j]) {
        top = j;
        topw = A[j] | B[j];
      }
    }
    const int len = max(32 * top + 32 - __clz(topw), 64);
    const int p = len - 33, wi = p >> 5, sh = p & 31;  // wi + 1 <= NW - 1
    uint32_t a0 = 0, a1 = 0, b0 = 0, b1 = 0;
#pragma unroll
    for (int j = 0; j + 1 < NW; ++j) {
      if (j == wi) {
        a0 = A[j];
        a1 = A[j + 1];
        b0 = B[j];
        b1 = B[j + 1];
      }
    }
    uint64_t at = (((((uint64_t)a1 << 32) | a0) >> sh) << 31) | (A[0] & LOW31);
    uint64_t bt = (((((uint64_t)b1 << 32) | b0) >> sh) << 31) | (B[0] & LOW31);
    // (the shifted 64-bit window keeps exactly 33 bits below n: the bits
    // above n - 1 are zero)
    int64_t f0 = 1, g0 = 0, f1 = 0, g1 = 1;
#pragma unroll 31
    for (int it = 0; it < 31; ++it) {
      const bool odd = at & 1u;
      const bool sw = odd && at < bt;
      const uint64_t as = sw ? bt : at, bs = sw ? at : bt;
      const int64_t f0s = sw ? f1 : f0, g0s = sw ? g1 : g0, f1s = sw ? f0 : f1,
                    g1s = sw ? g0 : g1;
      at = (odd ? as - bs : as) >> 1;
      bt = bs;
      f0 = odd ? f0s - f1s : f0s;
      g0 = odd ? g0s - g1s : g0s;
      f1 = f1s * 2;
      g1 = g1s * 2;
    }
    uint32_t An[NW], Bn[NW];
    if (lin_shift<NW>(An, A, B, f0, g0)) {
      f0 = -f0;
      g0 = -g0;
    }
    if (lin_shift<NW>(Bn, A, B, f1, g1)) {
      f1 = -f1;
      g1 = -g1;
    }
    Fe<NW> un, vn;
    lin_mod<NW>(un, u, v, f0, g0);
    lin_mod<NW>(vn, u, v, f1, g1);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      A[j] = An[j];
      B[j] = Bn[j];
    }
    u = un;
    v = vn;
  }
  fe_mul<NW>(v, v, fix);
  if (fe_is_zero<NW>(x)) fe_zero<NW>(v);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    r[(size_t)(2 * j) * n + i] = v.w[j] & 0xFFFFu;
    r[(size_t)(2 * j + 1) * n + i] = v.w[j] >> 16;
  }
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

// a, r: [2 NW][n] int64 16-bit limbs (the package's public layout).
// r = a^2 * R^{-1} mod q (field.cuh fe_sqr).
template <int NW>
__global__ void __launch_bounds__(MUL_THREADS)
    mont_square_kernel(const int64_t* __restrict__ a, int64_t* __restrict__ r, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<NW> x;
#pragma unroll
  for (int j = 0; j < NW; ++j)
    x.w[j] = (uint32_t)a[(2 * j) * n + i] | ((uint32_t)a[(2 * j + 1) * n + i] << 16);
  fe_sqr<NW>(x, x);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    r[(2 * j) * n + i] = x.w[j] & 0xFFFFu;
    r[(2 * j + 1) * n + i] = x.w[j] >> 16;
  }
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

// a, r: [2 NW][n] limbs.
extern "C" int zp_mont_square(int nw, const uint32_t* host_consts, const int64_t* a,
                              int64_t* r, long long n, void* stream_ptr) {
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

// fix: ZP_MAX_NW host words of 2^steps R^3 mod q; a, r: [2 NW][n] limbs.
extern "C" int zp_field_inverse(int nw, const uint32_t* host_consts, const uint32_t* fix,
                                int steps, const int64_t* a, int64_t* r, int n,
                                void* stream_ptr) {
  if (steps < 1) return -3;
  if (n <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int err = zp_set_consts(nw, host_consts, stream);
  if (err) return err;
  InverseConsts k;
  for (int j = 0; j < ZP_MAX_NW; ++j) k.fix[j] = fix[j];
  k.steps = steps;
  const unsigned blocks = (unsigned)((n + INV_THREADS - 1) / INV_THREADS);
#define CALL(NW_) field_inverse_kernel<NW_><<<blocks, INV_THREADS, 0, stream>>>(k, a, r, n)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return (int)cudaGetLastError();
}

// out[0..4] as zp_kernel_info: which = 0 mont_mul_kernel, 1
// mont_square_kernel, 2 field_inverse_kernel.
extern "C" int zp_field_info(int nw, int which, int* out) {
#define CALL(NW_)                                                              \
  return which == 0   ? zp_kernel_info(mont_mul_kernel<NW_>, MUL_THREADS, out)    \
         : which == 1 ? zp_kernel_info(mont_square_kernel<NW_>, MUL_THREADS, out) \
                      : zp_kernel_info(field_inverse_kernel<NW_>, INV_THREADS, out)
  ZP_DISPATCH_NW(nw, CALL)
#undef CALL
  return -1;
}
