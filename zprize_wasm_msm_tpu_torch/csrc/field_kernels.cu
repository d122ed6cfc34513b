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
// takes 2.4 times as long as its integer units, and at NW = 24 (MNT6753)
// still 1.2 times (at 2^20 elements 0.090 ms of bytes at 3.35 TB/s against
// 0.074 ms of operations at 33.5 TOP/s, a multiply-add two operations).
// The square reads and writes
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
// Steps 3 and 4 update a, b and u, v in place, both rows in one pass over
// the words (word j - 1 of a result is written once word j of the operands
// has been read by both rows; q - u is formed word by word with its
// borrow), so a thread holds four elements and no copies: at NW = 24 that
// is 96 words of its 255 registers.
//
// Bound: latency.  One element is ~2 bits(q) dependent iterations of a few
// 64-bit operations and `steps` updates of ~8 NW word products, on one
// thread; bytes are one element in and one out.

#include <cuda_runtime.h>

// this library's constant block holds fields of up to 24 words (MNT6753's
// 753-bit q and r); the MSM libraries keep 12 (csrc/field.cuh)
#define ZP_MAX_NW 24

#include "async.cuh"
#include "group.cuh"

// the widths this library instantiates (_build.FIELD_KERNEL_WORDS)
#define ZP_DISPATCH_FIELD_NW(nw, CALL) \
  switch (nw) {                        \
    case 2: { CALL(2); } break;        \
    case 8: { CALL(8); } break;        \
    case 12: { CALL(12); } break;      \
    case 24: { CALL(24); } break;      \
    default: return -1;                \
  }

#define INV_THREADS 64

struct InverseConsts {
  uint32_t fix[ZP_MAX_NW];  // 2^steps R^3 mod q
  int steps;                // outer steps of 31 iterations
};

// a, b <- (f0 a + g0 b) / 2^31, (f1 a + g1 b) / 2^31 in place, for
// a, b < 2^(32 NW - 1) and |f| + |g| <= 2^31 a row, the low 31 bits of each
// sum zero: each becomes its absolute value, and a row whose sum was
// negative is negated (f, g <- -f, -g).  Each word's sum fits int64:
// |a_j f + b_j g| <= (2^32 - 1) 2^31 and the carry is below 2^31 in size.
// Word j - 1 of a result needs words j - 1 and j of the sum, so it is
// written once both rows have read a_j and b_j.
template <int NW>
__device__ __forceinline__ void lin_shift(uint32_t (&a)[NW], uint32_t (&b)[NW], int64_t& f0,
                                          int64_t& g0, int64_t& f1, int64_t& g1) {
  int64_t c0 = 0, c1 = 0;
  uint32_t p0 = 0, p1 = 0;  // word j - 1 of each sum
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int64_t s0 = (int64_t)a[j] * f0 + (int64_t)b[j] * g0 + c0;
    const int64_t s1 = (int64_t)a[j] * f1 + (int64_t)b[j] * g1 + c1;
    c0 = s0 >> 32;  // arithmetic
    c1 = s1 >> 32;
    if (j > 0) {
      a[j - 1] = (p0 >> 31) | ((uint32_t)s0 << 1);
      b[j - 1] = (p1 >> 31) | ((uint32_t)s1 << 1);
    }
    p0 = (uint32_t)s0;
    p1 = (uint32_t)s1;
  }
  a[NW - 1] = (p0 >> 31) | ((uint32_t)c0 << 1);  // word NW of the sum is c
  b[NW - 1] = (p1 >> 31) | ((uint32_t)c1 << 1);
  // absolute values: (w ^ neg) + (neg & 1)
  const uint32_t n0 = c0 < 0 ? 0xFFFFFFFFu : 0u, n1 = c1 < 0 ? 0xFFFFFFFFu : 0u;
  uint32_t k0 = n0 & 1u, k1 = n1 & 1u;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint64_t s0 = (uint64_t)(a[j] ^ n0) + k0;
    const uint64_t s1 = (uint64_t)(b[j] ^ n1) + k1;
    a[j] = (uint32_t)s0;
    b[j] = (uint32_t)s1;
    k0 = (uint32_t)(s0 >> 32);
    k1 = (uint32_t)(s1 >> 32);
  }
  if (n0) {
    f0 = -f0;
    g0 = -g0;
  }
  if (n1) {
    f1 = -f1;
    g1 = -g1;
  }
}

// u, v <- (f0 u + g0 v) / 2^32 mod q, (f1 u + g1 v) / 2^32 mod q in place,
// for u, v < q and |f| + |g| <= 2^31 a row: a negative factor takes q - u
// (<= q) for u, so a row's sum t = |f| u' + |g| v' < 2^31 q is unsigned;
// m = t_0 np clears its low word, (t + m q) / 2^32 < 2q, and one
// conditional subtract makes it canonical.  q - u and q - v are formed word
// by word with their borrows; word j - 1 of a row's result is written once
// both rows have read u_j and v_j.
template <int NW>
__device__ __forceinline__ void lin_mod(Fe<NW>& u, Fe<NW>& v, int64_t f0, int64_t g0, int64_t f1,
                                        int64_t g1) {
  const uint64_t fa0 = (uint64_t)(f0 < 0 ? -f0 : f0), ga0 = (uint64_t)(g0 < 0 ? -g0 : g0);
  const uint64_t fa1 = (uint64_t)(f1 < 0 ? -f1 : f1), ga1 = (uint64_t)(g1 < 0 ? -g1 : g1);
  uint64_t bu = 0, bv = 0;            // borrows of q - u, q - v
  uint64_t c10 = 0, c20 = 0, c11 = 0, c21 = 0;  // a row's two carries
  uint32_t m0 = 0, m1 = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t qj = c_fc.q[j], uj = u.w[j], vj = v.w[j];
    const uint64_t du = (uint64_t)qj - uj - bu, dv = (uint64_t)qj - vj - bv;
    bu = du >> 63;
    bv = dv >> 63;
    // row 0 and row 1: the sum's word (carry c1), then + m q (carry c2)
    const uint64_t s10 = (uint64_t)(f0 < 0 ? (uint32_t)du : uj) * fa0 +
                         (uint64_t)(g0 < 0 ? (uint32_t)dv : vj) * ga0 + c10;  // < 2^63 + 2^32
    const uint64_t s11 = (uint64_t)(f1 < 0 ? (uint32_t)du : uj) * fa1 +
                         (uint64_t)(g1 < 0 ? (uint32_t)dv : vj) * ga1 + c11;
    c10 = s10 >> 32;
    c11 = s11 >> 32;
    if (j == 0) {
      m0 = (uint32_t)s10 * c_fc.np;
      m1 = (uint32_t)s11 * c_fc.np;
    }
    const uint64_t s20 = (uint64_t)m0 * qj + (uint32_t)s10 + c20;  // <= 2^64 - 1
    const uint64_t s21 = (uint64_t)m1 * qj + (uint32_t)s11 + c21;
    c20 = s20 >> 32;
    c21 = s21 >> 32;
    if (j > 0) {
      u.w[j - 1] = (uint32_t)s20;
      v.w[j - 1] = (uint32_t)s21;
    }
  }
  u.w[NW - 1] = (uint32_t)(c10 + c20);  // the sum is below 2q < 2^(32 NW)
  v.w[NW - 1] = (uint32_t)(c11 + c21);
  fe_reduce_once<NW>(u, u.w);
  fe_reduce_once<NW>(v, v.w);
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
  uint32_t A[NW], B[NW];
  Fe<NW> u, v;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    A[j] = (uint32_t)a[(size_t)(2 * j) * n + i] | ((uint32_t)a[(size_t)(2 * j + 1) * n + i] << 16);
    B[j] = c_fc.q[j];
    u.w[j] = j == 0 ? 1u : 0u;
    v.w[j] = 0u;
  }
  bool x_zero = true;
#pragma unroll
  for (int j = 0; j < NW; ++j) x_zero = x_zero && A[j] == 0u;
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
    lin_shift<NW>(A, B, f0, g0, f1, g1);
    lin_mod<NW>(u, v, f0, g0, f1, g1);
  }
  Fe<NW> fix;  // read from the kernel's parameters only now
#pragma unroll
  for (int j = 0; j < NW; ++j) fix.w[j] = k.fix[j];
  fe_mul<NW>(v, v, fix);
  if (x_zero) fe_zero<NW>(v);
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
__global__ void __launch_bounds__(MUL_THREADS, 1)
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
__global__ void __launch_bounds__(MUL_THREADS, 1)
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
  ZP_DISPATCH_FIELD_NW(nw, CALL)
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
  ZP_DISPATCH_FIELD_NW(nw, CALL)
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
  ZP_DISPATCH_FIELD_NW(nw, CALL)
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
  ZP_DISPATCH_FIELD_NW(nw, CALL)
#undef CALL
  return -1;
}
