// Montgomery prime-field arithmetic on 32-bit words: device functions.
//
// Counterpart of the JAX package's in-kernel field core
// (zprize_wasm_msm_tpu/ops/field/kcore.py: kmul / kadd / ksub / kneg /
// kis_zero / kselect, and ops/field/ktower.py KFq).  That core works on
// 16-bit limbs in 32-bit lanes with lazy carries because the TPU's vector
// unit has no 64-bit integers and no carry flag.  A CUDA thread has 32x32->64
// multiplies, so an element here is NW = n_limbs/2 little-endian 32-bit
// words: the same integer, the same Montgomery radix R = 2^(32 NW), hence
// the same canonical value bit for bit once re-packed to 16-bit limbs.
//
// One element lives in one thread's registers (Fe<NW>::w, every loop fully
// unrolled so indices are static).  Every function takes canonical inputs
// (< q) and returns a canonical output.
//
// Field constants (q, R mod q, 3b in Montgomery form, -q^{-1} mod 2^32) sit
// in __constant__ memory, written by the host entry point on the launch's
// stream just before the kernel: one source serves every field with
// NW <= ZP_MAX_NW.  Launches for two different curves must therefore not
// overlap on two streams.
#pragma once

#include <stdint.h>

#define ZP_MAX_NW 12

struct FieldConsts {
  uint32_t q[ZP_MAX_NW];    // modulus
  uint32_t one[ZP_MAX_NW];  // R mod q
  uint32_t b3[ZP_MAX_NW];   // 3b * R mod q (curve constant of the a=0 formulas)
  uint32_t np;              // -q^{-1} mod 2^32
};

// One copy per translation unit; each .cu file is built into its own library.
static __constant__ FieldConsts c_fc;

template <int NW>
struct Fe {
  uint32_t w[NW];
};

template <int NW>
__device__ __forceinline__ void fe_zero(Fe<NW>& r) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0u;
}

template <int NW>
__device__ __forceinline__ void fe_one(Fe<NW>& r) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = c_fc.one[i];
}

template <int NW>
__device__ __forceinline__ void fe_b3(Fe<NW>& r) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = c_fc.b3[i];
}

template <int NW>
__device__ __forceinline__ bool fe_is_zero(const Fe<NW>& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= a.w[i];
  return acc == 0u;
}

template <int NW>
__device__ __forceinline__ void fe_select(Fe<NW>& r, bool take_a, const Fe<NW>& a,
                                          const Fe<NW>& b) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = take_a ? a.w[i] : b.w[i];
}

// r = s - q if (carry_in or s >= q) else s, for a value s + carry_in * R < 2q.
template <int NW>
__device__ __forceinline__ void fe_cond_sub_q(Fe<NW>& r, const uint32_t* s,
                                              uint32_t carry_in) {
  uint32_t d[NW];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = (uint64_t)s[i] - c_fc.q[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = t >> 63;  // the 64-bit difference wrapped: borrow out
  }
  bool ge = (carry_in != 0u) || (borrow == 0);
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = ge ? d[i] : s[i];
}

// (a + b) mod q
template <int NW>
__device__ __forceinline__ void fe_add(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b) {
  uint32_t s[NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_cond_sub_q<NW>(r, s, (uint32_t)c);
}

// (a - b) mod q
template <int NW>
__device__ __forceinline__ void fe_sub(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b) {
  uint32_t d[NW];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = (uint64_t)a.w[i] - b.w[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = t >> 63;
  }
  // underflow: add q back (the carry out of that sum cancels the borrow)
  uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)d[i] + (c_fc.q[i] & mask);
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
}

// (-a) mod q, with -0 = 0
template <int NW>
__device__ __forceinline__ void fe_neg(Fe<NW>& r, const Fe<NW>& a) {
  uint32_t keep = fe_is_zero<NW>(a) ? 0u : 0xFFFFFFFFu;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = (uint64_t)c_fc.q[i] - a.w[i] - borrow;
    r.w[i] = (uint32_t)t & keep;
    borrow = t >> 63;
  }
}

// Montgomery product a * b * R^{-1} mod q: coarsely integrated operand
// scanning (CIOS) over 32-bit words with a (NW+2)-word accumulator.  The
// two extra words make it hold for ANY modulus q < R (a, b < q gives an
// accumulator < 2q before the final conditional subtract), so the toy
// field (14 bits of 64), BN254 (254 of 256) and BLS12-381 (381 of 384)
// need no separate carry argument.  64-bit C arithmetic compiles to
// IMAD.WIDE.U32 plus carry adds; each step's sum
// a*b + t + carry <= (2^32-1)^2 + 2(2^32-1) = 2^64 - 1 cannot overflow.
// r may alias a or b.
template <int NW>
__device__ __forceinline__ void fe_mul(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
    const uint32_t bi = b.w[i];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a.w[j] * bi + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);

    const uint32_t m = t[0] * c_fc.np;
    s = (uint64_t)m * c_fc.q[0] + t[0];  // low word becomes 0
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * c_fc.q[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)s;
    t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
  }
  fe_cond_sub_q<NW>(r, t, t[NW]);
}
