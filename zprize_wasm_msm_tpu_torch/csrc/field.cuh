// Montgomery prime-field arithmetic on 32-bit words: device functions.
//
// Counterpart of the JAX package's in-kernel field core
// (zprize_wasm_msm_tpu/ops/field/kcore.py: kmul / kadd / ksub / kneg /
// kis_zero / kselect, and ops/field/ktower.py KFq).  That core works on
// 16-bit limbs in 32-bit lanes with lazy carries because the TPU's vector
// unit has no 64-bit integers and no carry flag.  A CUDA thread has 32x32->64
// multiplies and a carry flag, so an element here is NW = n_limbs/2
// little-endian 32-bit words: the same integer, the same Montgomery radix
// R = 2^(32 NW), hence the same canonical value bit for bit once re-packed
// to 16-bit limbs.
//
// One element lives in one thread's registers (Fe<NW>::w, every loop fully
// unrolled so indices are static).  Every function takes canonical inputs
// (< q) and returns a canonical output.
//
// What bounds it on the H100: integer issue where many threads run, the
// latency of one dependent chain where few do.  A product is ~2 NW^2
// 32x32->64 multiplies plus their carry adds.  Every carry of a sum or a
// difference is a PTX carry chain (chains.cuh: add.cc / addc, sub.cc /
// subc), one asm statement per chain because the carry flag does not
// survive from one asm statement to the next.  The product comes in two
// forms, carry chains (mad.lo.cc / madc.hi.cc) and 64-bit C rows, each where
// it was measured faster (see fe_mul).  Both are the no-carry CIOS, which
// needs the top bit of q free: zp_set_consts refuses a modulus whose top
// word is 2^31 - 1 or more.  The toy field (14 bits of 64), BN254 (254 of
// 256) and BLS12-381 (381 of 384) all qualify.
//
// Field constants (q, R mod q, 3b in Montgomery form, -q^{-1} mod 2^32, and
// over Fq2 the second component of 3b) sit in __constant__ memory, written by the host entry point on the launch's
// stream just before the kernel: one source serves every field with
// NW <= ZP_MAX_NW.  Launches for two different curves must therefore not
// overlap on two streams.  ZP_MAX_NW is 12 (the MSM curves' fields) unless
// a source defines it before this header: field_kernels.cu takes 24
// (MNT6753), and the host lays its block out to match
// (_build.field_kernel_consts).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "chains.cuh"

#ifndef ZP_MAX_NW
#define ZP_MAX_NW 12
#endif

struct FieldConsts {
  uint32_t q[ZP_MAX_NW];     // modulus
  uint32_t one[ZP_MAX_NW];   // R mod q
  uint32_t b3[ZP_MAX_NW];    // 3b * R mod q (curve constant of the a=0 formulas)
  uint32_t np;               // -q^{-1} mod 2^32
  uint32_t b3_1[ZP_MAX_NW];  // over Fq2: component 1 of 3b (b3 holds component 0)
};

// One copy per translation unit; each .cu file is built into its own library.
static __constant__ FieldConsts c_fc;

// Host side of every entry point: refuse a modulus whose top bit is not
// free (the no-carry product needs q[NW-1] < 2^31 - 1; returns -4), then
// copy the constants on the launch's stream.
static int zp_set_consts(int nw, const uint32_t* host_consts, cudaStream_t stream) {
  if (nw < 1 || nw > ZP_MAX_NW) return -1;
  if (host_consts[nw - 1] >= 0x7FFFFFFFu) return -4;
  return (int)cudaMemcpyToSymbolAsync(c_fc, host_consts, sizeof(FieldConsts), 0,
                                      cudaMemcpyHostToDevice, stream);
}

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

template <int NW>
__device__ __forceinline__ void fe_q(uint32_t (&q)[NW]) {
#pragma unroll
  for (int i = 0; i < NW; ++i) q[i] = c_fc.q[i];
}

// r = s - q if s >= q else s, for s < 2q.
template <int NW>
__device__ __forceinline__ void fe_reduce_once(Fe<NW>& r, const uint32_t (&s)[NW]) {
  uint32_t q[NW], d[NW];
  fe_q<NW>(q);
#pragma unroll
  for (int i = 0; i < NW; ++i) d[i] = s[i];
  const uint32_t borrow = Chains<NW>::sub(d, q);
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = borrow ? s[i] : d[i];
}

// (a + b) mod q.  a + b < 2q < R: the sum has no carry out.
template <int NW>
__device__ __forceinline__ void fe_add(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b) {
  uint32_t s[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) s[i] = a.w[i];
  Chains<NW>::add(s, b.w);
  fe_reduce_once<NW>(r, s);
}

// (a - b) mod q: on a borrow, q is added back (its carry out cancels the borrow).
template <int NW>
__device__ __forceinline__ void fe_sub(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b) {
  uint32_t d[NW], qm[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) d[i] = a.w[i];
  const uint32_t borrow = Chains<NW>::sub(d, b.w);
#pragma unroll
  for (int i = 0; i < NW; ++i) qm[i] = c_fc.q[i] & borrow;
  Chains<NW>::add(d, qm);
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = d[i];
}

// (-a) mod q, with -0 = 0
template <int NW>
__device__ __forceinline__ void fe_neg(Fe<NW>& r, const Fe<NW>& a) {
  const uint32_t keep = fe_is_zero<NW>(a) ? 0u : 0xFFFFFFFFu;
  uint32_t d[NW];
  fe_q<NW>(d);
  Chains<NW>::sub(d, a.w);  // a < q: no borrow
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = d[i] & keep;
}

// Montgomery product a * b * R^{-1} mod q: CIOS with the "no-carry"
// accumulator of NW + 1 words, in two forms with one result.  Row i adds
// a * b_i, then m * q with m = t_0 * np, which clears t_0, and shifts one
// word down.  With a < q and the accumulator t < 2q before a row,
// t + a b_i + m q < 2^33 q <= 2^32 R because the top bit of q is free
// (q < R/2, checked on the host): no (NW+2)-th word and no carry word out of
// a row, and t < 2q again after the shift.  One conditional subtract makes
// the result canonical.
//
// fe_mul writes the rows in 64-bit C: ptxas makes each step
// a_j * b_i + t_j + c one IMAD.WIDE.U32 and a carry add, and the NW
// IMAD.WIDEs of a row do not wait on one another: the shortest dependent
// path, at the price of 64-bit register pairs.  fe_mul_cc writes them as
// PTX carry chains (Chains::mac, Chains::reduce: mad.lo.cc / madc.hi.cc,
// four chains a row): ptxas makes each step an IMAD or IMAD.HI and an
// IADD3.X whose carry waits on the step before (it keeps two or three
// chains apart in predicate registers, no more), a longer path in fewer
// registers (32 against 44 in a loop of products).  Measured on the H100
// (csrc/diag/mul_variants.cu, numbers in PERF.md): one product alone,
// fe_mul is 29 % faster; under load the two are within 4 %; inside the Fq
// sweeps fe_mul's register pairs cost resident warps (12 a SM, set by
// registers: see bucket.cu).  So the Fq sweeps' inlined mixed add (group.cuh
// pt_add_mixed) and K7's combine take fe_mul_cc, and everything else takes
// fe_mul: the out-of-line group ops of K2-K4 and K8, whose chains run nearly
// alone, the elementwise kernels, and every Fq2 product (field2.cuh
// fe2_mul_rows, three rows of it interleaved).  Over Fq2 shared memory, not
// registers, sets the residency (6-8 warps a SM at up to 255 registers), so
// the register pairs cost no warps there, and the Fq2 sweeps, one chain a
// thread at under two warps a scheduler, are bound by that chain's latency.
// r may alias a or b.
template <int NW>
__device__ __forceinline__ void fe_mul(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b) {
  uint32_t t[NW + 1];
#pragma unroll
  for (int i = 0; i < NW + 1; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
    const uint32_t bi = b.w[i];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const uint64_t s = (uint64_t)a.w[j] * bi + t[j] + c;  // <= 2^64 - 1
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    t[NW] = (uint32_t)c;
    const uint32_t m = t[0] * c_fc.np;
    uint64_t s = (uint64_t)m * c_fc.q[0] + t[0];  // low word becomes 0
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * c_fc.q[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    t[NW - 1] = t[NW] + (uint32_t)c;  // no carry out: the sum is < 2^32 R
  }
  uint32_t s[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) s[i] = t[i];
  fe_reduce_once<NW>(r, s);
}

// The same product as fe_mul, its rows as PTX carry chains.
template <int NW>
__device__ __forceinline__ void fe_mul_cc(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b) {
  uint32_t q[NW], t[NW + 1];
  fe_q<NW>(q);
  const uint32_t np = c_fc.np;
#pragma unroll
  for (int i = 0; i < NW + 1; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    Chains<NW>::mac(t, a.w, b.w[i]);
    Chains<NW>::reduce(t, q, np);
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = t[j + 1];
    t[NW] = 0u;
  }
  uint32_t s[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) s[i] = t[i];
  fe_reduce_once<NW>(r, s);
}

// Montgomery square a^2 R^{-1} mod q, canonical (the TPU kernel's
// _square_kernel on 16-bit limbs: the upper triangle doubled plus the
// diagonal, then the reduction rows).  Separated operand scanning: the NW
// (NW - 1) / 2 cross products a_i a_j (i < j) once, doubled by a one-bit
// shift of the 2 NW words, the NW squares a_i^2 added on the diagonal, then
// NW reduction rows t += (t_i np mod 2^32) q 2^(32 i), each row's last
// carry kept for the word above the next row's top: NW (NW - 1) / 2 + NW
// products for the square and NW + NW^2 for the reduction (each row's m =
// t_i np and its NW products m q_j) against fe_mul's 2 NW^2 + NW (234
// against 300 at NW = 12).
// a^2 < q^2 and the rows add less than R q, so the top NW words hold less
// than 2q < R: no word beyond them, one conditional subtract.  r may alias
// a.  Every step is 64-bit C, as fe_mul's rows.
template <int NW>
__device__ __forceinline__ void fe_sqr(Fe<NW>& r, const Fe<NW>& a) {
  uint32_t t[2 * NW];
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i + 1 < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < NW; ++j) {
      const uint64_t s = (uint64_t)a.w[i] * a.w[j] + t[i + j] + c;  // <= 2^64 - 1
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + NW] = (uint32_t)c;
  }
  // the cross sum is below 2^(64 NW - 1): its double fits the 2 NW words
#pragma unroll
  for (int i = 2 * NW - 1; i > 0; --i) t[i] = (t[i] << 1) | (t[i - 1] >> 31);
  t[0] <<= 1;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t d = (uint64_t)a.w[i] * a.w[i];
    uint64_t s = (uint64_t)t[2 * i] + (uint32_t)d + c;
    t[2 * i] = (uint32_t)s;
    s = (uint64_t)t[2 * i + 1] + (d >> 32) + (s >> 32);
    t[2 * i + 1] = (uint32_t)s;
    c = s >> 32;
  }
  uint32_t hi = 0;  // carry into word i + NW + 1
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = t[i] * c_fc.np;
    uint64_t s = (uint64_t)m * c_fc.q[0] + t[i];  // low word becomes 0
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      s = (uint64_t)m * c_fc.q[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[i + NW] + c + hi;
    t[i + NW] = (uint32_t)s;
    hi = (uint32_t)(s >> 32);
  }
  uint32_t s[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) s[i] = t[NW + i];
  fe_reduce_once<NW>(r, s);
}
