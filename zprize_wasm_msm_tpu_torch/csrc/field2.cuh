// The quadratic extension Fq2 = Fq[u]/(u^2 + 1) on 32-bit words: device
// functions.
//
// Counterpart of the JAX package's in-kernel Fq2 (zprize_wasm_msm_tpu/ops/
// field/ktower.py KFq2, the nr = -1 fast path), which the TPU kernels take
// from curve.kfield to run the same MSM kernels over G2.  An element is two
// field.cuh elements, component 0 then component 1: 2 NW consecutive words,
// the layout of the package's flat (2L, *batch) limbs re-packed to words.
// Every curve of the registry with an Fq2 has nr = -1 (u^2 = -1); the host
// refuses any other (_build.curve_consts).
//
// The functions carry the names of field.cuh's, overloaded on the element
// type, so the group code of group.cuh and par.cuh serves both fields.
// Canonical inputs give canonical outputs, so every result equals the plain
// PyTorch Fq2 (ops/field/tower.py) bit for bit:
//   product  Karatsuba, c0 = a0 b0 - a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0 -
//            a1 b1, its three Fq products interleaved row by row in one
//            thread (fe2_mul_rows): three independent dependent chains, on
//            field.cuh's 64-bit-row CIOS.  The Fq2 kernels are bound by the
//            latency of one thread's chain at 6-8 warps a SM (shared memory
//            sets their residency, not registers), so three products in
//            sequence would leave most issue slots idle;
//   square   complex squaring, two products: (a0 + a1)(a0 - a1), 2 a0 a1.
#pragma once

#include "field.cuh"

template <int NW>
struct Fe2 {
  Fe<NW> c0, c1;
};

// The element of a field of NW words and extension degree EXT (1 or 2).
template <int NW, int EXT>
struct ElemOf;
template <int NW>
struct ElemOf<NW, 1> {
  using type = Fe<NW>;
};
template <int NW>
struct ElemOf<NW, 2> {
  using type = Fe2<NW>;
};
template <int NW, int EXT>
using Elem = typename ElemOf<NW, EXT>::type;

template <int NW>
__device__ __forceinline__ void fe_zero(Fe2<NW>& r) {
  fe_zero<NW>(r.c0);
  fe_zero<NW>(r.c1);
}

template <int NW>
__device__ __forceinline__ void fe_one(Fe2<NW>& r) {
  fe_one<NW>(r.c0);
  fe_zero<NW>(r.c1);
}

template <int NW>
__device__ __forceinline__ void fe_b3(Fe2<NW>& r) {
  fe_b3<NW>(r.c0);
#pragma unroll
  for (int i = 0; i < NW; ++i) r.c1.w[i] = c_fc.b3_1[i];
}

template <int NW>
__device__ __forceinline__ bool fe_is_zero(const Fe2<NW>& a) {
  return fe_is_zero<NW>(a.c0) && fe_is_zero<NW>(a.c1);
}

template <int NW>
__device__ __forceinline__ void fe_select(Fe2<NW>& r, bool take_a, const Fe2<NW>& a,
                                          const Fe2<NW>& b) {
  fe_select<NW>(r.c0, take_a, a.c0, b.c0);
  fe_select<NW>(r.c1, take_a, a.c1, b.c1);
}

template <int NW>
__device__ __forceinline__ void fe_add(Fe2<NW>& r, const Fe2<NW>& a, const Fe2<NW>& b) {
  fe_add<NW>(r.c0, a.c0, b.c0);
  fe_add<NW>(r.c1, a.c1, b.c1);
}

template <int NW>
__device__ __forceinline__ void fe_sub(Fe2<NW>& r, const Fe2<NW>& a, const Fe2<NW>& b) {
  fe_sub<NW>(r.c0, a.c0, b.c0);
  fe_sub<NW>(r.c1, a.c1, b.c1);
}

template <int NW>
__device__ __forceinline__ void fe_neg(Fe2<NW>& r, const Fe2<NW>& a) {
  fe_neg<NW>(r.c0, a.c0);
  fe_neg<NW>(r.c1, a.c1);
}

// One CIOS row of the no-carry product (field.cuh fe_mul) on three
// accumulators at once: t_k = (t_k + a_k b_k + m_k q) / 2^32, k = 0, 1, 2.
// The three rows do not depend on one another, and each word step is
// written for all three before the next, so ptxas can issue one row's
// IMAD.WIDE while another's carry add waits.
template <int NW>
__device__ __forceinline__ void cios_rows3(uint32_t (&t)[3][NW + 1], const Fe<NW> (&a)[3],
                                           const uint32_t (&b)[3]) {
  uint64_t c[3] = {0, 0, 0};
#pragma unroll
  for (int j = 0; j < NW; ++j) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint64_t s = (uint64_t)a[k].w[j] * b[k] + t[k][j] + c[k];  // <= 2^64 - 1
      t[k][j] = (uint32_t)s;
      c[k] = s >> 32;
    }
  }
  uint32_t m[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    t[k][NW] = (uint32_t)c[k];
    m[k] = t[k][0] * c_fc.np;
    c[k] = ((uint64_t)m[k] * c_fc.q[0] + t[k][0]) >> 32;  // low word becomes 0
  }
#pragma unroll
  for (int j = 1; j < NW; ++j) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint64_t s = (uint64_t)m[k] * c_fc.q[j] + t[k][j] + c[k];
      t[k][j - 1] = (uint32_t)s;
      c[k] = s >> 32;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k][NW - 1] = t[k][NW] + (uint32_t)c[k];  // no carry out
}

// Karatsuba with its three Fq products interleaved: a0 b0, a1 b1 and
// (a0 + a1)(b0 + b1) advance one CIOS row each per step.  r may alias a or
// b (both are read before r is written).
template <int NW>
__device__ __forceinline__ void fe2_mul_rows(Fe2<NW>& r, const Fe2<NW>& a, const Fe2<NW>& b) {
  Fe<NW> x[3], m[3];
  uint32_t y[3][NW];
  x[0] = a.c0;
  x[1] = a.c1;
  fe_add<NW>(x[2], a.c0, a.c1);
  {
    Fe<NW> sb;
    fe_add<NW>(sb, b.c0, b.c1);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      y[0][i] = b.c0.w[i];
      y[1][i] = b.c1.w[i];
      y[2][i] = sb.w[i];
    }
  }
  uint32_t t[3][NW + 1];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < NW + 1; ++i) t[k][i] = 0u;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi[3] = {y[0][i], y[1][i], y[2][i]};
    cios_rows3<NW>(t, x, bi);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uint32_t s[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) s[i] = t[k][i];
    fe_reduce_once<NW>(m[k], s);
  }
  fe_sub<NW>(m[2], m[2], m[0]);
  fe_sub<NW>(r.c1, m[2], m[1]);
  fe_sub<NW>(r.c0, m[0], m[1]);
}

template <int NW>
__device__ __forceinline__ void fe_mul(Fe2<NW>& r, const Fe2<NW>& a, const Fe2<NW>& b) {
  fe2_mul_rows<NW>(r, a, b);
}

// Complex squaring: (a0 + a1)(a0 - a1), 2 a0 a1.  r may alias a.
template <int NW>
__device__ __forceinline__ void fe_sqr(Fe2<NW>& r, const Fe2<NW>& a) {
  Fe<NW> s, d;
  fe_add<NW>(s, a.c0, a.c1);
  fe_sub<NW>(d, a.c0, a.c1);
  fe_mul<NW>(r.c1, a.c0, a.c1);
  fe_add<NW>(r.c1, r.c1, r.c1);
  fe_mul<NW>(r.c0, s, d);
}
