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
//   product  Karatsuba, three Fq products in sequence (so one product's
//            temporaries are live at a time):
//            c0 = a0 b0 - a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1;
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

// The Fq product in the form CC names (field.cuh fe_mul says where each is
// faster).
template <int NW, bool CC>
__device__ __forceinline__ void fe_mul_form(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b) {
  if constexpr (CC) fe_mul_cc<NW>(r, a, b);
  else fe_mul<NW>(r, a, b);
}

// Karatsuba; r may alias a or b (both are read before r is written).
template <int NW, bool CC>
__device__ __forceinline__ void fe2_mul(Fe2<NW>& r, const Fe2<NW>& a, const Fe2<NW>& b) {
  Fe<NW> m0, m1, sa, sb;
  fe_mul_form<NW, CC>(m0, a.c0, b.c0);
  fe_mul_form<NW, CC>(m1, a.c1, b.c1);
  fe_add<NW>(sa, a.c0, a.c1);
  fe_add<NW>(sb, b.c0, b.c1);
  fe_mul_form<NW, CC>(sa, sa, sb);
  fe_sub<NW>(sa, sa, m0);
  fe_sub<NW>(r.c1, sa, m1);
  fe_sub<NW>(r.c0, m0, m1);
}

template <int NW>
__device__ __forceinline__ void fe_mul(Fe2<NW>& r, const Fe2<NW>& a, const Fe2<NW>& b) {
  fe2_mul<NW, false>(r, a, b);
}

template <int NW>
__device__ __forceinline__ void fe_mul_cc(Fe2<NW>& r, const Fe2<NW>& a, const Fe2<NW>& b) {
  fe2_mul<NW, true>(r, a, b);
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
