// Complete projective group law for a = 0 short Weierstrass curves: device
// functions.
//
// Counterpart of the JAX package's in-kernel group layer
// (zprize_wasm_msm_tpu/ops/curve/kgroup.py: kadd_mixed, kadd, kdouble,
// kzero_point): Renes-Costello-Batina 2016 algorithms 8 / 7 / 9.  The
// identity is (0 : 1 : 0); an affine operand (0, 0) is the identity and
// passes the accumulator through (kgroup.py:65-70).  Same formulas, same
// canonical field values: outputs equal the plain PyTorch group ops
// (ops/curve/group.py) bit for bit.
//
// pt_add_mixed, the per-step operation of both sweeps (bucket.cu K1,
// sorted.cu K7), and pt_add_acc, the per-step operation of the lane
// reduction (bucket.cu K4, and its combine), are inlined and take their operands by
// reference: the point, the accumulator and every temporary stay in
// registers, and nvcc schedules their products (fe_mul_cc, the carry-chain
// form that leaves the most resident warps) into the kernel's loop.
// pt_add and pt_double run a few thousand times per MSM (K8, the combine
// of K7's sub-chunks) and stay __noinline__: one body each per field width
// and library keeps nvcc's time in check (twelve fully unrolled products
// per body); their operands cross the call through the thread's stack.
// The collapse and the window fold (reduce.cu K2, K3) run their chains on
// the level-parallel forms of par.cuh.
#pragma once

#include "field.cuh"

template <int NW>
struct __align__(16) Pt {
  Fe<NW> x, y, z;
};

// An affine point as the sweeps read it: x words, then y words.
template <int NW>
struct __align__(16) AffinePt {
  Fe<NW> x, y;
};

template <int NW>
__device__ __forceinline__ void pt_identity(Pt<NW>& r) {
  fe_zero<NW>(r.x);
  fe_one<NW>(r.y);
  fe_zero<NW>(r.z);
}

// The product of the group ops: carry chains in the sweeps (CC), 64-bit
// rows elsewhere (field.cuh fe_mul says why).
template <int NW, bool CC>
__device__ __forceinline__ void mul(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b) {
  if constexpr (CC) fe_mul_cc<NW>(r, a, b);
  else fe_mul<NW>(r, a, b);
}

// Shared tail of algorithms 7 and 8: from t0, t1, t3, t4, Yr (= X1Z2 + X2Z1)
// and t2b (= 3b Z1Z2) to (X3, Y3, Z3).
template <int NW, bool CC>
__device__ __forceinline__ void pt_add_tail(Pt<NW>& r, const Fe<NW>& t0, const Fe<NW>& t1,
                                            const Fe<NW>& t3, const Fe<NW>& t4,
                                            const Fe<NW>& Yr, const Fe<NW>& t2b) {
  Fe<NW> b3, t0_3, Z3l, t1l, Yb, u, v;
  fe_b3<NW>(b3);
  fe_add<NW>(t0_3, t0, t0);
  fe_add<NW>(t0_3, t0_3, t0);
  fe_add<NW>(Z3l, t1, t2b);
  fe_sub<NW>(t1l, t1, t2b);
  mul<NW, CC>(Yb, b3, Yr);

  mul<NW, CC>(u, t3, t1l);
  mul<NW, CC>(v, t4, Yb);
  fe_sub<NW>(r.x, u, v);
  mul<NW, CC>(u, t1l, Z3l);
  mul<NW, CC>(v, Yb, t0_3);
  fe_add<NW>(r.y, u, v);
  mul<NW, CC>(u, Z3l, t4);
  mul<NW, CC>(v, t0_3, t3);
  fe_add<NW>(r.z, u, v);
}

// acc += (X2, Y2): projective + affine, RCB16 algorithm 8 (11 products).
// Inlined; X2, Y2 may not alias acc.
template <int NW>
__device__ __forceinline__ void pt_add_mixed(Pt<NW>& acc, const Fe<NW>& X2, const Fe<NW>& Y2) {
  if (fe_is_zero<NW>(X2) && fe_is_zero<NW>(Y2)) return;
  Fe<NW> b3, t0, t1, t3, t4, Yr, t2b, u;
  fe_mul_cc<NW>(t0, acc.x, X2);
  fe_mul_cc<NW>(t1, acc.y, Y2);
  fe_add<NW>(u, acc.x, acc.y);
  fe_add<NW>(t3, X2, Y2);
  fe_mul_cc<NW>(t3, u, t3);
  fe_sub<NW>(t3, t3, t0);
  fe_sub<NW>(t3, t3, t1);
  fe_mul_cc<NW>(t4, Y2, acc.z);
  fe_add<NW>(t4, t4, acc.y);
  fe_mul_cc<NW>(Yr, X2, acc.z);
  fe_add<NW>(Yr, Yr, acc.x);
  fe_b3<NW>(b3);
  fe_mul_cc<NW>(t2b, b3, acc.z);
  pt_add_tail<NW, true>(acc, t0, t1, t3, t4, Yr, t2b);
}

// r = (X1 : Y1 : Z1) + (X2 : Y2 : Z2): complete projective addition, RCB16
// algorithm 7 (12 products), inlined.  Every operand is read before r is
// first written.  CC picks the product (see mul).
template <int NW, bool CC>
__device__ __forceinline__ void pt_add_body(Pt<NW>& r, const Fe<NW>& X1, const Fe<NW>& Y1,
                                            const Fe<NW>& Z1, const Fe<NW>& X2,
                                            const Fe<NW>& Y2, const Fe<NW>& Z2) {
  Fe<NW> b3, t0, t1, t2, A, t3, t4, Yr, t2b, u, v;
  fe_b3<NW>(b3);
  mul<NW, CC>(t0, X1, X2);
  mul<NW, CC>(t1, Y1, Y2);
  mul<NW, CC>(t2, Z1, Z2);
  fe_add<NW>(u, X1, Y1);
  fe_add<NW>(v, X2, Y2);
  mul<NW, CC>(A, u, v);
  fe_sub<NW>(t3, A, t0);
  fe_sub<NW>(t3, t3, t1);
  fe_add<NW>(u, Y1, Z1);
  fe_add<NW>(v, Y2, Z2);
  mul<NW, CC>(A, u, v);
  fe_sub<NW>(t4, A, t1);
  fe_sub<NW>(t4, t4, t2);
  fe_add<NW>(u, X1, Z1);
  fe_add<NW>(v, X2, Z2);
  mul<NW, CC>(A, u, v);
  fe_sub<NW>(Yr, A, t0);
  fe_sub<NW>(Yr, Yr, t2);
  mul<NW, CC>(t2b, b3, t2);
  pt_add_tail<NW, CC>(r, t0, t1, t3, t4, Yr, t2b);
}

// acc += q, inlined; q (which may not alias acc) is read where its words
// are used, so a q in shared memory takes no registers before then.
template <int NW, bool CC>
__device__ __forceinline__ void pt_add_acc(Pt<NW>& acc, const Pt<NW>& q) {
  const Fe<NW> X1 = acc.x, Y1 = acc.y, Z1 = acc.z;
  pt_add_body<NW, CC>(acc, X1, Y1, Z1, q.x, q.y, q.z);
}

// r = p + q out of line; r may alias p or q.  K7 calls the carry-chain form
// from the sweep: a callee of fewer registers leaves the sweep's live
// registers in place across the call, where the 64-bit form makes ptxas
// spill them.
template <int NW, bool CC = false>
__device__ __noinline__ void pt_add(Pt<NW>* r, const Pt<NW>* p, const Pt<NW>* q) {
  const Fe<NW> X1 = p->x, Y1 = p->y, Z1 = p->z;
  const Fe<NW> X2 = q->x, Y2 = q->y, Z2 = q->z;
  pt_add_body<NW, CC>(*r, X1, Y1, Z1, X2, Y2, Z2);
}

// r = 2p: complete projective doubling, RCB16 algorithm 9 (8 products).
template <int NW>
__device__ __noinline__ void pt_double(Pt<NW>* r, const Pt<NW>* p) {
  const Fe<NW> X = p->x, Y = p->y, Z = p->z;
  Fe<NW> b3, t0, t1, t2, txy, Z8, t2b, Y3s, t0p, u, v;
  fe_b3<NW>(b3);
  fe_mul<NW>(t0, Y, Y);
  fe_mul<NW>(t1, Y, Z);
  fe_mul<NW>(t2, Z, Z);
  fe_mul<NW>(txy, X, Y);
  fe_add<NW>(Z8, t0, t0);
  fe_add<NW>(Z8, Z8, Z8);
  fe_add<NW>(Z8, Z8, Z8);
  fe_mul<NW>(t2b, b3, t2);
  fe_add<NW>(Y3s, t0, t2b);
  fe_add<NW>(u, t2b, t2b);
  fe_add<NW>(u, u, t2b);
  fe_sub<NW>(t0p, t0, u);
  fe_mul<NW>(u, t0p, txy);
  fe_add<NW>(r->x, u, u);
  fe_mul<NW>(u, t2b, Z8);
  fe_mul<NW>(v, t0p, Y3s);
  fe_add<NW>(r->y, u, v);
  fe_mul<NW>(r->z, t1, Z8);
}

// ---- layouts --------------------------------------------------------------
//
// "SoA": a batch of n points as [3][NW][n] words (coordinate, word, element;
// element fastest), i.e. the package's public (L, *batch) layout re-packed
// to 32-bit words: neighbouring threads read neighbouring addresses.
// "AoS": one point as 3*NW contiguous words (x words, y words, z words), the
// layout of the bucket state, where each thread reads a bucket no other
// thread of its warp is near: contiguous per thread fills whole 32-byte
// sectors.

template <int NW>
__device__ __forceinline__ void fe_load_soa(Fe<NW>& r, const uint32_t* base, size_t n,
                                            size_t i) {
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = base[(size_t)k * n + i];
}

template <int NW>
__device__ __forceinline__ void fe_store_soa(uint32_t* base, size_t n, size_t i,
                                             const Fe<NW>& a) {
#pragma unroll
  for (int k = 0; k < NW; ++k) base[(size_t)k * n + i] = a.w[k];
}

template <int NW>
__device__ __forceinline__ void pt_load_soa(Pt<NW>& r, const uint32_t* base, size_t n,
                                            size_t i) {
  fe_load_soa<NW>(r.x, base, n, i);
  fe_load_soa<NW>(r.y, base + (size_t)NW * n, n, i);
  fe_load_soa<NW>(r.z, base + (size_t)2 * NW * n, n, i);
}

template <int NW>
__device__ __forceinline__ void pt_store_soa(uint32_t* base, size_t n, size_t i,
                                             const Pt<NW>& a) {
  fe_store_soa<NW>(base, n, i, a.x);
  fe_store_soa<NW>(base + (size_t)NW * n, n, i, a.y);
  fe_store_soa<NW>(base + (size_t)2 * NW * n, n, i, a.z);
}

template <int NW>
__device__ __forceinline__ void pt_load_aos(Pt<NW>& r, const uint32_t* src) {
  if constexpr ((3 * NW) % 4 == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(&r);
#pragma unroll
    for (int k = 0; k < (3 * NW) / 4; ++k) d4[k] = s4[k];
  } else {
    uint32_t* d = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
    for (int k = 0; k < 3 * NW; ++k) d[k] = src[k];
  }
}

template <int NW>
__device__ __forceinline__ void pt_store_aos(uint32_t* dst, const Pt<NW>& a) {
  if constexpr ((3 * NW) % 4 == 0) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* s4 = reinterpret_cast<const uint4*>(&a);
#pragma unroll
    for (int k = 0; k < (3 * NW) / 4; ++k) d4[k] = s4[k];
  } else {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(&a);
#pragma unroll
    for (int k = 0; k < 3 * NW; ++k) dst[k] = s[k];
  }
}

// Entry points dispatch on the field's word count.
#define ZP_DISPATCH_NW(nw, CALL) \
  switch (nw) {                  \
    case 2: { CALL(2); } break;  \
    case 8: { CALL(8); } break;  \
    case 12: { CALL(12); } break; \
    default: return -1;          \
  }
