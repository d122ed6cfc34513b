// Level-parallel group ops: one point on a group of 8 PL lanes of a warp.
//
// Where a chain of group ops runs alone on the card (the window fold of
// reduce.cu finish_kernel: c*(W-1) doublings in a row), one op's time is
// the time of its products one after another.  A lone warp's product is
// bound by the warp's own instruction stream (~1.25 us at NW = 12,
// csrc/diag/run_mul_variants.sh), and the products of RCB16's doubling
// (algorithm 9) and complete addition (algorithm 7) fall into two levels of
// independent products once the product by the curve constant 3b is
// written as additions:
//   doubling  Y*Y, Y*Z, Z*Z, X*Y            then  t0'*XY, 3bZ^2*8Y^2, t0'*Y3s, YZ*8Y^2
//   addition  X1X2, Y1Y2, Z1Z2 and three     then  the six products of the tail
//             products of sums
// So a group of 8 PL lanes holds the point, replicated; lanes s PL ..
// s PL + PL - 1 of the group compute product s of a level (SIMT: the four
// or six products cost one product's instructions), on one lane (PL = 1,
// fe_mul) or shared by PL lanes (coop.cuh fe_mul_coop, fewer instructions
// a lane), and every lane gathers the level's results with __shfl_sync
// inside its group.  A doubling costs two product times instead of eight,
// an addition two instead of twelve.
//
// Every product is field.cuh's fe_mul (or its cooperative form, the same
// canonical result) and every sum fe_add / fe_sub, on the same operands as
// group.cuh's pt_double / pt_add, and 3b * t is the same
// canonical value whether it is one product by 3b*R or additions of t: the
// results equal pt_double / pt_add (and the plain PyTorch group ops) bit
// for bit.  b3k is 3b as an integer (12 on BLS12-381, 9 on BN254 and the
// toy curve), passed by the entry point.
//
// Every lane of the warp must call these functions together, with the same
// b3k (they shuffle with the full mask); groups of one warp may hold
// different points.
#pragma once

#include "coop.cuh"
#include "group.cuh"

// r = product j of the group's level (computed on its lanes j PL ..)
template <int NW, int PL>
__device__ __forceinline__ void fe_shfl(Fe<NW>& r, const Fe<NW>& a, int j) {
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = __shfl_sync(0xFFFFFFFFu, a.w[k], j * PL, 8 * PL);
}

// r = a * b on this lane's share: sub = lane index within the group
template <int NW, int PL>
__device__ __forceinline__ void par_mul(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b, int sub) {
  if constexpr (PL == 1) fe_mul<NW>(r, a, b);
  else fe_mul_coop<NW, PL>(r, a, b, sub % PL);
}

// r = v_s (the last value for s beyond the list)
template <int NW>
__device__ __forceinline__ void fe_pick4(Fe<NW>& r, int s, const Fe<NW>& v0, const Fe<NW>& v1,
                                         const Fe<NW>& v2, const Fe<NW>& v3) {
#pragma unroll
  for (int k = 0; k < NW; ++k)
    r.w[k] = s == 0 ? v0.w[k] : s == 1 ? v1.w[k] : s == 2 ? v2.w[k] : v3.w[k];
}

template <int NW>
__device__ __forceinline__ void fe_pick6(Fe<NW>& r, int s, const Fe<NW>& v0, const Fe<NW>& v1,
                                         const Fe<NW>& v2, const Fe<NW>& v3, const Fe<NW>& v4,
                                         const Fe<NW>& v5) {
#pragma unroll
  for (int k = 0; k < NW; ++k)
    r.w[k] = s == 0 ? v0.w[k]
           : s == 1 ? v1.w[k]
           : s == 2 ? v2.w[k]
           : s == 3 ? v3.w[k]
           : s == 4 ? v4.w[k]
                    : v5.w[k];
}

// r = k * a mod q for a small k >= 1, by MSB-first doubling and adding.
template <int NW>
__device__ __forceinline__ void fe_mul_small(Fe<NW>& r, const Fe<NW>& a, uint32_t k) {
  Fe<NW> acc = a;
  for (int i = 30 - __clz(k); i >= 0; --i) {
    fe_add<NW>(acc, acc, acc);
    if ((k >> i) & 1u) fe_add<NW>(acc, acc, a);
  }
  r = acc;
}

// p = 2p (RCB16 algorithm 9); sub = lane index within the group.
template <int NW, int PL>
__device__ __forceinline__ void pt_double_par(Pt<NW>& p, int sub, uint32_t b3k) {
  const int s = (sub / PL) & 3;
  Fe<NW> a, b, m;
  fe_pick4<NW>(a, s, p.y, p.y, p.z, p.x);
  fe_pick4<NW>(b, s, p.y, p.z, p.z, p.y);
  par_mul<NW, PL>(m, a, b, sub);
  Fe<NW> t0, t1, t2, txy;
  fe_shfl<NW, PL>(t0, m, 0);
  fe_shfl<NW, PL>(t1, m, 1);
  fe_shfl<NW, PL>(t2, m, 2);
  fe_shfl<NW, PL>(txy, m, 3);
  Fe<NW> Z8, t2b, Y3s, u, t0p;
  fe_add<NW>(Z8, t0, t0);
  fe_add<NW>(Z8, Z8, Z8);
  fe_add<NW>(Z8, Z8, Z8);
  fe_mul_small<NW>(t2b, t2, b3k);
  fe_add<NW>(Y3s, t0, t2b);
  fe_add<NW>(u, t2b, t2b);
  fe_add<NW>(u, u, t2b);
  fe_sub<NW>(t0p, t0, u);
  fe_pick4<NW>(a, s, t0p, t2b, t0p, t1);
  fe_pick4<NW>(b, s, txy, Z8, Y3s, Z8);
  par_mul<NW, PL>(m, a, b, sub);
  Fe<NW> r0, r1, r2;
  fe_shfl<NW, PL>(r0, m, 0);
  fe_shfl<NW, PL>(r1, m, 1);
  fe_shfl<NW, PL>(r2, m, 2);
  fe_shfl<NW, PL>(p.z, m, 3);
  fe_add<NW>(p.x, r0, r0);
  fe_add<NW>(p.y, r1, r2);
}

// r = p + q (RCB16 algorithm 7); r may alias p or q.
template <int NW, int PL>
__device__ __forceinline__ void pt_add_par(Pt<NW>& r, const Pt<NW>& p, const Pt<NW>& q, int sub,
                                           uint32_t b3k) {
  const int s = sub / PL;
  Fe<NW> zero, a, b, h, m;
  fe_zero<NW>(zero);
  // level 1: X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)
  fe_pick6<NW>(a, s, p.x, p.y, p.z, p.x, p.y, p.x);
  fe_pick6<NW>(h, s, zero, zero, zero, p.y, p.z, p.z);
  fe_add<NW>(a, a, h);
  fe_pick6<NW>(b, s, q.x, q.y, q.z, q.x, q.y, q.x);
  fe_pick6<NW>(h, s, zero, zero, zero, q.y, q.z, q.z);
  fe_add<NW>(b, b, h);
  par_mul<NW, PL>(m, a, b, sub);
  Fe<NW> t0, t1, t2, t3, t4, Yr;
  fe_shfl<NW, PL>(t0, m, 0);
  fe_shfl<NW, PL>(t1, m, 1);
  fe_shfl<NW, PL>(t2, m, 2);
  fe_shfl<NW, PL>(t3, m, 3);
  fe_shfl<NW, PL>(t4, m, 4);
  fe_shfl<NW, PL>(Yr, m, 5);
  fe_sub<NW>(t3, t3, t0);
  fe_sub<NW>(t3, t3, t1);
  fe_sub<NW>(t4, t4, t1);
  fe_sub<NW>(t4, t4, t2);
  fe_sub<NW>(Yr, Yr, t0);
  fe_sub<NW>(Yr, Yr, t2);
  // the tail of pt_add_tail, its products by 3b as additions
  Fe<NW> t2b, Yb, t0_3, Z3l, t1l;
  fe_mul_small<NW>(t2b, t2, b3k);
  fe_mul_small<NW>(Yb, Yr, b3k);
  fe_add<NW>(t0_3, t0, t0);
  fe_add<NW>(t0_3, t0_3, t0);
  fe_add<NW>(Z3l, t1, t2b);
  fe_sub<NW>(t1l, t1, t2b);
  fe_pick6<NW>(a, s, t3, t4, t1l, Yb, Z3l, t0_3);
  fe_pick6<NW>(b, s, t1l, Yb, Z3l, t0_3, t4, t3);
  par_mul<NW, PL>(m, a, b, sub);
  Fe<NW> r0, r1, r2, r3, r4, r5;
  fe_shfl<NW, PL>(r0, m, 0);
  fe_shfl<NW, PL>(r1, m, 1);
  fe_shfl<NW, PL>(r2, m, 2);
  fe_shfl<NW, PL>(r3, m, 3);
  fe_shfl<NW, PL>(r4, m, 4);
  fe_shfl<NW, PL>(r5, m, 5);
  fe_sub<NW>(r.x, r0, r1);
  fe_add<NW>(r.y, r2, r3);
  fe_add<NW>(r.z, r4, r5);
}

// r = k * s for 1 <= k < 2^bits: `bits` rounds of a doubling and an
// addition kept where bit i of k is set.  Every group of the warp runs the
// same rounds whatever its k (the shuffles need every lane).
template <int NW, int PL>
__device__ __forceinline__ void ladder_par(Pt<NW>& r, const Pt<NW>& s, int k, int bits, int sub,
                                           uint32_t b3k) {
  pt_identity<NW>(r);
  for (int i = bits - 1; i >= 0; --i) {
    pt_double_par<NW, PL>(r, sub, b3k);
    Pt<NW> t;
    pt_add_par<NW, PL>(t, r, s, sub, b3k);
    if ((k >> i) & 1) r = t;
  }
}

// r = the point of the lane `off` lanes away (lane ^ off), whole warp.
template <int NW>
__device__ __forceinline__ void pt_shfl_xor(Pt<NW>& r, const Pt<NW>& a, int off) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(&a);
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int k = 0; k < 3 * NW; ++k) o[k] = __shfl_xor_sync(0xFFFFFFFFu, s[k], off);
}
