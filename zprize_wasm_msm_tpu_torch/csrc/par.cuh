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
//
// Over Fq2 (the second half of this file) the same two levels run with an
// Fq2 product on each slot (three Fq products in sequence, each shared by
// PL lanes).  3b is an Fq2 constant: where it is k (1 + u) for a small
// integer k (BLS12-381 G2: 3b = 12 + 12u) its products are additions
// (fe_mul_b3k) and the entry point passes k; else (BN254 G2) b3k is 0 and
// they get a level of products of their own between the two.  The window
// fold runs fold2.cuh's links instead, each Fq2 product's three Fq products
// side by side.  A point is 72 words at NW = 12, too many to
// keep two of them and the levels' values in registers, so the Fq2 forms
// take their points in shared memory (the group's slots; every lane of the
// group writes the same result) and gather only what each slot needs.
#pragma once

#include "coop.cuh"
#include "group2.cuh"

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

// ---- Fq2 ------------------------------------------------------------------

// Karatsuba over three cooperative products (c0 = a0 b0 - a1 b1,
// c1 = (a0 + a1)(b0 + b1) - a0 b0 - a1 b1); r may alias a or b.
template <int NW, int PL>
__device__ __forceinline__ void fe_mul_coop(Fe2<NW>& r, const Fe2<NW>& a, const Fe2<NW>& b,
                                            int rl) {
  Fe<NW> m0, m1, sa, sb;
  fe_mul_coop<NW, PL>(m0, a.c0, b.c0, rl);
  fe_mul_coop<NW, PL>(m1, a.c1, b.c1, rl);
  fe_add<NW>(sa, a.c0, a.c1);
  fe_add<NW>(sb, b.c0, b.c1);
  fe_mul_coop<NW, PL>(sa, sa, sb, rl);
  fe_sub<NW>(sa, sa, m0);
  fe_sub<NW>(r.c1, sa, m1);
  fe_sub<NW>(r.c0, m0, m1);
}

template <int NW, int PL>
__device__ __forceinline__ void fe_shfl(Fe2<NW>& r, const Fe2<NW>& a, int j) {
  fe_shfl<NW, PL>(r.c0, a.c0, j);
  fe_shfl<NW, PL>(r.c1, a.c1, j);
}

template <int NW, int PL>
__device__ __forceinline__ void par_mul(Fe2<NW>& r, const Fe2<NW>& a, const Fe2<NW>& b,
                                        int sub) {
  if constexpr (PL == 1) fe_mul<NW>(r, a, b);
  else fe_mul_coop<NW, PL>(r, a, b, sub % PL);
}

// Whether the Fq2 group ops of par.cuh and fold2.cuh take 3b t as additions
// where the entry point passes a k (else a level of products by fe_b3).
__device__ __forceinline__ constexpr bool b3_as_additions() {
  return true;
}

// r1 = k x1 and r2 = k x2 for a small k >= 1: fe_mul_small's doubling and
// adding on two chains side by side.  r1, r2 may alias x1, x2.
template <int NW>
__device__ __forceinline__ void fe_mul_small2(Fe<NW>& r1, const Fe<NW>& x1, Fe<NW>& r2,
                                              const Fe<NW>& x2, uint32_t k) {
  Fe<NW> a = x1, b = x2;
  for (int i = 30 - __clz(k); i >= 0; --i) {
    fe_add<NW>(a, a, a);
    fe_add<NW>(b, b, b);
    if ((k >> i) & 1u) {
      fe_add<NW>(a, a, x1);
      fe_add<NW>(b, b, x2);
    }
  }
  r1 = a;
  r2 = b;
}

// r = 3b x where 3b = k (1 + u): k (x0 - x1) + k (x0 + x1) u (u^2 = -1), the
// same canonical value as the product by fe_b3.  r may alias x.
template <int NW>
__device__ __forceinline__ void fe_mul_b3k(Fe2<NW>& r, const Fe2<NW>& x, uint32_t k) {
  Fe<NW> d, s;
  fe_sub<NW>(d, x.c0, x.c1);
  fe_add<NW>(s, x.c0, x.c1);
  fe_mul_small2<NW>(r.c0, d, r.c1, s, k);
}

// p = 2p (RCB16 algorithm 9), p in shared memory.  Level 1 as over Fq
// (slot s of 4: Y Y, Y Z, Z Z, X Y); then 3b t2 on every lane (additions
// where b3k = k, else a product by field2.cuh's fe_b3); level 2 (t0' XY,
// 3b t2 8Y^2, t0' Y3s, YZ 8Y^2).
template <int NW, int PL>
__device__ __forceinline__ void pt_double_par(Pt<NW, 2>& p, int sub, uint32_t b3k) {
  const int s = (sub / PL) & 3;
  const Fe2<NW>* pc = &p.x;
  Fe2<NW> a, b, m, t0, t2b, g, u;
  sh_get<NW>(a, pc[s == 3 ? 0 : s == 2 ? 2 : 1]);
  sh_get<NW>(b, pc[s == 0 || s == 3 ? 1 : 2]);
  par_mul<NW, PL>(m, a, b, sub);
  fe_shfl<NW, PL>(a, m, 2);  // t2
  if (b3_as_additions() && b3k) {
    fe_mul_b3k<NW>(t2b, a, b3k);
  } else {
    fe_b3<NW>(b);
    par_mul<NW, PL>(t2b, b, a, sub);
  }
  fe_shfl<NW, PL>(t0, m, 0);
  fe_shfl<NW, PL>(g, m, s == 0 ? 3 : 1);  // XY to slot 0, YZ to slot 3
  fe_add<NW>(u, t2b, t2b);
  fe_add<NW>(u, u, t2b);
  fe_sub<NW>(u, t0, u);  // t0' = t0 - 3 (3b t2)
  fe_select<NW>(a, s == 1, t2b, u);
  fe_select<NW>(a, s == 3, g, a);
  fe_add<NW>(b, t0, t2b);  // Y3s
  fe_add<NW>(t0, t0, t0);
  fe_add<NW>(t0, t0, t0);
  fe_add<NW>(t0, t0, t0);  // Z8 = 8 t0
  fe_select<NW>(b, s == 2, b, t0);
  fe_select<NW>(b, s == 0, g, b);
  par_mul<NW, PL>(m, a, b, sub);
  fe_shfl<NW, PL>(a, m, 0);
  fe_add<NW>(a, a, a);
  fe_shfl<NW, PL>(b, m, 1);
  fe_shfl<NW, PL>(u, m, 2);
  fe_add<NW>(b, b, u);
  fe_shfl<NW, PL>(u, m, 3);
  sh_put<NW>(p.x, a);
  sh_put<NW>(p.y, b);
  sh_put<NW>(p.z, u);
}

// r = p + q (RCB16 algorithm 7), all three in shared memory (r may alias p
// or q).  Level 1 as over Fq (slots 0-5); then slot s holds v_s = 3 t0, t1,
// t2, t3, t4, Yr, each from two gathered products; 3b times v_s (additions
// where b3k = k, else a level of products) makes slot 2's t2b and slot 5's
// Yb; level 2 gathers each slot's two operands (t1l and Z3l from slots 1
// and 2) and runs the tail's six products.  Slots 6 and 7 repeat slot 5; no
// one reads them.
template <int NW, int PL>
__device__ __forceinline__ void pt_add_par(Pt<NW, 2>& r, const Pt<NW, 2>& p,
                                           const Pt<NW, 2>& q, int sub, uint32_t b3k) {
  const int s = min(sub / PL, 5);
  const Fe2<NW>* pc = &p.x;
  const Fe2<NW>* qc = &q.x;
  // level 1: X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2)
  const int i1 = s == 1 || s == 4 ? 1 : s == 2 ? 2 : 0, i2 = s == 3 ? 1 : 2;
  Fe2<NW> a, b, m, f, g;
  sh_get<NW>(a, pc[i1]);
  sh_get<NW>(b, qc[i1]);
  if (s >= 3) {
    sh_get<NW>(f, pc[i2]);
    fe_add<NW>(a, a, f);
    sh_get<NW>(f, qc[i2]);
    fe_add<NW>(b, b, f);
  }
  par_mul<NW, PL>(m, a, b, sub);
  // v_s: slots 3, 4, 5 subtract two of t0, t1, t2; slot 0 triples t0
  fe_shfl<NW, PL>(f, m, s == 4 ? 1 : 0);
  fe_shfl<NW, PL>(g, m, s == 3 ? 1 : 2);
  if (s >= 3) {
    fe_sub<NW>(m, m, f);
    fe_sub<NW>(m, m, g);
  } else if (s == 0) {
    fe_add<NW>(f, m, m);
    fe_add<NW>(m, f, m);
  }
  // 3b v_s: t2b on slot 2, Yb on slot 5
  if (b3_as_additions() && b3k) {
    fe_mul_b3k<NW>(b, m, b3k);
  } else {
    fe_b3<NW>(a);
    par_mul<NW, PL>(b, a, m, sub);
  }
  if (s == 2 || s == 5) m = b;
  // level 2: (t3, t1l), (t4, Yb), (t1l, Z3l), (Yb, 3 t0), (Z3l, t4), (3 t0, t3)
  fe_shfl<NW, PL>(f, m, 1);
  fe_shfl<NW, PL>(g, m, 2);
  Fe2<NW> z3l;
  fe_add<NW>(z3l, f, g);  // Z3l = t1 + t2b
  fe_sub<NW>(f, f, g);    // t1l = t1 - t2b
  fe_shfl<NW, PL>(a, m, s == 0 ? 3 : s == 1 ? 4 : s == 3 ? 5 : 0);
  fe_shfl<NW, PL>(b, m, s == 1 ? 5 : s == 3 ? 0 : s == 4 ? 4 : 3);
  if (s == 2) a = f;
  if (s == 4) a = z3l;
  if (s == 0) b = f;
  if (s == 2) b = z3l;
  par_mul<NW, PL>(m, a, b, sub);
  fe_shfl<NW, PL>(a, m, 0);
  fe_shfl<NW, PL>(b, m, 1);
  fe_sub<NW>(a, a, b);
  fe_shfl<NW, PL>(b, m, 2);
  fe_shfl<NW, PL>(f, m, 3);
  fe_add<NW>(b, b, f);
  fe_shfl<NW, PL>(f, m, 4);
  fe_shfl<NW, PL>(g, m, 5);
  fe_add<NW>(f, f, g);
  sh_put<NW>(r.x, a);
  sh_put<NW>(r.y, b);
  sh_put<NW>(r.z, f);
}

// The point a kernel's generic body works on: over Fq the thread's own
// registers (`own`), over Fq2 slot `slot` of SLOTS points in shared memory
// (the Fq2 group ops above and group2.cuh's take their points there).
template <int NW, int EXT, int SLOTS>
__device__ __forceinline__ Pt<NW, EXT>& work_point(Pt<NW, EXT>& own, int slot) {
  if constexpr (EXT == 1) {
    return own;
  } else {
    __shared__ Pt<NW, EXT> sh[SLOTS];
    return sh[slot];
  }
}
