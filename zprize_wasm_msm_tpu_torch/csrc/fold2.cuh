// The window fold's links over Fq2: one doubling and one addition of
// RCB16 (algorithms 9 and 7) on a point that a whole fold block shares.
//
// The fold (reduce.cu finish2_kernel, K3 over Fq2) is one dependent chain of
// c (W - 1) doublings and W - 1 additions with nothing else on the card, so
// its time is the latency of one link times their number.  par.cuh's Fq2
// link runs three levels of Fq2 products (the product, the product by 3b,
// the product) on a group of 8 PL lanes, each Fq2 product's three Karatsuba
// Fq products one after another: nine product times a doubling.  Here
//   - every Fq product of a level has lanes of its own: slot s's Fq2 product
//     a_s b_s is three products k = 0: a0 b0, 1: a1 b1, 2: (a0 + a1)(b0 +
//     b1), each on PL lanes (coop.cuh fe_mul_coop, or one lane and field.cuh
//     fe_mul where PL = 1): 12 products a doubling's level, 18 an addition's;
//   - an Fq2 element is kept as its three Karatsuba components (Fq2K: v0 =
//     c0, v1 = c1, v2 = c0 + c1), and the lanes of product k compute only
//     component k of what their slot needs: the formulas' sums are linear,
//     so they act on each component alone, and a level's operands need no
//     sum;
//   - the level's products meet in shared memory (Fold2Sh): each stores its
//     product, the block waits (fold2_sync), the lanes of (s, k) turn slot
//     s's three products into component k of its Fq2 result (c0 = m0 - m1,
//     c1 = m2 - m0 - m1, c0 + c1 = m2 - 2 m1), the block waits again;
//   - where 3b = k (1 + u) with a small integer k (BLS12-381 G2: k = 12),
//     3b t is additions: (1 + u) t has the components t0 - t1, t2 = t0 +
//     t1 and 2 t0 (fold2_twist), times k by doublings and additions
//     (par.cuh fe_mul_small), so a link has two levels, as over Fq; any
//     other 3b (BN254 G2) keeps a level of products by the constant of
//     field2.cuh fe_b3.  The entry point passes k, or 0;
//   - the new point's nine components are stored by the lanes of slots 0 ..
//     2 and the block waits once more.
// So a link takes two Fq product times (three with the product by 3b), a
// few dozen sums on one Fq element a lane, and five barriers.  The links
// are out-of-line bodies (fold2_link_double, fold2_link_add), one of each
// for every call site.
//
// Two forms from one body: PL = coop_lanes lanes a product on a block of
// NT = 96 threads, warp k taking component k of every slot (fold2_k: the
// sums that depend on k branch without diverging; the levels meet across
// warps, so fold2_sync is a named barrier over the block), or PL = 1 on one
// warp (32 lanes, __syncwarp).  reduce.cu takes the faster (chip_smoke.py
// times both as link_us); check.cu runs both.
//
// Every product is fe_mul_coop / fe_mul and every sum fe_add / fe_sub on
// canonical values, so the results equal par.cuh's, group.cuh's and the
// plain PyTorch group ops bit for bit.
#pragma once

#include "par.cuh"

#define FOLD2_SLOTS 6  // Fq2 products a level, at most (the addition's)

// An Fq2 element by its Karatsuba components: c0, c1, c0 + c1.
template <int NW>
struct __align__(16) Fq2K {
  Fe<NW> v[3];
};

// A point of the fold: X, Y, Z.
template <int NW>
struct __align__(16) PtK {
  Fq2K<NW> c[3];
};

// The block's exchange: the level's Fq products (slot s's three at 3 s ..
// 3 s + 2), its Fq2 results, and the addition's Yr' where 3b t is
// additions.  A level reads m only before the barrier that follows its
// reconstruction, and r only before the next level's first barrier, so one
// buffer of each serves every level.
template <int NW>
struct __align__(16) Fold2Sh {
  Fq2K<NW> r[FOLD2_SLOTS];
  Fe<NW> m[3 * FOLD2_SLOTS];
  Fq2K<NW> y;
};

// The block's barrier: the lanes of one warp, or a named barrier (1) over
// the NT threads of the block.
template <int NT>
__device__ __forceinline__ void fold2_sync() {
  if constexpr (NT == 32) __syncwarp();
  else asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");
}

template <int NW>
__device__ __forceinline__ void sh_get(Fe<NW>& r, const Fe<NW>& s) {
  static_assert(NW % 2 == 0, "an Fq element is whole 8-byte words");
  const unsigned a = sh_addr(&s);
#pragma unroll
  for (int k = 0; k < NW; k += 2)
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(r.w[k]), "=r"(r.w[k + 1])
                 : "r"(a + 4 * k)
                 : "memory");
}

template <int NW>
__device__ __forceinline__ void sh_put(Fe<NW>& s, const Fe<NW>& v) {
  const unsigned a = sh_addr(&s);
#pragma unroll
  for (int k = 0; k < NW; k += 2)
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(a + 4 * k), "r"(v.w[k]), "r"(v.w[k + 1])
                 : "memory");
}

// Where a thread works: slot s, Karatsuba component k.  In the block of
// three warps, warp k holds component k of every slot, a slot's PL lanes at
// lane s PL: k is the same on a warp's lanes, so the few sums that depend
// on it branch without diverging.  On one warp, unit t / PL is component
// unit % 3 of slot unit / 3.  Threads past the level's last slot repeat it
// and store nothing.
template <int PL, int NT>
__device__ __forceinline__ int fold2_k() {
  static_assert(NT == 32 || NT == 96, "one warp, or three");
  if constexpr (NT == 32) return (int)threadIdx.x / PL % 3;
  else return (int)threadIdx.x / 32;
}

template <int PL, int NT>
__device__ __forceinline__ int fold2_slot_of() {
  if constexpr (NT == 32) return (int)threadIdx.x / PL / 3;
  else return (int)threadIdx.x % 32 / PL;
}

template <int PL, int NT>
__device__ __forceinline__ int fold2_slot(int n) {
  return min(fold2_slot_of<PL, NT>(), n - 1);
}

// Whether this thread stores for its (slot, k): the first of its PL lanes,
// a slot below n.
template <int PL, int NT>
__device__ __forceinline__ bool fold2_lead(int n) {
  return (int)threadIdx.x % PL == 0 && fold2_slot_of<PL, NT>() < n;
}

// One level of n Fq2 products: x, y = component k of this thread's slot's
// two operands (every lane of a product passes the same) -> sh.r[0 .. n -
// 1], read after the return.
template <int NW, int PL, int NT>
__device__ __forceinline__ void fold2_level(Fold2Sh<NW>& sh, Fe<NW>& x, Fe<NW>& y, int n) {
  const int k = fold2_k<PL, NT>(), s = fold2_slot<PL, NT>(n);
  const bool lead = fold2_lead<PL, NT>(n);
  par_mul<NW, PL>(x, x, y, threadIdx.x);
  if (lead) sh_put<NW>(sh.m[3 * s + k], x);
  fold2_sync<NT>();
  // component k of slot s: m0 - m1, m2 - m0 - m1, m2 - m1 - m1
  Fe<NW> m0, m1;
  sh_get<NW>(m0, sh.m[3 * s]);
  sh_get<NW>(m1, sh.m[3 * s + 1]);
  if constexpr (NT == 32) {
    Fe<NW> zero;
    fe_zero<NW>(zero);
    sh_get<NW>(x, sh.m[3 * s + 2]);
    fe_select<NW>(x, k == 0, m0, x);
    fe_select<NW>(y, k == 1, m0, m1);
    fe_select<NW>(y, k == 0, zero, y);
    fe_sub<NW>(x, x, y);
  } else if (k == 0) {
    x = m0;
  } else {
    sh_get<NW>(x, sh.m[3 * s + 2]);
    fe_select<NW>(y, k == 1, m0, m1);  // (a reference chosen at run time would put both on the stack)
    fe_sub<NW>(x, x, y);
  }
  fe_sub<NW>(x, x, m1);
  if (lead) sh_put<NW>(sh.r[s].v[k], x);
  fold2_sync<NT>();
}

// d = component k of (1 + u) v: v0 - v1, v2, 2 v0 (v in shared memory).
template <int NW, int NT>
__device__ __forceinline__ void fold2_twist(Fe<NW>& d, const Fq2K<NW>& v, int k) {
  Fe<NW> x, y;
  if constexpr (NT == 32) {
    Fe<NW> zero, s;
    fe_zero<NW>(zero);
    sh_get<NW>(x, v.v[k == 1 ? 2 : 0]);
    sh_get<NW>(y, v.v[k == 0 ? 1 : 0]);
    fe_select<NW>(y, k == 1, zero, y);
    fe_add<NW>(s, x, y);
    fe_sub<NW>(d, x, y);
    fe_select<NW>(d, k == 0, d, s);
  } else if (k == 1) {
    sh_get<NW>(d, v.v[2]);
  } else {
    sh_get<NW>(x, v.v[0]);
    sh_get<NW>(y, v.v[k == 0 ? 1 : 0]);
    if (k == 0) fe_sub<NW>(d, x, y);
    else fe_add<NW>(d, x, y);
  }
}

// Component k of the constant 3b (field2.cuh fe_b3).
template <int NW>
__device__ __forceinline__ void fold2_b3(Fe<NW>& r, int k) {
  Fe2<NW> b;
  fe_b3<NW>(b);
  Fe<NW> s;
  fe_add<NW>(s, b.c0, b.c1);
  fe_select<NW>(r, k == 1, b.c1, b.c0);
  fe_select<NW>(r, k == 2, s, r);
}

// p = 2p.  Level 1 (slots Y Y, Y Z, Z Z, X Y as par.cuh's); 3b t2; level 2
// (t0' XY, 3b t2 8Y^2, t0' Y3s, YZ 8Y^2); X = 2 r0, Y = r1 + r2, Z = r3.
template <int NW, int PL, int NT>
__device__ __forceinline__ void fold2_double_body(PtK<NW>& p, Fold2Sh<NW>& sh, uint32_t b3k) {
  const int s = fold2_slot<PL, NT>(4), k = fold2_k<PL, NT>();
  Fe<NW> x, y, t0, t2b, g, z8;
  sh_get<NW>(x, p.c[s == 3 ? 0 : s == 2 ? 2 : 1].v[k]);
  sh_get<NW>(y, p.c[s == 0 || s == 3 ? 1 : 2].v[k]);
  fold2_level<NW, PL, NT>(sh, x, y, 4);
  sh_get<NW>(t0, sh.r[0].v[k]);
  sh_get<NW>(g, sh.r[s == 0 ? 3 : 1].v[k]);  // XY to slot 0, YZ to slot 3
  fe_add<NW>(z8, t0, t0);
  if (b3_as_additions() && b3k) {
    fold2_twist<NW, NT>(t2b, sh.r[2], k);  // beside Z8's chain
    fe_add<NW>(z8, z8, z8);
    fe_add<NW>(z8, z8, z8);  // Z8 = 8 t0
    fe_mul_small<NW>(t2b, t2b, b3k);
  } else {
    fe_add<NW>(z8, z8, z8);
    fe_add<NW>(z8, z8, z8);
    fold2_b3<NW>(t2b, k);
    sh_get<NW>(y, sh.r[2].v[k]);
    fold2_level<NW, PL, NT>(sh, t2b, y, 1);
    sh_get<NW>(t2b, sh.r[0].v[k]);
  }
  fe_add<NW>(x, t2b, t2b);
  fe_add<NW>(y, t0, t2b);  // Y3s
  fe_add<NW>(x, x, t2b);
  fe_sub<NW>(x, t0, x);  // t0' = t0 - 3 (3b t2)
  fe_select<NW>(x, s == 1, t2b, x);
  fe_select<NW>(x, s == 3, g, x);
  fe_select<NW>(y, s == 2, y, z8);
  fe_select<NW>(y, s == 0, g, y);
  fold2_level<NW, PL, NT>(sh, x, y, 4);
  // slots 0 .. 2 store component k of coordinate c = slot: r0 + r0, r1 + r2, r3 + 0
  const int c = min(fold2_slot_of<PL, NT>(), 2);
  sh_get<NW>(x, sh.r[c == 0 ? 0 : c == 1 ? 1 : 3].v[k]);
  sh_get<NW>(y, sh.r[c == 0 ? 0 : 2].v[k]);
  fe_zero<NW>(g);
  fe_select<NW>(y, c == 2, g, y);
  fe_add<NW>(x, x, y);
  if (fold2_lead<PL, NT>(3)) sh_put<NW>(p.c[c].v[k], x);
  fold2_sync<NT>();
}

// r = p + q (r may alias p or q).  Level 1 as par.cuh's (X1X2, Y1Y2, Z1Z2
// and three products of sums: t0 .. t4, Yr); then t3' = t3 - t0 - t1, t4' =
// t4 - t1 - t2, Yr' = Yr - t0 - t2, 3 t0, t2b = 3b t2, Yb = 3b Yr', t1l =
// t1 - t2b, Z3l = t1 + t2b, each thread keeping only its slot's two operands
// of level 2: (t3', t1l), (t4', Yb), (t1l, Z3l), (Yb, 3 t0), (Z3l, t4'),
// (3 t0, t3'); X = r0 - r1, Y = r2 + r3, Z = r4 + r5.
template <int NW, int PL, int NT>
__device__ __forceinline__ void fold2_add_body(PtK<NW>& r, const PtK<NW>& p, const PtK<NW>& q,
                                               Fold2Sh<NW>& sh, uint32_t b3k) {
  const int s = fold2_slot<PL, NT>(6), k = fold2_k<PL, NT>();
  const int i1 = s == 1 || s == 4 ? 1 : s == 2 ? 2 : 0, i2 = s == 3 ? 1 : 2;
  Fe<NW> x, y, f, g, t1, t2;
  fe_zero<NW>(g);
  sh_get<NW>(x, p.c[i1].v[k]);
  sh_get<NW>(f, p.c[i2].v[k]);
  fe_select<NW>(f, s >= 3, f, g);
  fe_add<NW>(x, x, f);
  sh_get<NW>(y, q.c[i1].v[k]);
  sh_get<NW>(f, q.c[i2].v[k]);
  fe_select<NW>(f, s >= 3, f, g);
  fe_add<NW>(y, y, f);
  fold2_level<NW, PL, NT>(sh, x, y, 6);
  // Yr' = Yr - t0 - t2 (f)
  sh_get<NW>(f, sh.r[5].v[k]);
  sh_get<NW>(g, sh.r[0].v[k]);
  fe_sub<NW>(f, f, g);
  sh_get<NW>(t2, sh.r[2].v[k]);
  fe_sub<NW>(f, f, t2);
  // t3' to slots 0 (x) and 5 (y), t4' to slots 1 (x) and 4 (y), 3 t0 to
  // slots 5 (x) and 3 (y)
  sh_get<NW>(x, sh.r[3].v[k]);
  fe_sub<NW>(x, x, g);
  sh_get<NW>(t1, sh.r[1].v[k]);
  fe_sub<NW>(x, x, t1);
  y = x;
  Fe<NW> h;
  sh_get<NW>(h, sh.r[4].v[k]);
  fe_sub<NW>(h, h, t1);
  fe_sub<NW>(h, h, t2);
  fe_select<NW>(x, s == 1, h, x);
  fe_select<NW>(y, s == 4, h, y);
  fe_add<NW>(h, g, g);
  fe_add<NW>(h, h, g);
  fe_select<NW>(x, s == 5, h, x);
  fe_select<NW>(y, s == 3, h, y);
  // t2b = 3b t2 (g), Yb = 3b Yr' (f); where 3b t is additions, Yr' goes
  // to sh.y for its twist (a barrier, cheaper than twisting Yr, t0 and t2
  // apart)
  if (b3_as_additions() && b3k) {
    if (fold2_lead<PL, NT>(1)) sh_put<NW>(sh.y.v[k], f);
    fold2_sync<NT>();
    fold2_twist<NW, NT>(g, sh.r[2], k);
    fold2_twist<NW, NT>(f, sh.y, k);
    fe_mul_small2<NW>(g, g, f, f, b3k);
  } else {  // slot 0 of the level 3b t2, slot 1 3b Yr'
    Fe<NW> c;
    fold2_b3<NW>(c, k);
    fe_select<NW>(f, fold2_slot<PL, NT>(2) == 0, t2, f);
    fold2_level<NW, PL, NT>(sh, c, f, 2);
    sh_get<NW>(g, sh.r[0].v[k]);
    sh_get<NW>(f, sh.r[1].v[k]);
  }
  // Yb to slots 3 (x) and 1 (y)
  fe_select<NW>(x, s == 3, f, x);
  fe_select<NW>(y, s == 1, f, y);
  // t1l to slots 2 (x) and 0 (y), Z3l to slots 4 (x) and 2 (y)
  fe_sub<NW>(f, t1, g);
  fe_add<NW>(g, t1, g);
  fe_select<NW>(x, s == 2, f, x);
  fe_select<NW>(y, s == 0, f, y);
  fe_select<NW>(x, s == 4, g, x);
  fe_select<NW>(y, s == 2, g, y);
  fold2_level<NW, PL, NT>(sh, x, y, 6);
  // slots 0 .. 2 store component k of coordinate c = slot: r0 - r1, r2 + r3, r4 + r5
  const int c = min(fold2_slot_of<PL, NT>(), 2);
  sh_get<NW>(x, sh.r[2 * c].v[k]);
  sh_get<NW>(y, sh.r[2 * c + 1].v[k]);
  fe_sub<NW>(f, x, y);
  fe_add<NW>(x, x, y);
  fe_select<NW>(x, c == 0, f, x);
  if (fold2_lead<PL, NT>(3)) sh_put<NW>(r.c[c].v[k], x);
  fold2_sync<NT>();
}

// The links as the fold calls them, out of line; every thread of the block
// calls them together, with the same b3k (k where 3b = k (1 + u), else 0).
template <int NW, int PL, int NT>
__device__ __noinline__ void fold2_link_double(PtK<NW>* p, Fold2Sh<NW>* sh, uint32_t b3k) {
  fold2_double_body<NW, PL, NT>(*p, *sh, b3k);
}

template <int NW, int PL, int NT>
__device__ __noinline__ void fold2_link_add(PtK<NW>* r, const PtK<NW>* p, const PtK<NW>* q,
                                            Fold2Sh<NW>* sh, uint32_t b3k) {
  fold2_add_body<NW, PL, NT>(*r, *p, *q, *sh, b3k);
}

// Point i of n from [3][2 NW][n] words into p; every thread of the block
// writes the same values.  Out of line, as the links are: it runs once a
// window.
template <int NW>
__device__ __noinline__ void fold2_load(PtK<NW>& p, const uint32_t* base, size_t n, size_t i) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    Fe2<NW> e;
    Fe<NW> s;
    fe_load_soa<NW>(e, base + (size_t)c * 2 * NW * n, n, i);
    fe_add<NW>(s, e.c0, e.c1);
    sh_put<NW>(p.c[c].v[0], e.c0);
    sh_put<NW>(p.c[c].v[1], e.c1);
    sh_put<NW>(p.c[c].v[2], s);
  }
}

// p to point i of n of [3][2 NW][n] words (c0, c1).
template <int NW>
__device__ __forceinline__ void fold2_store(uint32_t* base, size_t n, size_t i, const PtK<NW>& p) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    Fe2<NW> e;
    sh_get<NW>(e.c0, p.c[c].v[0]);
    sh_get<NW>(e.c1, p.c[c].v[1]);
    fe_store_soa<NW>(base + (size_t)c * 2 * NW * n, n, i, e);
  }
}
