// The group ops of the sweep and the lane reduction over Fq2, on points kept
// in shared memory.
//
// Over Fq2 at NW = 12 a point is 72 words and RCB16's formulas keep six
// coordinate-sized values live between their product levels: with the
// point and the accumulator in registers as well, a thread needs far more
// than the 255 registers it may have.  Even with the points in shared
// memory and t3, t4 staged there, ptxas interleaved independent products
// and spilled 190-510 bytes a thread (its report for sm_90a).  So here every
// Fq2 product reads its operands from shared memory and writes its result
// there: the point and the accumulator (the thread's own slots), the
// coordinates that are no longer needed, and four scratch elements a
// thread.  The accesses are volatile PTX (sh_get, sh_put), which the
// compiler keeps in program order and never forwards or caches, and each
// product is a call of its own: a product cannot start before the previous
// one is stored, so one Fq2 product's temporaries (three Fq products in
// sequence) are what the registers hold.
//
// Same formulas (RCB16 algorithms 8 and 7), same products, same canonical
// values: the results equal group.cuh's and the plain PyTorch group ops
// bit for bit.
#pragma once

#include "group.cuh"

// r = the element at s (shared memory)
template <int NW>
__device__ __forceinline__ void sh_get(Fe2<NW>& r, const Fe2<NW>& s) {
  static_assert((2 * NW) % 4 == 0, "an Fq2 element is whole 16-byte words");
  const unsigned a = (unsigned)__cvta_generic_to_shared(&s);
  uint32_t* d = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int k = 0; k < 2 * NW; k += 4)
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(d[k]), "=r"(d[k + 1]), "=r"(d[k + 2]), "=r"(d[k + 3])
                 : "r"(a + 4 * k)
                 : "memory");
}

// s (shared memory) = v
template <int NW>
__device__ __forceinline__ void sh_put(Fe2<NW>& s, const Fe2<NW>& v) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(&s);
  const uint32_t* d = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
  for (int k = 0; k < 2 * NW; k += 4)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
                 :
                 : "r"(a + 4 * k), "r"(d[k]), "r"(d[k + 1]), "r"(d[k + 2]), "r"(d[k + 3])
                 : "memory");
}

// The thread's scratch: STAGE elements of shared memory (a function-scope
// array, one per kernel that calls this).  Fq2 kernels run blocks of at most
// FQ2_BLOCK threads (one warp).
#define FQ2_BLOCK 32
#define FQ2_STAGE 4
template <int NW>
__device__ __forceinline__ Fe2<NW>* stage_elems() {
  __shared__ Fe2<NW> s[FQ2_STAGE * FQ2_BLOCK];
  return s + FQ2_STAGE * threadIdx.x;
}

// The four product steps below are out of line: each is one Fq2 product
// whatever calls it, its operands are shared-memory addresses, and K4 adds
// at three places and every kernel at NW = 2, 8, 12, so inlining would copy
// the ~1 800 instructions of an Fq2 product at NW = 12 dozens of times into
// each kernel for no gain in a chain this long.

// d = s0 * s1 (carry-chain product), all in shared memory; d may alias s0, s1
template <int NW>
__device__ __noinline__ void sh_mul(Fe2<NW>& d, const Fe2<NW>& s0, const Fe2<NW>& s1) {
  Fe2<NW> u, v;
  sh_get<NW>(u, s0);
  sh_get<NW>(v, s1);
  fe_mul_cc<NW>(u, u, v);
  sh_put<NW>(d, u);
}

// d = 3b * s
template <int NW>
__device__ __noinline__ void sh_mul_b3(Fe2<NW>& d, const Fe2<NW>& s) {
  Fe2<NW> u, v;
  fe_b3<NW>(u);
  sh_get<NW>(v, s);
  fe_mul_cc<NW>(u, u, v);
  sh_put<NW>(d, u);
}

// d = (s0 + s1) (s2 + s3) - s4 - s5
template <int NW>
__device__ __noinline__ void sh_mul_sums(Fe2<NW>& d, const Fe2<NW>& s0, const Fe2<NW>& s1,
                                            const Fe2<NW>& s2, const Fe2<NW>& s3,
                                            const Fe2<NW>& s4, const Fe2<NW>& s5) {
  Fe2<NW> u, v;
  sh_get<NW>(u, s0);
  sh_get<NW>(v, s1);
  fe_add<NW>(u, u, v);
  {
    Fe2<NW> w;
    sh_get<NW>(v, s2);
    sh_get<NW>(w, s3);
    fe_add<NW>(v, v, w);
  }
  fe_mul_cc<NW>(u, u, v);
  sh_get<NW>(v, s4);
  fe_sub<NW>(u, u, v);
  sh_get<NW>(v, s5);
  fe_sub<NW>(u, u, v);
  sh_put<NW>(d, u);
}

// d = s0 * s1 + s2 (ADD) or s2 - s0 * s1 (!ADD)
template <int NW, bool ADD>
__device__ __noinline__ void sh_mul_acc(Fe2<NW>& d, const Fe2<NW>& s0, const Fe2<NW>& s1,
                                           const Fe2<NW>& s2) {
  Fe2<NW> u, v;
  sh_get<NW>(u, s0);
  sh_get<NW>(v, s1);
  fe_mul_cc<NW>(u, u, v);
  sh_get<NW>(v, s2);
  if constexpr (ADD) fe_add<NW>(u, u, v);
  else fe_sub<NW>(u, v, u);
  sh_put<NW>(d, u);
}

// The tail shared by both, RCB16's last level, from slots holding
// t0 (S[0]), t1 (S[1]), t2b (S[2]), t3 (S[3]), t4 (t4s), Yr (yrs), into
// out = (X3, Y3, Z3); S, yrs and out.z are overwritten on the way (out.z
// holds nothing the tail reads), and t4s, yrs may be out.y, out.x.
template <int NW>
__device__ __forceinline__ void pt2_tail_sh(Pt<NW, 2>& out, Fe2<NW>* S, const Fe2<NW>& t4s,
                                            Fe2<NW>& yrs) {
  {
    Fe2<NW> t0, t1, t2b, u;
    sh_get<NW>(t0, S[0]);
    fe_add<NW>(u, t0, t0);
    fe_add<NW>(t0, u, t0);
    sh_put<NW>(S[0], t0);  // t0_3
    sh_get<NW>(t1, S[1]);
    sh_get<NW>(t2b, S[2]);
    fe_add<NW>(u, t1, t2b);
    sh_put<NW>(S[2], u);  // Z3l
    fe_sub<NW>(t1, t1, t2b);
    sh_put<NW>(S[1], t1);  // t1l
  }
  sh_mul_b3<NW>(yrs, yrs);                 // Yb
  sh_mul<NW>(out.z, S[3], S[1]);           // t3 t1l
  sh_mul_acc<NW, false>(out.z, t4s, yrs, out.z);  // X3 = t3 t1l - t4 Yb
  sh_mul<NW>(S[1], S[1], S[2]);            // t1l Z3l
  sh_mul_acc<NW, true>(S[1], yrs, S[0], S[1]);    // Y3 = t1l Z3l + Yb t0_3
  sh_mul<NW>(yrs, S[2], t4s);              // Z3l t4
  sh_mul_acc<NW, true>(yrs, S[0], S[3], yrs);     // Z3 = Z3l t4 + t0_3 t3
  // out.x may be yrs and out.y t4s: read all three before writing any
  Fe2<NW> x3, y3, z3;
  sh_get<NW>(x3, out.z);
  sh_get<NW>(y3, S[1]);
  sh_get<NW>(z3, yrs);
  sh_put<NW>(out.x, x3);
  sh_put<NW>(out.y, y3);
  sh_put<NW>(out.z, z3);
}

// acc += (X2, Y2), RCB16 algorithm 8 (11 Fq2 products); acc, X2 and Y2 in
// shared memory, X2 and Y2 overwritten once read for the last time.  The
// affine identity (0, 0) leaves acc as it is.
template <int NW>
__device__ __forceinline__ void pt2_add_mixed_sh(Pt<NW, 2>& acc, Fe2<NW>& X2, Fe2<NW>& Y2) {
  {
    Fe2<NW> u, v;
    sh_get<NW>(u, X2);
    sh_get<NW>(v, Y2);
    if (fe_is_zero<NW>(u) && fe_is_zero<NW>(v)) return;
  }
  Fe2<NW>* S = stage_elems<NW>();
  sh_mul<NW>(S[0], acc.x, X2);                               // t0
  sh_mul<NW>(S[1], acc.y, Y2);                               // t1
  sh_mul_sums<NW>(S[3], acc.x, acc.y, X2, Y2, S[0], S[1]);   // t3
  sh_mul_acc<NW, true>(Y2, Y2, acc.z, acc.y);                // t4 (Y2, acc.y done)
  sh_mul_acc<NW, true>(X2, X2, acc.z, acc.x);                // Yr (X2, acc.x done)
  sh_mul_b3<NW>(S[2], acc.z);                                // t2b (acc.z done)
  pt2_tail_sh<NW>(acc, S, Y2, X2);
}

// acc += q, RCB16 algorithm 7 (12 Fq2 products), acc and q in shared
// memory (q not aliasing acc; it may be another thread's, and is only read).
template <int NW>
__device__ __forceinline__ void pt2_add_sh(Pt<NW, 2>& acc, const Pt<NW, 2>& q) {
  Fe2<NW>* S = stage_elems<NW>();
  sh_mul<NW>(S[0], acc.x, q.x);                                  // t0
  sh_mul<NW>(S[1], acc.y, q.y);                                  // t1
  sh_mul<NW>(S[2], acc.z, q.z);                                  // t2
  sh_mul_sums<NW>(S[3], acc.x, acc.y, q.x, q.y, S[0], S[1]);     // t3
  sh_mul_sums<NW>(acc.y, acc.y, acc.z, q.y, q.z, S[1], S[2]);    // t4 (acc.y done)
  sh_mul_sums<NW>(acc.x, acc.x, acc.z, q.x, q.z, S[0], S[2]);    // Yr (acc.x, acc.z done)
  sh_mul_b3<NW>(S[2], S[2]);                                     // t2b
  pt2_tail_sh<NW>(acc, S, acc.y, acc.x);
}

// The Fq2 form of group.cuh's pt_add_acc, as K4 calls it: acc (its own
// slot) and q in shared memory.
template <int NW, bool CC>
__device__ __forceinline__ void pt_add_acc(Pt<NW, 2>& acc, const Pt<NW, 2>& q) {
  static_assert(CC, "the Fq2 lane reduction uses the carry-chain product");
  pt2_add_sh<NW>(acc, q);
}
