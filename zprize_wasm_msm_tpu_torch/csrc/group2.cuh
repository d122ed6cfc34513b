// The group ops of the sweeps, the lane reduction and the segmented scan
// over Fq2, on points kept in shared memory.
//
// Over Fq2 at NW = 12 a point is 72 words and RCB16's formulas keep six
// coordinate-sized values live between their product levels: with the
// point and the accumulator in registers as well, a thread needs far more
// than the 255 registers it may have (ptxas spilled 190-510 bytes a thread
// when products were left to it).  So every Fq2 product reads its operands
// from shared memory and writes its result there: the point and the
// accumulator (the thread's own slots), the coordinates that are no longer
// needed, and a few scratch elements a thread.  The accesses are volatile
// PTX (sh_ld, sh_st), which the compiler keeps in program order and never
// forwards or caches.
//
// An add is a short program of steps (tables c_mixed2 and c_add2 below), run
// by one out-of-line loop, pt2_run: each step is one Fq2 product (field2.cuh
// fe2_mul_rows, its three Fq products interleaved) with the sums before it
// and the sums or differences after it, or the tail's additions, or a copy.
// One copy of the product's code serves every step of both adds, ~5 400
// instructions at NW = 12, and the loop costs one call an add: a body per
// kind of step (five, ~20 000 instructions), or the loop inlined at K7's
// three call sites, ran slower on the H100 (PERF.md).  The loop also holds
// one element in registers from step to step (slot H), a place for an
// element beside those in shared memory, so the mixed add needs two scratch
// elements and the complete add three: the kernels' shared bytes a thread
// set their residency.
//
// Same formulas (RCB16 algorithms 8 and 7), same products, same canonical
// values: the results equal group.cuh's and the plain PyTorch group ops
// bit for bit.
#pragma once

#include "group.cuh"

// r = the element at shared address a; s (shared address a) = v
template <int NW>
__device__ __forceinline__ void sh_ld(Fe2<NW>& r, unsigned a) {
  uint32_t* d = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int k = 0; k < 2 * NW; k += 4)
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(d[k]), "=r"(d[k + 1]), "=r"(d[k + 2]), "=r"(d[k + 3])
                 : "r"(a + 4 * k)
                 : "memory");
}

template <int NW>
__device__ __forceinline__ void sh_st(unsigned a, const Fe2<NW>& v) {
  const uint32_t* d = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
  for (int k = 0; k < 2 * NW; k += 4)
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
                 :
                 : "r"(a + 4 * k), "r"(d[k]), "r"(d[k + 1]), "r"(d[k + 2]), "r"(d[k + 3])
                 : "memory");
}

__device__ __forceinline__ unsigned sh_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The same on an element's reference.
template <int NW>
__device__ __forceinline__ void sh_get(Fe2<NW>& r, const Fe2<NW>& s) {
  static_assert((2 * NW) % 4 == 0, "an Fq2 element is whole 16-byte words");
  sh_ld<NW>(r, sh_addr(&s));
}

template <int NW>
__device__ __forceinline__ void sh_put(Fe2<NW>& s, const Fe2<NW>& v) {
  sh_st<NW>(sh_addr(&s), v);
}

// The thread's scratch of the kernels that do not lay out their own:
// FQ2_STAGE elements of shared memory (a function-scope array, one per
// kernel that calls this).  Fq2 kernels run blocks of at most FQ2_BLOCK
// threads (one warp).
#define FQ2_BLOCK 32
#define FQ2_STAGE 3
template <int NW>
__device__ __forceinline__ Fe2<NW>* stage_elems() {
  __shared__ __align__(16) Fe2<NW> s[FQ2_STAGE * FQ2_BLOCK];
  return s + FQ2_STAGE * threadIdx.x;
}

// The step machine.  Slots: the accumulator's x, y, z (A*), the other
// point's (P*: the mixed add's affine point, which it overwrites, or the
// complete add's q, only read), the scratch elements (S*), the held element
// (H, registers of pt2_run), the curve constant 3b (B3, read only) and none
// (NO).  A step is one word: kind, destination d, operands x0 x1 y0 y1,
// after-terms z0 z1 (and how z0 enters), four bits each.
namespace g2s {
enum Slot : uint32_t { AX, AY, AZ, PX, PY, PZ, S0, S1, S2, H, B3, NO };
enum Kind : uint32_t {
  MUL,   // d = (x0 [+ x1]) (y0 [+ y1]) [z0 term] [- z1]
  ADDS,  // RCB16's additions before its last level: d = 3 d; (x0, y0) = (x0 - y0, x0 + y0)
  COPY,  // d = x0
};
enum Z : uint32_t { ZADD, ZSUB, ZRSUB };  // p + z0, p - z0, z0 - p

__host__ __device__ constexpr uint32_t step(Kind k, Slot d, Slot x0, Slot x1, Slot y0, Slot y1,
                                           Slot z0 = NO, Slot z1 = NO, Z zop = ZADD) {
  return (uint32_t)k | (uint32_t)d << 4 | (uint32_t)x0 << 8 | (uint32_t)x1 << 12 |
         (uint32_t)y0 << 16 | (uint32_t)y1 << 20 | (uint32_t)z0 << 24 | (uint32_t)z1 << 28 |
         (uint32_t)zop << 2;
}

// acc += (X2, Y2), RCB16 algorithm 8, 13 Fq2 products (3b is an Fq2
// element); X2, Y2 overwritten; scratch S0, S1.
constexpr int MIXED_STEPS = 14, MIXED_SCRATCH = 2;
static __constant__ uint32_t c_mixed2[MIXED_STEPS] = {
    step(MUL, S0, AX, NO, PX, NO),                 // t0 = X1 X2
    step(MUL, S1, AY, NO, PY, NO),                 // t1 = Y1 Y2
    step(MUL, H, AX, AY, PX, PY, S0, S1, ZSUB),    // t3 = (X1 + Y1)(X2 + Y2) - t0 - t1
    step(MUL, PY, PY, NO, AZ, NO, AY),             // t4 = Y2 Z1 + Y1
    step(MUL, PX, PX, NO, AZ, NO, AX),             // Yr = X2 Z1 + X1
    step(MUL, AZ, B3, NO, AZ, NO),                 // t2b = 3b Z1
    step(ADDS, S0, S1, NO, AZ, NO),                // t0_3 = 3 t0, t1l = t1 - t2b, Z3l = t1 + t2b
    step(MUL, PX, B3, NO, PX, NO),                 // Yb = 3b Yr
    step(MUL, AX, H, NO, S1, NO),                  // t3 t1l
    step(MUL, AX, PY, NO, PX, NO, AX, NO, ZRSUB),  // X3 = t3 t1l - t4 Yb
    step(MUL, AY, S1, NO, AZ, NO),                 // t1l Z3l
    step(MUL, AY, PX, NO, S0, NO, AY),             // Y3 = t1l Z3l + Yb t0_3
    step(MUL, PX, AZ, NO, PY, NO),                 // Z3l t4
    step(MUL, AZ, S0, NO, H, NO, PX),              // Z3 = Z3l t4 + t0_3 t3
};

// acc += q, RCB16 algorithm 7, 14 Fq2 products; q only read; scratch S0-S2.
constexpr int ADD_STEPS = 17;
static __constant__ uint32_t c_add2[ADD_STEPS] = {
    step(MUL, S0, AX, NO, PX, NO),                 // t0 = X1 X2
    step(MUL, S1, AY, NO, PY, NO),                 // t1 = Y1 Y2
    step(MUL, S2, AZ, NO, PZ, NO),                 // t2 = Z1 Z2
    step(MUL, H, AX, AY, PX, PY, S0, S1, ZSUB),    // t3 = (X1 + Y1)(X2 + Y2) - t0 - t1
    step(MUL, AY, AY, AZ, PY, PZ, S1, S2, ZSUB),   // t4 = (Y1 + Z1)(Y2 + Z2) - t1 - t2
    step(MUL, AX, AX, AZ, PX, PZ, S0, S2, ZSUB),   // Yr = (X1 + Z1)(X2 + Z2) - t0 - t2
    step(MUL, AZ, B3, NO, S2, NO),                 // t2b = 3b t2
    step(ADDS, S0, S1, NO, AZ, NO),                // t0_3, t1l, Z3l
    step(MUL, AX, B3, NO, AX, NO),                 // Yb = 3b Yr
    step(MUL, S2, H, NO, S1, NO),                  // t3 t1l
    step(MUL, S2, AY, NO, AX, NO, S2, NO, ZRSUB),  // X3 = t3 t1l - t4 Yb
    step(MUL, S1, S1, NO, AZ, NO),                 // t1l Z3l
    step(MUL, S1, AX, NO, S0, NO, S1),             // Y3 = t1l Z3l + Yb t0_3
    step(MUL, AX, AZ, NO, AY, NO),                 // Z3l t4
    step(MUL, AZ, S0, NO, H, NO, AX),              // Z3 = Z3l t4 + t0_3 t3
    step(COPY, AX, S2, NO, NO, NO),
    step(COPY, AY, S1, NO, NO, NO),
};
}  // namespace g2s

// Runs program `complete` (c_add2) or not (c_mixed2) on the points at
// shared addresses a (accumulator) and p (other point) with the scratch at
// s.  Out of line: one copy of the Fq2 product's code whatever calls it.
template <int NW>
__device__ __noinline__ void pt2_run(bool complete, unsigned a, unsigned p, unsigned s) {
  constexpr unsigned EB = 8 * NW;  // bytes of an Fq2 element
  Fe2<NW> h;                       // slot H
  using namespace g2s;
  auto at = [&](uint32_t id) {
    return id < PX ? a + id * EB : id < S0 ? p + (id - PX) * EB : s + (id - S0) * EB;
  };
  auto get = [&](Fe2<NW>& r, uint32_t id) {
    if (id == H) r = h;
    else if (id == B3) fe_b3<NW>(r);
    else sh_ld<NW>(r, at(id));
  };
  auto put = [&](uint32_t id, const Fe2<NW>& v) {
    if (id == H) h = v;
    else sh_st<NW>(at(id), v);
  };
  const int n = complete ? ADD_STEPS : MIXED_STEPS;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const uint32_t st = complete ? c_add2[k] : c_mixed2[k];
    const uint32_t kind = st & 3, zop = (st >> 2) & 3, d = (st >> 4) & 15;
    const uint32_t x0 = (st >> 8) & 15, x1 = (st >> 12) & 15, y0 = (st >> 16) & 15;
    const uint32_t y1 = (st >> 20) & 15, z0 = (st >> 24) & 15, z1 = st >> 28;
    Fe2<NW> x, y;
    if (kind == ADDS) {
      get(x, d);
      fe_add<NW>(y, x, x);
      fe_add<NW>(x, y, x);
      put(d, x);
      get(x, x0);
      get(y, y0);
      Fe2<NW> u;
      fe_add<NW>(u, x, y);
      fe_sub<NW>(x, x, y);
      put(y0, u);
      put(x0, x);
      continue;
    }
    get(x, x0);
    if (kind == COPY) {
      put(d, x);
      continue;
    }
    if (x1 != NO) {
      get(y, x1);
      fe_add<NW>(x, x, y);
    }
    get(y, y0);
    if (y1 != NO) {
      Fe2<NW> u;
      get(u, y1);
      fe_add<NW>(y, y, u);
    }
    fe_mul<NW>(x, x, y);
    if (z0 != NO) {
      get(y, z0);
      if (zop == ZADD) fe_add<NW>(x, x, y);
      else if (zop == ZSUB) fe_sub<NW>(x, x, y);
      else fe_sub<NW>(x, y, x);
    }
    if (z1 != NO) {
      get(y, z1);
      fe_sub<NW>(x, x, y);
    }
    put(d, x);
  }
}

// acc += (X2, Y2), algorithm 8; acc and the affine point in shared memory,
// Y2 the element after X2 (an AffinePt's or a Pt's x and y), both
// overwritten; S: g2s::MIXED_SCRATCH elements of the thread's.  The affine
// identity (0, 0) leaves acc as it is.
template <int NW>
__device__ __forceinline__ void pt2_add_mixed_sh(Pt<NW, 2>& acc, Fe2<NW>& X2, Fe2<NW>* S) {
  {
    Fe2<NW> u, v;
    sh_ld<NW>(u, sh_addr(&X2));
    sh_ld<NW>(v, sh_addr(&X2 + 1));
    if (fe_is_zero<NW>(u) && fe_is_zero<NW>(v)) return;
  }
  pt2_run<NW>(false, sh_addr(&acc), sh_addr(&X2), sh_addr(S));
}

// acc += q, algorithm 7, acc and q in shared memory (q not aliasing acc; it
// may be another thread's, and is only read); S: FQ2_STAGE elements.
template <int NW>
__device__ __forceinline__ void pt2_add_sh(Pt<NW, 2>& acc, const Pt<NW, 2>& q, Fe2<NW>* S) {
  pt2_run<NW>(true, sh_addr(&acc), sh_addr(&q), sh_addr(S));
}

// The Fq2 form of group.cuh's pt_add_acc, as K4 calls it: acc (its own
// slot) and q in shared memory.
template <int NW, bool CC>
__device__ __forceinline__ void pt_add_acc(Pt<NW, 2>& acc, const Pt<NW, 2>& q) {
  static_assert(CC, "the Fq2 forms have one product (field2.cuh fe2_mul_rows)");
  pt2_add_sh<NW>(acc, q, stage_elems<NW>());
}
