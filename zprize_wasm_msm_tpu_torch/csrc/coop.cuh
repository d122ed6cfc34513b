// One Montgomery product spread over PL lanes of a warp.
//
// A lone warp's product (field.cuh fe_mul) is one thread's ~1 100
// instructions, and in the window fold nothing else runs beside it: the
// fold waits for the product's instructions one after another.  Here PL
// lanes share one product: the same no-carry CIOS rows as fe_mul, each lane
// owning K = NW / PL consecutive words of a, of q and of the accumulator
// (CGBN, NVlabs' cooperative big numbers, is the public precedent; this is
// written from scratch).  A row i is, on every lane at once:
//   1. its K words += a_slice * b_i (b is held whole by every lane), the
//      carry out of its top word kept in a 64-bit carry c of its own;
//   2. m = t_0 * np from lane 0's word 0 (exact: nothing carries into the
//      bottom word), broadcast with __shfl_sync;
//   3. its K words += m * q_slice, the carry again into c;
//   4. the shift by one word: each lane's words move down, its top word
//      takes the next lane's bottom word (__shfl_down_sync) plus its own
//      carry c, whose overflow stays in c (lane 0's bottom word is the zero
//      the row made; the top lane's incoming word is 0).
// So a lane runs ~30 instructions a row instead of ~90, and no carry
// crosses a lane inside the rows.  After NW rows every lane gathers the NW
// words and the carries c (each belongs one word above its lane's top
// word) with shuffles, adds the carries in one carry chain and makes the
// result canonical with one conditional subtract: the same integer as
// fe_mul's accumulator (the rows compute the same m_i and the same sums),
// hence the same canonical word vector, on every lane.
#pragma once

#include "field.cuh"

// Lanes per product for a field of NW words: 4 where 4 divides NW, else 2
// (the toy field, NW = 2).
template <int NW>
__host__ __device__ constexpr int coop_lanes() {
  return NW % 4 == 0 ? 4 : NW % 2 == 0 ? 2 : 1;
}

// r = a * b * R^{-1} mod q, canonical; a, b canonical and the same on the
// PL lanes of this product (lanes rl = 0 .. PL-1, consecutive, PL a power
// of two).  Every lane of the warp must call it together.
template <int NW, int PL>
__device__ __forceinline__ void fe_mul_coop(Fe<NW>& r, const Fe<NW>& a, const Fe<NW>& b, int rl) {
  static_assert(NW % PL == 0, "PL must divide NW");
  constexpr int K = NW / PL;
  uint32_t as[K], qs[K], w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    uint32_t x = a.w[j], y = c_fc.q[j];
#pragma unroll
    for (int l = 1; l < PL; ++l) {
      if (rl == l) {
        x = a.w[l * K + j];
        y = c_fc.q[l * K + j];
      }
    }
    as[j] = x;
    qs[j] = y;
    w[j] = 0u;
  }
  const uint32_t np = c_fc.np;
  uint64_t c = 0;  // carry into the word above this lane's top word
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = b.w[i];
    uint64_t s = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      s = (uint64_t)as[j] * bi + w[j] + (s >> 32);  // <= 2^64 - 1
      w[j] = (uint32_t)s;
    }
    c += s >> 32;
    const uint32_t m = __shfl_sync(0xFFFFFFFFu, w[0] * np, 0, PL);
    s = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      s = (uint64_t)qs[j] * m + w[j] + (s >> 32);
      w[j] = (uint32_t)s;
    }
    c += s >> 32;
    uint32_t in = __shfl_down_sync(0xFFFFFFFFu, w[0], 1, PL);
    if (rl == PL - 1) in = 0u;
#pragma unroll
    for (int j = 0; j < K - 1; ++j) w[j] = w[j + 1];
    const uint64_t top = (uint64_t)in + c;
    w[K - 1] = (uint32_t)top;
    c = top >> 32;
  }
  // gather: word J lives on lane J / K; lane l's carry belongs at word (l+1) K
  // (the top lane's is 0: the accumulator is below 2q < R)
  uint32_t t[NW], add[NW];
#pragma unroll
  for (int J = 0; J < NW; ++J) {
    t[J] = __shfl_sync(0xFFFFFFFFu, w[J % K], J / K, PL);
    add[J] = 0u;
  }
#pragma unroll
  for (int l = 0; l + 1 < PL; ++l) {
    const uint64_t cl = __shfl_sync(0xFFFFFFFFu, c, l, PL);
    add[(l + 1) * K] = (uint32_t)cl;
    if ((l + 1) * K + 1 < NW) add[(l + 1) * K + 1] = (uint32_t)(cl >> 32);
  }
  Chains<NW>::add(t, add);
  fe_reduce_once<NW>(r, t);
}
