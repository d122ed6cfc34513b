// The package's point layout on the host side: int64 tensors of 16-bit
// limbs, one [2 EW][n] array a coordinate (EW = EXT NW words; word k of a
// coordinate is limbs 2k and 2k + 1).  The kernels that read or write
// points in that layout directly (reduce.cu's collapse, sorted.cu's Fq2
// scan) go through these, so the wrappers pack nothing.
#pragma once

#include <stdint.h>

// The three coordinates' limb arrays of n points.
struct Limbs {
  const int64_t* x;
  const int64_t* y;
  const int64_t* z;
};

// Word k (coordinate k / EW) of point i of n; 2 EW n limbs a coordinate fit
// 32-bit offsets (the host checks it).  A select of the coordinate, not an
// index into the pointers (that takes local memory).
template <int EW>
__device__ __forceinline__ uint32_t limb_word(const Limbs& s, int k, uint32_t n, uint32_t i) {
  const int64_t* c = k < EW ? s.x : k < 2 * EW ? s.y : s.z;
  const uint32_t at = 2 * (k % EW) * n + i;
  return (uint32_t)c[at] | ((uint32_t)c[at + n] << 16);
}

// The low limb of word k of point i of n (its high limb lies n further on),
// for copies that keep the limbs (cp.async of their low 32 bits).
template <int EW>
__device__ __forceinline__ const int64_t* limb_at(const Limbs& s, int k, uint32_t n, uint32_t i) {
  const int64_t* c = k < EW ? s.x : k < 2 * EW ? s.y : s.z;
  return c + (2 * (k % EW) * n + i);
}

// Word k of point i of n to limbs [2 rows][n] (rows words a point, the
// coordinates one after another): limb 2k its low half, 2k + 1 its high.
// 2 rows n limbs fit 32-bit offsets (the host checks it).
__device__ __forceinline__ void limb_put(int64_t* limbs, int k, uint32_t n, uint32_t i, uint32_t w) {
  limbs[2 * k * n + i] = w & 0xFFFFu;
  limbs[(2 * k + 1) * n + i] = w >> 16;
}
