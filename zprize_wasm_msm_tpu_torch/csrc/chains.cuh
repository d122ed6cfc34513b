// GENERATED by gen_chains.py (same directory); edit that script, not this file.
//
// PTX carry chains of the field core (field.cuh), one specialization per
// field width.  Every chain is ONE asm statement: the carry flag does not
// survive from one asm statement to the next.
#pragma once

#include <stdint.h>

template <int NW>
struct Chains;

template <>
struct Chains<2> {
  // s += b
  static __device__ __forceinline__ void add(uint32_t (&s)[2], const uint32_t (&b)[2]) {
    asm volatile(
        "{\n\t"
        "add.cc.u32 %0, %0, %2;\n\t"
        "addc.u32 %1, %1, %3;\n\t"
        "}"
        : "+r"(s[0]), "+r"(s[1])
        : "r"(b[0]), "r"(b[1]));
  }
  // d -= b; returns 0xffffffff on a borrow out, else 0
  static __device__ __forceinline__ uint32_t sub(uint32_t (&d)[2], const uint32_t (&b)[2]) {
    uint32_t mask;
    asm volatile(
        "{\n\t"
        "sub.cc.u32 %1, %1, %3;\n\t"
        "subc.cc.u32 %2, %2, %4;\n\t"
        "subc.u32 %0, 0, 0;\n\t"
        "}"
        : "=r"(mask), "+r"(d[0]), "+r"(d[1])
        : "r"(b[0]), "r"(b[1]));
    return mask;
  }
  // t[0..2] = t[0..1] + a * b
  static __device__ __forceinline__ void mac(uint32_t (&t)[3], const uint32_t (&a)[2],
                                             uint32_t b) {
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %3, %5, %0;\n\t"
        "madc.lo.cc.u32 %1, %4, %5, %1;\n\t"
        "addc.u32 %2, 0, 0;\n\t"
        "mad.hi.cc.u32 %1, %3, %5, %1;\n\t"
        "madc.hi.u32 %2, %4, %5, %2;\n\t"
        "}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2])
        : "r"(a[0]), "r"(a[1]), "r"(b));
  }
  // t[0..2] += (t[0] * np mod 2^32) * q: t[0] becomes 0
  static __device__ __forceinline__ void reduce(uint32_t (&t)[3], const uint32_t (&q)[2],
                                                uint32_t np) {
    asm volatile(
        "{\n\t"
        ".reg .u32 m;\n\t"
        "mul.lo.u32 m, %0, %5;\n\t"
        "mad.lo.cc.u32 %0, m, %3, %0;\n\t"
        "madc.lo.cc.u32 %1, m, %4, %1;\n\t"
        "addc.u32 %2, %2, 0;\n\t"
        "mad.hi.cc.u32 %1, m, %3, %1;\n\t"
        "madc.hi.u32 %2, m, %4, %2;\n\t"
        "}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2])
        : "r"(q[0]), "r"(q[1]), "r"(np));
  }
};

template <>
struct Chains<8> {
  // s += b
  static __device__ __forceinline__ void add(uint32_t (&s)[8], const uint32_t (&b)[8]) {
    asm volatile(
        "{\n\t"
        "add.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32 %7, %7, %15;\n\t"
        "}"
        : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]), "+r"(s[6]), "+r"(s[7])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  }
  // d -= b; returns 0xffffffff on a borrow out, else 0
  static __device__ __forceinline__ uint32_t sub(uint32_t (&d)[8], const uint32_t (&b)[8]) {
    uint32_t mask;
    asm volatile(
        "{\n\t"
        "sub.cc.u32 %1, %1, %9;\n\t"
        "subc.cc.u32 %2, %2, %10;\n\t"
        "subc.cc.u32 %3, %3, %11;\n\t"
        "subc.cc.u32 %4, %4, %12;\n\t"
        "subc.cc.u32 %5, %5, %13;\n\t"
        "subc.cc.u32 %6, %6, %14;\n\t"
        "subc.cc.u32 %7, %7, %15;\n\t"
        "subc.cc.u32 %8, %8, %16;\n\t"
        "subc.u32 %0, 0, 0;\n\t"
        "}"
        : "=r"(mask), "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
    return mask;
  }
  // t[0..8] = t[0..7] + a * b
  static __device__ __forceinline__ void mac(uint32_t (&t)[9], const uint32_t (&a)[8],
                                             uint32_t b) {
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
        "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
        "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
        "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
        "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
        "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
        "addc.u32 %8, 0, 0;\n\t"
        "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
        "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
        "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
        "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
        "madc.hi.u32 %8, %16, %17, %8;\n\t"
        "}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(b));
  }
  // t[0..8] += (t[0] * np mod 2^32) * q: t[0] becomes 0
  static __device__ __forceinline__ void reduce(uint32_t (&t)[9], const uint32_t (&q)[8],
                                                uint32_t np) {
    asm volatile(
        "{\n\t"
        ".reg .u32 m;\n\t"
        "mul.lo.u32 m, %0, %17;\n\t"
        "mad.lo.cc.u32 %0, m, %9, %0;\n\t"
        "madc.lo.cc.u32 %1, m, %10, %1;\n\t"
        "madc.lo.cc.u32 %2, m, %11, %2;\n\t"
        "madc.lo.cc.u32 %3, m, %12, %3;\n\t"
        "madc.lo.cc.u32 %4, m, %13, %4;\n\t"
        "madc.lo.cc.u32 %5, m, %14, %5;\n\t"
        "madc.lo.cc.u32 %6, m, %15, %6;\n\t"
        "madc.lo.cc.u32 %7, m, %16, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "mad.hi.cc.u32 %1, m, %9, %1;\n\t"
        "madc.hi.cc.u32 %2, m, %10, %2;\n\t"
        "madc.hi.cc.u32 %3, m, %11, %3;\n\t"
        "madc.hi.cc.u32 %4, m, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, m, %13, %5;\n\t"
        "madc.hi.cc.u32 %6, m, %14, %6;\n\t"
        "madc.hi.cc.u32 %7, m, %15, %7;\n\t"
        "madc.hi.u32 %8, m, %16, %8;\n\t"
        "}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
        : "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]), "r"(q[4]), "r"(q[5]), "r"(q[6]), "r"(q[7]), "r"(np));
  }
};

template <>
struct Chains<12> {
  // s += b
  static __device__ __forceinline__ void add(uint32_t (&s)[12], const uint32_t (&b)[12]) {
    asm volatile(
        "{\n\t"
        "add.cc.u32 %0, %0, %12;\n\t"
        "addc.cc.u32 %1, %1, %13;\n\t"
        "addc.cc.u32 %2, %2, %14;\n\t"
        "addc.cc.u32 %3, %3, %15;\n\t"
        "addc.cc.u32 %4, %4, %16;\n\t"
        "addc.cc.u32 %5, %5, %17;\n\t"
        "addc.cc.u32 %6, %6, %18;\n\t"
        "addc.cc.u32 %7, %7, %19;\n\t"
        "addc.cc.u32 %8, %8, %20;\n\t"
        "addc.cc.u32 %9, %9, %21;\n\t"
        "addc.cc.u32 %10, %10, %22;\n\t"
        "addc.u32 %11, %11, %23;\n\t"
        "}"
        : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]), "+r"(s[6]), "+r"(s[7]), "+r"(s[8]), "+r"(s[9]), "+r"(s[10]), "+r"(s[11])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
  }
  // d -= b; returns 0xffffffff on a borrow out, else 0
  static __device__ __forceinline__ uint32_t sub(uint32_t (&d)[12], const uint32_t (&b)[12]) {
    uint32_t mask;
    asm volatile(
        "{\n\t"
        "sub.cc.u32 %1, %1, %13;\n\t"
        "subc.cc.u32 %2, %2, %14;\n\t"
        "subc.cc.u32 %3, %3, %15;\n\t"
        "subc.cc.u32 %4, %4, %16;\n\t"
        "subc.cc.u32 %5, %5, %17;\n\t"
        "subc.cc.u32 %6, %6, %18;\n\t"
        "subc.cc.u32 %7, %7, %19;\n\t"
        "subc.cc.u32 %8, %8, %20;\n\t"
        "subc.cc.u32 %9, %9, %21;\n\t"
        "subc.cc.u32 %10, %10, %22;\n\t"
        "subc.cc.u32 %11, %11, %23;\n\t"
        "subc.cc.u32 %12, %12, %24;\n\t"
        "subc.u32 %0, 0, 0;\n\t"
        "}"
        : "=r"(mask), "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
    return mask;
  }
  // t[0..12] = t[0..11] + a * b
  static __device__ __forceinline__ void mac(uint32_t (&t)[13], const uint32_t (&a)[12],
                                             uint32_t b) {
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %25, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, %25, %1;\n\t"
        "madc.lo.cc.u32 %2, %15, %25, %2;\n\t"
        "madc.lo.cc.u32 %3, %16, %25, %3;\n\t"
        "madc.lo.cc.u32 %4, %17, %25, %4;\n\t"
        "madc.lo.cc.u32 %5, %18, %25, %5;\n\t"
        "madc.lo.cc.u32 %6, %19, %25, %6;\n\t"
        "madc.lo.cc.u32 %7, %20, %25, %7;\n\t"
        "madc.lo.cc.u32 %8, %21, %25, %8;\n\t"
        "madc.lo.cc.u32 %9, %22, %25, %9;\n\t"
        "madc.lo.cc.u32 %10, %23, %25, %10;\n\t"
        "madc.lo.cc.u32 %11, %24, %25, %11;\n\t"
        "addc.u32 %12, 0, 0;\n\t"
        "mad.hi.cc.u32 %1, %13, %25, %1;\n\t"
        "madc.hi.cc.u32 %2, %14, %25, %2;\n\t"
        "madc.hi.cc.u32 %3, %15, %25, %3;\n\t"
        "madc.hi.cc.u32 %4, %16, %25, %4;\n\t"
        "madc.hi.cc.u32 %5, %17, %25, %5;\n\t"
        "madc.hi.cc.u32 %6, %18, %25, %6;\n\t"
        "madc.hi.cc.u32 %7, %19, %25, %7;\n\t"
        "madc.hi.cc.u32 %8, %20, %25, %8;\n\t"
        "madc.hi.cc.u32 %9, %21, %25, %9;\n\t"
        "madc.hi.cc.u32 %10, %22, %25, %10;\n\t"
        "madc.hi.cc.u32 %11, %23, %25, %11;\n\t"
        "madc.hi.u32 %12, %24, %25, %12;\n\t"
        "}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(b));
  }
  // t[0..12] += (t[0] * np mod 2^32) * q: t[0] becomes 0
  static __device__ __forceinline__ void reduce(uint32_t (&t)[13], const uint32_t (&q)[12],
                                                uint32_t np) {
    asm volatile(
        "{\n\t"
        ".reg .u32 m;\n\t"
        "mul.lo.u32 m, %0, %25;\n\t"
        "mad.lo.cc.u32 %0, m, %13, %0;\n\t"
        "madc.lo.cc.u32 %1, m, %14, %1;\n\t"
        "madc.lo.cc.u32 %2, m, %15, %2;\n\t"
        "madc.lo.cc.u32 %3, m, %16, %3;\n\t"
        "madc.lo.cc.u32 %4, m, %17, %4;\n\t"
        "madc.lo.cc.u32 %5, m, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, m, %19, %6;\n\t"
        "madc.lo.cc.u32 %7, m, %20, %7;\n\t"
        "madc.lo.cc.u32 %8, m, %21, %8;\n\t"
        "madc.lo.cc.u32 %9, m, %22, %9;\n\t"
        "madc.lo.cc.u32 %10, m, %23, %10;\n\t"
        "madc.lo.cc.u32 %11, m, %24, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "mad.hi.cc.u32 %1, m, %13, %1;\n\t"
        "madc.hi.cc.u32 %2, m, %14, %2;\n\t"
        "madc.hi.cc.u32 %3, m, %15, %3;\n\t"
        "madc.hi.cc.u32 %4, m, %16, %4;\n\t"
        "madc.hi.cc.u32 %5, m, %17, %5;\n\t"
        "madc.hi.cc.u32 %6, m, %18, %6;\n\t"
        "madc.hi.cc.u32 %7, m, %19, %7;\n\t"
        "madc.hi.cc.u32 %8, m, %20, %8;\n\t"
        "madc.hi.cc.u32 %9, m, %21, %9;\n\t"
        "madc.hi.cc.u32 %10, m, %22, %10;\n\t"
        "madc.hi.cc.u32 %11, m, %23, %11;\n\t"
        "madc.hi.u32 %12, m, %24, %12;\n\t"
        "}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12])
        : "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]), "r"(q[4]), "r"(q[5]), "r"(q[6]), "r"(q[7]), "r"(q[8]), "r"(q[9]), "r"(q[10]), "r"(q[11]), "r"(np));
  }
};

template <>
struct Chains<24> {
  // s += b
  static __device__ __forceinline__ void add(uint32_t (&s)[24], const uint32_t (&b)[24]) {
    uint32_t c;
    asm volatile(
        "{\n\t"
        "add.cc.u32 %0, %0, %13;\n\t"
        "addc.cc.u32 %1, %1, %14;\n\t"
        "addc.cc.u32 %2, %2, %15;\n\t"
        "addc.cc.u32 %3, %3, %16;\n\t"
        "addc.cc.u32 %4, %4, %17;\n\t"
        "addc.cc.u32 %5, %5, %18;\n\t"
        "addc.cc.u32 %6, %6, %19;\n\t"
        "addc.cc.u32 %7, %7, %20;\n\t"
        "addc.cc.u32 %8, %8, %21;\n\t"
        "addc.cc.u32 %9, %9, %22;\n\t"
        "addc.cc.u32 %10, %10, %23;\n\t"
        "addc.cc.u32 %11, %11, %24;\n\t"
        "addc.u32 %12, 0, 0;\n\t"
        "}"
        : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]), "+r"(s[6]), "+r"(s[7]), "+r"(s[8]), "+r"(s[9]), "+r"(s[10]), "+r"(s[11]), "=r"(c)
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
    asm volatile(
        "{\n\t"
        ".reg .u32 x;\n\t"
        "add.cc.u32 x, %24, 0xffffffff;\n\t"
        "addc.cc.u32 %0, %0, %12;\n\t"
        "addc.cc.u32 %1, %1, %13;\n\t"
        "addc.cc.u32 %2, %2, %14;\n\t"
        "addc.cc.u32 %3, %3, %15;\n\t"
        "addc.cc.u32 %4, %4, %16;\n\t"
        "addc.cc.u32 %5, %5, %17;\n\t"
        "addc.cc.u32 %6, %6, %18;\n\t"
        "addc.cc.u32 %7, %7, %19;\n\t"
        "addc.cc.u32 %8, %8, %20;\n\t"
        "addc.cc.u32 %9, %9, %21;\n\t"
        "addc.cc.u32 %10, %10, %22;\n\t"
        "addc.u32 %11, %11, %23;\n\t"
        "}"
        : "+r"(s[12]), "+r"(s[13]), "+r"(s[14]), "+r"(s[15]), "+r"(s[16]), "+r"(s[17]), "+r"(s[18]), "+r"(s[19]), "+r"(s[20]), "+r"(s[21]), "+r"(s[22]), "+r"(s[23])
        : "r"(b[12]), "r"(b[13]), "r"(b[14]), "r"(b[15]), "r"(b[16]), "r"(b[17]), "r"(b[18]), "r"(b[19]), "r"(b[20]), "r"(b[21]), "r"(b[22]), "r"(b[23]), "r"(c));
  }
  // d -= b; returns 0xffffffff on a borrow out, else 0
  static __device__ __forceinline__ uint32_t sub(uint32_t (&d)[24], const uint32_t (&b)[24]) {
    uint32_t mask;
    asm volatile(
        "{\n\t"
        "sub.cc.u32 %1, %1, %13;\n\t"
        "subc.cc.u32 %2, %2, %14;\n\t"
        "subc.cc.u32 %3, %3, %15;\n\t"
        "subc.cc.u32 %4, %4, %16;\n\t"
        "subc.cc.u32 %5, %5, %17;\n\t"
        "subc.cc.u32 %6, %6, %18;\n\t"
        "subc.cc.u32 %7, %7, %19;\n\t"
        "subc.cc.u32 %8, %8, %20;\n\t"
        "subc.cc.u32 %9, %9, %21;\n\t"
        "subc.cc.u32 %10, %10, %22;\n\t"
        "subc.cc.u32 %11, %11, %23;\n\t"
        "subc.cc.u32 %12, %12, %24;\n\t"
        "subc.u32 %0, 0, 0;\n\t"
        "}"
        : "=r"(mask), "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
        : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]), "r"(b[8]), "r"(b[9]), "r"(b[10]), "r"(b[11]));
    asm volatile(
        "{\n\t"
        ".reg .u32 x;\n\t"
        "sub.cc.u32 x, 0, %25;\n\t"
        "subc.cc.u32 %1, %1, %13;\n\t"
        "subc.cc.u32 %2, %2, %14;\n\t"
        "subc.cc.u32 %3, %3, %15;\n\t"
        "subc.cc.u32 %4, %4, %16;\n\t"
        "subc.cc.u32 %5, %5, %17;\n\t"
        "subc.cc.u32 %6, %6, %18;\n\t"
        "subc.cc.u32 %7, %7, %19;\n\t"
        "subc.cc.u32 %8, %8, %20;\n\t"
        "subc.cc.u32 %9, %9, %21;\n\t"
        "subc.cc.u32 %10, %10, %22;\n\t"
        "subc.cc.u32 %11, %11, %23;\n\t"
        "subc.cc.u32 %12, %12, %24;\n\t"
        "subc.u32 %0, 0, 0;\n\t"
        "}"
        : "=r"(mask), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
        : "r"(b[12]), "r"(b[13]), "r"(b[14]), "r"(b[15]), "r"(b[16]), "r"(b[17]), "r"(b[18]), "r"(b[19]), "r"(b[20]), "r"(b[21]), "r"(b[22]), "r"(b[23]), "r"(mask));
    return mask;
  }
  // t[0..24] = t[0..23] + a * b
  static __device__ __forceinline__ void mac(uint32_t (&t)[25], const uint32_t (&a)[24],
                                             uint32_t b) {
    uint32_t c;
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %25, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, %25, %1;\n\t"
        "madc.lo.cc.u32 %2, %15, %25, %2;\n\t"
        "madc.lo.cc.u32 %3, %16, %25, %3;\n\t"
        "madc.lo.cc.u32 %4, %17, %25, %4;\n\t"
        "madc.lo.cc.u32 %5, %18, %25, %5;\n\t"
        "madc.lo.cc.u32 %6, %19, %25, %6;\n\t"
        "madc.lo.cc.u32 %7, %20, %25, %7;\n\t"
        "madc.lo.cc.u32 %8, %21, %25, %8;\n\t"
        "madc.lo.cc.u32 %9, %22, %25, %9;\n\t"
        "madc.lo.cc.u32 %10, %23, %25, %10;\n\t"
        "madc.lo.cc.u32 %11, %24, %25, %11;\n\t"
        "addc.u32 %12, 0, 0;\n\t"
        "}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "=r"(c)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(b));
    asm volatile(
        "{\n\t"
        ".reg .u32 x;\n\t"
        "add.cc.u32 x, %26, 0xffffffff;\n\t"
        "madc.lo.cc.u32 %0, %13, %25, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, %25, %1;\n\t"
        "madc.lo.cc.u32 %2, %15, %25, %2;\n\t"
        "madc.lo.cc.u32 %3, %16, %25, %3;\n\t"
        "madc.lo.cc.u32 %4, %17, %25, %4;\n\t"
        "madc.lo.cc.u32 %5, %18, %25, %5;\n\t"
        "madc.lo.cc.u32 %6, %19, %25, %6;\n\t"
        "madc.lo.cc.u32 %7, %20, %25, %7;\n\t"
        "madc.lo.cc.u32 %8, %21, %25, %8;\n\t"
        "madc.lo.cc.u32 %9, %22, %25, %9;\n\t"
        "madc.lo.cc.u32 %10, %23, %25, %10;\n\t"
        "madc.lo.cc.u32 %11, %24, %25, %11;\n\t"
        "addc.u32 %12, 0, 0;\n\t"
        "}"
        : "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15]), "+r"(t[16]), "+r"(t[17]), "+r"(t[18]), "+r"(t[19]), "+r"(t[20]), "+r"(t[21]), "+r"(t[22]), "+r"(t[23]), "+r"(t[24])
        : "r"(a[12]), "r"(a[13]), "r"(a[14]), "r"(a[15]), "r"(a[16]), "r"(a[17]), "r"(a[18]), "r"(a[19]), "r"(a[20]), "r"(a[21]), "r"(a[22]), "r"(a[23]), "r"(b), "r"(c));
    asm volatile(
        "{\n\t"
        "mad.hi.cc.u32 %0, %13, %25, %0;\n\t"
        "madc.hi.cc.u32 %1, %14, %25, %1;\n\t"
        "madc.hi.cc.u32 %2, %15, %25, %2;\n\t"
        "madc.hi.cc.u32 %3, %16, %25, %3;\n\t"
        "madc.hi.cc.u32 %4, %17, %25, %4;\n\t"
        "madc.hi.cc.u32 %5, %18, %25, %5;\n\t"
        "madc.hi.cc.u32 %6, %19, %25, %6;\n\t"
        "madc.hi.cc.u32 %7, %20, %25, %7;\n\t"
        "madc.hi.cc.u32 %8, %21, %25, %8;\n\t"
        "madc.hi.cc.u32 %9, %22, %25, %9;\n\t"
        "madc.hi.cc.u32 %10, %23, %25, %10;\n\t"
        "madc.hi.cc.u32 %11, %24, %25, %11;\n\t"
        "addc.u32 %12, 0, 0;\n\t"
        "}"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "=r"(c)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]), "r"(a[8]), "r"(a[9]), "r"(a[10]), "r"(a[11]), "r"(b));
    asm volatile(
        "{\n\t"
        ".reg .u32 x;\n\t"
        "add.cc.u32 x, %25, 0xffffffff;\n\t"
        "madc.hi.cc.u32 %0, %12, %24, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %24, %1;\n\t"
        "madc.hi.cc.u32 %2, %14, %24, %2;\n\t"
        "madc.hi.cc.u32 %3, %15, %24, %3;\n\t"
        "madc.hi.cc.u32 %4, %16, %24, %4;\n\t"
        "madc.hi.cc.u32 %5, %17, %24, %5;\n\t"
        "madc.hi.cc.u32 %6, %18, %24, %6;\n\t"
        "madc.hi.cc.u32 %7, %19, %24, %7;\n\t"
        "madc.hi.cc.u32 %8, %20, %24, %8;\n\t"
        "madc.hi.cc.u32 %9, %21, %24, %9;\n\t"
        "madc.hi.cc.u32 %10, %22, %24, %10;\n\t"
        "madc.hi.u32 %11, %23, %24, %11;\n\t"
        "}"
        : "+r"(t[13]), "+r"(t[14]), "+r"(t[15]), "+r"(t[16]), "+r"(t[17]), "+r"(t[18]), "+r"(t[19]), "+r"(t[20]), "+r"(t[21]), "+r"(t[22]), "+r"(t[23]), "+r"(t[24])
        : "r"(a[12]), "r"(a[13]), "r"(a[14]), "r"(a[15]), "r"(a[16]), "r"(a[17]), "r"(a[18]), "r"(a[19]), "r"(a[20]), "r"(a[21]), "r"(a[22]), "r"(a[23]), "r"(b), "r"(c));
  }
  // t[0..24] += (t[0] * np mod 2^32) * q: t[0] becomes 0
  static __device__ __forceinline__ void reduce(uint32_t (&t)[25], const uint32_t (&q)[24],
                                                uint32_t np) {
    uint32_t c, m;
    asm volatile(
        "{\n\t"
        "mul.lo.u32 %0, %1, %2;\n\t"
        "}"
        : "=r"(m)
        : "r"(t[0]), "r"(np));
    asm volatile(
        "{\n\t"
        "mad.lo.cc.u32 %0, %13, %25, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, %25, %1;\n\t"
        "madc.lo.cc.u32 %2, %15, %25, %2;\n\t"
        "madc.lo.cc.u32 %3, %16, %25, %3;\n\t"
        "madc.lo.cc.u32 %4, %17, %25, %4;\n\t"
        "madc.lo.cc.u32 %5, %18, %25, %5;\n\t"
        "madc.lo.cc.u32 %6, %19, %25, %6;\n\t"
        "madc.lo.cc.u32 %7, %20, %25, %7;\n\t"
        "madc.lo.cc.u32 %8, %21, %25, %8;\n\t"
        "madc.lo.cc.u32 %9, %22, %25, %9;\n\t"
        "madc.lo.cc.u32 %10, %23, %25, %10;\n\t"
        "madc.lo.cc.u32 %11, %24, %25, %11;\n\t"
        "addc.u32 %12, 0, 0;\n\t"
        "}"
        : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "=r"(c)
        : "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]), "r"(q[4]), "r"(q[5]), "r"(q[6]), "r"(q[7]), "r"(q[8]), "r"(q[9]), "r"(q[10]), "r"(q[11]), "r"(m));
    asm volatile(
        "{\n\t"
        ".reg .u32 x;\n\t"
        "add.cc.u32 x, %26, 0xffffffff;\n\t"
        "madc.lo.cc.u32 %0, %13, %25, %0;\n\t"
        "madc.lo.cc.u32 %1, %14, %25, %1;\n\t"
        "madc.lo.cc.u32 %2, %15, %25, %2;\n\t"
        "madc.lo.cc.u32 %3, %16, %25, %3;\n\t"
        "madc.lo.cc.u32 %4, %17, %25, %4;\n\t"
        "madc.lo.cc.u32 %5, %18, %25, %5;\n\t"
        "madc.lo.cc.u32 %6, %19, %25, %6;\n\t"
        "madc.lo.cc.u32 %7, %20, %25, %7;\n\t"
        "madc.lo.cc.u32 %8, %21, %25, %8;\n\t"
        "madc.lo.cc.u32 %9, %22, %25, %9;\n\t"
        "madc.lo.cc.u32 %10, %23, %25, %10;\n\t"
        "madc.lo.cc.u32 %11, %24, %25, %11;\n\t"
        "addc.u32 %12, %12, 0;\n\t"
        "}"
        : "+r"(t[12]), "+r"(t[13]), "+r"(t[14]), "+r"(t[15]), "+r"(t[16]), "+r"(t[17]), "+r"(t[18]), "+r"(t[19]), "+r"(t[20]), "+r"(t[21]), "+r"(t[22]), "+r"(t[23]), "+r"(t[24])
        : "r"(q[12]), "r"(q[13]), "r"(q[14]), "r"(q[15]), "r"(q[16]), "r"(q[17]), "r"(q[18]), "r"(q[19]), "r"(q[20]), "r"(q[21]), "r"(q[22]), "r"(q[23]), "r"(m), "r"(c));
    asm volatile(
        "{\n\t"
        "mad.hi.cc.u32 %0, %13, %25, %0;\n\t"
        "madc.hi.cc.u32 %1, %14, %25, %1;\n\t"
        "madc.hi.cc.u32 %2, %15, %25, %2;\n\t"
        "madc.hi.cc.u32 %3, %16, %25, %3;\n\t"
        "madc.hi.cc.u32 %4, %17, %25, %4;\n\t"
        "madc.hi.cc.u32 %5, %18, %25, %5;\n\t"
        "madc.hi.cc.u32 %6, %19, %25, %6;\n\t"
        "madc.hi.cc.u32 %7, %20, %25, %7;\n\t"
        "madc.hi.cc.u32 %8, %21, %25, %8;\n\t"
        "madc.hi.cc.u32 %9, %22, %25, %9;\n\t"
        "madc.hi.cc.u32 %10, %23, %25, %10;\n\t"
        "madc.hi.cc.u32 %11, %24, %25, %11;\n\t"
        "addc.u32 %12, 0, 0;\n\t"
        "}"
        : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]), "+r"(t[12]), "=r"(c)
        : "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]), "r"(q[4]), "r"(q[5]), "r"(q[6]), "r"(q[7]), "r"(q[8]), "r"(q[9]), "r"(q[10]), "r"(q[11]), "r"(m));
    asm volatile(
        "{\n\t"
        ".reg .u32 x;\n\t"
        "add.cc.u32 x, %25, 0xffffffff;\n\t"
        "madc.hi.cc.u32 %0, %12, %24, %0;\n\t"
        "madc.hi.cc.u32 %1, %13, %24, %1;\n\t"
        "madc.hi.cc.u32 %2, %14, %24, %2;\n\t"
        "madc.hi.cc.u32 %3, %15, %24, %3;\n\t"
        "madc.hi.cc.u32 %4, %16, %24, %4;\n\t"
        "madc.hi.cc.u32 %5, %17, %24, %5;\n\t"
        "madc.hi.cc.u32 %6, %18, %24, %6;\n\t"
        "madc.hi.cc.u32 %7, %19, %24, %7;\n\t"
        "madc.hi.cc.u32 %8, %20, %24, %8;\n\t"
        "madc.hi.cc.u32 %9, %21, %24, %9;\n\t"
        "madc.hi.cc.u32 %10, %22, %24, %10;\n\t"
        "madc.hi.u32 %11, %23, %24, %11;\n\t"
        "}"
        : "+r"(t[13]), "+r"(t[14]), "+r"(t[15]), "+r"(t[16]), "+r"(t[17]), "+r"(t[18]), "+r"(t[19]), "+r"(t[20]), "+r"(t[21]), "+r"(t[22]), "+r"(t[23]), "+r"(t[24])
        : "r"(q[12]), "r"(q[13]), "r"(q[14]), "r"(q[15]), "r"(q[16]), "r"(q[17]), "r"(q[18]), "r"(q[19]), "r"(q[20]), "r"(q[21]), "r"(q[22]), "r"(q[23]), "r"(m), "r"(c));
  }
};
