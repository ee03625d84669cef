// BN254 Fr arithmetic on 8 x 32-bit limbs (little-endian), Montgomery form
// with R = 2^256, shared by the port's kernels (K1 `mont_mul.cu`, K2
// `product_round.cu`).  Every value is normalized (< p).
//
// The word arithmetic runs on PTX carry chains: `mad.lo.cc.u32` /
// `madc.hi.cc.u32` for the products, `add.cc` / `addc.cc` and `sub.cc` /
// `subc.cc` for sums and differences.  Each chain is one asm statement, so
// nothing the compiler emits can sit between two instructions that pass a
// carry.  PTX registers are virtual (ptxas allocates them), so an output
// written early in a chain never overwrites an input read later in it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fr {

// p, R mod p and R^2 mod p (R = 2^256) as 8 little-endian words.  A
// function that needs one declares a local array from it; with every index
// a constant after unrolling, the words become immediates.
#define FR_P_WORDS                                          \
  {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,      \
   0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}
#define FR_R_WORDS                                          \
  {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,      \
   0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}
#define FR_R2_WORDS                                         \
  {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,      \
   0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u}
// -p^-1 mod 2^32
constexpr uint32_t kN0 = 0xefffffffu;

// t[0..8] += a * b[0..7]: the low halves of the eight products on one carry
// chain into t[0..7] (its carry out into t[8]), then the high halves on a
// second chain into t[1..8].  The caller keeps the total below 2^288.
__device__ __forceinline__ void mul_add_row(uint32_t t[9], uint32_t a,
                                            const uint32_t b[8]) {
  asm("mad.lo.cc.u32  %0, %9, %10, %0;\n\t"
      "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %1, %9, %10, %1;\n\t"
      "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
      "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
      "madc.hi.u32    %8, %9, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]),
        "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// s = a + b mod 2^256 over 8 words (the carry out is dropped).
__device__ __forceinline__ void add_words(const uint32_t a[8],
                                          const uint32_t b[8],
                                          uint32_t s[8]) {
  asm("add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
        "=r"(s[5]), "=r"(s[6]), "=r"(s[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
}

// d = a - b mod 2^256 over 8 words; returns 0xffffffff if a < b, else 0.
__device__ __forceinline__ uint32_t sub_words(const uint32_t a[8],
                                              const uint32_t b[8],
                                              uint32_t d[8]) {
  uint32_t borrow = 0;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %8, %8;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "+r"(borrow)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  return borrow;
}

// out = a * b * 2^-256 mod p, for a < 2^256 and b < p (out may alias a or
// b).  CIOS over 8 words: per word a[i], t += a[i] b, then t += m p with
// m = t[0] (-p^-1) mod 2^32 and a shift down by one word.  With t < 2p at
// the start of a step, t + a[i] b + m p < 2p + 2 (2^32 - 1) p < 2^33 p
// < 2^288 fits t[0..8], and the shifted t is again < 2p < 2^255 (so t[8]
// is 0 after every shift).  One conditional subtract of p ends it.
__device__ __forceinline__ void mont_mul8(const uint32_t a[8],
                                          const uint32_t b[8],
                                          uint32_t out[8]) {
  const uint32_t p[8] = FR_P_WORDS;
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mul_add_row(t, a[i], b);
    mul_add_row(t, t[0] * kN0, p);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
  uint32_t d[8];
  const uint32_t keep = sub_words(t, p, d);      // t < p: keep t
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = keep ? t[j] : d[j];
}

// out = (a + b) mod p for a, b < p (a + b < 2p < 2^256: no carry out).
__device__ __forceinline__ void add8(const uint32_t a[8], const uint32_t b[8],
                                     uint32_t out[8]) {
  const uint32_t p[8] = FR_P_WORDS;
  uint32_t s[8], d[8];
  add_words(a, b, s);
  const uint32_t keep = sub_words(s, p, d);      // s < p: keep s
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = keep ? s[j] : d[j];
}

// out = (a - b) mod p for a, b < p: a - b, plus p if that borrows.
__device__ __forceinline__ void sub8(const uint32_t a[8], const uint32_t b[8],
                                     uint32_t out[8]) {
  const uint32_t p[8] = FR_P_WORDS;
  uint32_t d[8], q[8];
  const uint32_t mask = sub_words(a, b, d);
#pragma unroll
  for (int j = 0; j < 8; ++j) q[j] = p[j] & mask;
  add_words(d, q, out);
}

}  // namespace fr
