// BN254 Fq (the base field: G1 coordinates) on 8 x 32-bit limbs
// (little-endian), Montgomery form with R = 2^256, for K3 (`g1.cu`).  Every
// value is normalized (< q).
//
// The same CIOS product, sum and difference as `fr.cuh`'s, built from its
// modulus-free carry-chain helpers (`fr::mul_add_row`, `fr::add_words`,
// `fr::sub_words`) with Fq's words.  `fr::mont_mul8`'s bound holds for q
// too: q < 2^254, so t < 2q < 2^255 after every shift and t[8] stays 0.

#pragma once

#include "fr.cuh"

namespace fq {

// q, R mod q and R^2 mod q (R = 2^256) as 8 little-endian words.
#define FQ_Q_WORDS                                          \
  {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,      \
   0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}
#define FQ_R_WORDS                                          \
  {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,      \
   0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}
#define FQ_R2_WORDS                                         \
  {0x538afa89u, 0xf32cfc5bu, 0xd44501fbu, 0xb5e71911u,      \
   0x0a417ff6u, 0x47ab1effu, 0xcab8351fu, 0x06d89f71u}
// -q^-1 mod 2^32
constexpr uint32_t kN0 = 0xe4866389u;

// out = a * b * 2^-256 mod q, for a < 2^256 and b < q (out may alias a or
// b): `fr::mont_mul8` with q in place of p.
__device__ __forceinline__ void mont_mul8(const uint32_t a[8],
                                          const uint32_t b[8],
                                          uint32_t out[8]) {
  const uint32_t q[8] = FQ_Q_WORDS;
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    fr::mul_add_row(t, a[i], b);
    fr::mul_add_row(t, t[0] * kN0, q);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
  uint32_t d[8];
  const uint32_t keep = fr::sub_words(t, q, d);  // t < q: keep t
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = keep ? t[j] : d[j];
}

// out = (a + b) mod q for a, b < q (a + b < 2q < 2^256: no carry out).
__device__ __forceinline__ void add8(const uint32_t a[8], const uint32_t b[8],
                                     uint32_t out[8]) {
  const uint32_t q[8] = FQ_Q_WORDS;
  uint32_t s[8], d[8];
  fr::add_words(a, b, s);
  const uint32_t keep = fr::sub_words(s, q, d);  // s < q: keep s
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = keep ? s[j] : d[j];
}

// out = (a - b) mod q for a, b < q: a - b, plus q if that borrows.
__device__ __forceinline__ void sub8(const uint32_t a[8], const uint32_t b[8],
                                     uint32_t out[8]) {
  const uint32_t q[8] = FQ_Q_WORDS;
  uint32_t d[8], m[8];
  const uint32_t mask = fr::sub_words(a, b, d);
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = q[j] & mask;
  fr::add_words(d, m, out);
}

__device__ __forceinline__ bool is_zero8(const uint32_t a[8]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a[j];
  return acc == 0;
}

}  // namespace fq
