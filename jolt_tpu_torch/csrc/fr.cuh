// BN254 Fr arithmetic on 8 x 32-bit limbs (little-endian), Montgomery form
// with R = 2^256, shared by the port's kernels (K1 `mont_mul.cu`, K2
// `product_round.cu`).  Every value is normalized (< p).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fr {

__constant__ uint32_t kP[8] = {
    0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// -p^-1 mod 2^32
constexpr uint32_t kN0 = 0xefffffffu;

// out = a * b * 2^-256 mod p, for a < 2^256 and b < p.  CIOS over 8 words
// with 64-bit products, then one conditional subtract of p (the value
// before it is < 2p).
__device__ __forceinline__ void mont_mul8(const uint32_t a[8],
                                          const uint32_t b[8],
                                          uint32_t out[8]) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // t += a[i] * b
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a[i] * b[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    // t = (t + m p) / 2^32 with m = t[0] * (-p^-1) mod 2^32
    uint32_t m = t[0] * kN0;
    s = (uint64_t)t[0] + (uint64_t)m * kP[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)t[j] + (uint64_t)m * kP[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  // t < 2p: subtract p unless that borrows
  uint32_t d[8];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)t[j] - kP[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  bool keep = borrow && t[8] == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = keep ? t[j] : d[j];
}

// out = (a + b) mod p for a, b < p (a + b < 2p < 2^256: no carry out).
__device__ __forceinline__ void add8(const uint32_t a[8], const uint32_t b[8],
                                     uint32_t out[8]) {
  uint32_t s[8], d[8];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)a[j] + b[j] + c;
    s[j] = (uint32_t)v;
    c = v >> 32;
  }
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)s[j] - kP[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = borrow ? s[j] : d[j];
}

// out = (a - b) mod p for a, b < p: a - b, plus p if that borrows.
__device__ __forceinline__ void sub8(const uint32_t a[8], const uint32_t b[8],
                                     uint32_t out[8]) {
  uint32_t d[8];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 63);
  }
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)d[j] + (borrow ? kP[j] : 0u) + c;
    out[j] = (uint32_t)v;
    c = v >> 32;
  }
}

}  // namespace fr
