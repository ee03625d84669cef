// By-part timing of K4, the round tail (jolt_tpu_torch/csrc/transcript.cu).
// Built by experiments/k4_parts.py into a library of its own:
//
//   nvcc ... -DK4_SOURCE='"<tree>/jolt_tpu_torch/csrc/transcript.cu"'
//            [-DK4_OLD] -o libk4_parts.so experiments/k4_parts.cu
//
// It includes the kernel's source, so `Tail`, `jolt_k4` and the source's
// device functions are in this file's scope.
//
//   * K4_OLD (the one-warp K4, which has no stamp hooks): `old_stamped`,
//     a copy of its kernel body with clock64 stamps between its parts;
//   * otherwise the kernel's own `K4_STAMP(slot)` hooks (empty on the main
//     path) write clock64 into `k4_stamps`, so `jolt_k4` of this library
//     is the stamped kernel itself.
//
// Beside them, one-warp micro-kernels: a chain of dependent 32-bit ALU
// operations, of Montgomery products (`fr::mont_mul8`), and of Blake2b-256
// transcript compressions: unrolled on one lane, on four lanes with the
// rounds a loop, and through K4's own `compress` (four lanes, unrolled) or
// for K4_OLD the one-warp K4's `step`, each returning its final
// value and its clock64 cycles; and an empty kernel that takes the launch
// record, for the launch's own cost.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kSlots = 64;
constexpr int kSink = kSlots - 1;
__device__ long long k4_stamps[kSlots];
}  // namespace

#ifndef K4_OLD
// slot < 32: the transcript warp's lane 0; slot >= 32: warp 0's lane 0
#define K4_STAMP(slot)                                                  \
  do {                                                                  \
    if ((threadIdx.x & 31) == 0) k4_stamps[slot] = clock64();           \
  } while (0)
#define K4_STAMP_AFTER(value, slot)                                     \
  do {                                                                  \
    if ((value) == 0x9E3779B9u) k4_stamps[kSink] = 1;                   \
    K4_STAMP(slot);                                                     \
  } while (0)
#endif

#include K4_SOURCE

namespace {

__device__ __forceinline__ void stamp(int slot) {
  if (threadIdx.x == 0) k4_stamps[slot] = clock64();
}

// A branch on `v` before the stamp: the stamp waits for v (a load's
// latency, a product's last instruction), not only for the instructions
// before it to be dispatched.
__device__ __forceinline__ void stamp_after(uint32_t v, int slot) {
  if (v == 0x9E3779B9u) k4_stamps[kSink] = 1;
  stamp(slot);
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---- Blake2b-256 of one final transcript block: two ways --------------

// Blake2b-256's chaining value (the IV, word 0 xor the parameter word
// 0x01010020) and the IV; a function declares local arrays from them
#define H_H_WORDS                                                         \
  {0x6A09E667F3BCC908ull ^ 0x01010020ull, 0xBB67AE8584CAA73Bull,          \
   0x3C6EF372FE94F82Bull, 0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull,   \
   0x9B05688C2B3E6C1Full, 0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull}
#define H_IV_WORDS                                                        \
  {0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,   \
   0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,   \
   0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull}

__device__ __forceinline__ uint64_t hpk(uint32_t lo, uint32_t hi) {
  uint64_t r;
  asm("mov.b64 %0, {%1, %2};" : "=l"(r) : "r"(lo), "r"(hi));
  return r;
}
__device__ __forceinline__ void hupk(uint64_t x, uint32_t& lo, uint32_t& hi) {
  asm("mov.b64 {%0, %1}, %2;" : "=r"(lo), "=r"(hi) : "l"(x));
}
// rotr(x ^ y, n) for Blake2b's four rotations, on 32-bit halves: a swap,
// two byte permutes, two byte permutes, two funnel shifts
__device__ __forceinline__ uint64_t hxr32(uint64_t x, uint64_t y) {
  uint32_t lo, hi;
  hupk(x ^ y, lo, hi);
  return hpk(hi, lo);
}
__device__ __forceinline__ uint64_t hxr24(uint64_t x, uint64_t y) {
  uint32_t lo, hi;
  hupk(x ^ y, lo, hi);
  return hpk(__byte_perm(lo, hi, 0x6543), __byte_perm(hi, lo, 0x6543));
}
__device__ __forceinline__ uint64_t hxr16(uint64_t x, uint64_t y) {
  uint32_t lo, hi;
  hupk(x ^ y, lo, hi);
  return hpk(__byte_perm(lo, hi, 0x5432), __byte_perm(hi, lo, 0x5432));
}
__device__ __forceinline__ uint64_t hxr63(uint64_t x, uint64_t y) {
  uint32_t lo, hi;
  hupk(x ^ y, lo, hi);
  return hpk(__funnelshift_l(hi, lo, 1), __funnelshift_l(lo, hi, 1));
}

#define H_G(a, b, c, d, x, y) \
  a = a + b + (x);            \
  d = hxr32(d, a);             \
  c = c + d;                  \
  b = hxr24(b, c);             \
  a = a + b + (y);            \
  d = hxr16(d, a);             \
  c = c + d;                  \
  b = hxr63(b, c);

#define H_ROUND1(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, \
                 s14, s15)                                                   \
  H_G(v0, v4, v8, v12, m[s0], m[s1])                                         \
  H_G(v1, v5, v9, v13, m[s2], m[s3])                                         \
  H_G(v2, v6, v10, v14, m[s4], m[s5])                                        \
  H_G(v3, v7, v11, v15, m[s6], m[s7])                                        \
  H_G(v0, v5, v10, v15, m[s8], m[s9])                                        \
  H_G(v1, v6, v11, v12, m[s10], m[s11])                                      \
  H_G(v2, v7, v8, v13, m[s12], m[s13])                                       \
  H_G(v3, v4, v9, v14, m[s14], m[s15])

#define H_SIGMA(R)                                                         \
  R(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)                  \
  R(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)                  \
  R(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)                  \
  R(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)                  \
  R(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)                  \
  R(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)                  \
  R(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)                  \
  R(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)                  \
  R(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)                  \
  R(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)                  \
  R(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)                  \
  R(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)

__device__ __forceinline__ uint32_t hbs32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// One lane: every index a constant, the message's zero words folded.
__device__ __forceinline__ void h_compress1(uint64_t st[4], uint32_t n,
                                            const uint64_t pl[4]) {
  const uint64_t hkH[8] = H_H_WORDS, hkIV[8] = H_IV_WORDS;
  const uint64_t m[16] = {st[0], st[1], st[2], st[3], 0, 0, 0,
                          (uint64_t)hbs32(n) << 32, pl[0], pl[1], pl[2],
                          pl[3], 0, 0, 0, 0};
  uint64_t v0 = hkH[0], v1 = hkH[1], v2 = hkH[2], v3 = hkH[3], v4 = hkH[4],
           v5 = hkH[5], v6 = hkH[6], v7 = hkH[7], v8 = hkIV[0], v9 = hkIV[1],
           v10 = hkIV[2], v11 = hkIV[3], v12 = hkIV[4] ^ 96, v13 = hkIV[5],
           v14 = ~hkIV[6], v15 = hkIV[7];
  H_SIGMA(H_ROUND1)
  st[0] = hkH[0] ^ v0 ^ v8;
  st[1] = hkH[1] ^ v1 ^ v9;
  st[2] = hkH[2] ^ v2 ^ v10;
  st[3] = hkH[3] ^ v3 ^ v11;
}

template <typename T>
__device__ __forceinline__ T hsel4(int q, T a, T b, T c, T d) {
  return q == 0 ? a : q == 1 ? b : q == 2 ? c : d;
}

// Four lanes with the 12 rounds as a loop (a design K4 tried: ~50
// instructions of code, the message words fetched by shuffle from the
// lanes that hold them, the schedule as 4-bit indices a round, a round
// ahead; rounds 10 and 11 repeat 0 and 1).
#define H_SCHED_X0 0xE0A6DC297BE0ull, 0x428E71653C42ull, 0x947BCE02D594ull, \
                   0xD610348ABFD6ull
#define H_SCHED_Y0 0xA12FB5C098A1ull, 0x8349EFA71083ull, 0xF5631DB4C2F5ull, \
                   0x67589A3FED67ull
#define H_SCHED_X1 0x18FC504E2A18ull, 0x0A9DF67B530Aull, 0xBC3189F647BCull, \
                   0x5EDA2813F95Eull
#define H_SCHED_Y1 0xC9B207D16EC9ull, 0x2BE7435CA62Bull, 0x7DC462E8017Dull, \
                   0x3F05AB9D843Full

__device__ __forceinline__ void h_compress4_rolled(uint64_t st[4], uint32_t n,
                                                   const uint64_t pl[4]) {
  const uint64_t hkH[8] = H_H_WORDS, hkIV[8] = H_IV_WORDS;
  const int lane = threadIdx.x & 31, q = lane & 3, k = lane & 15;
  const uint64_t mine = k < 4 ? (k == 0 ? st[0] : k == 1 ? st[1]
                                 : k == 2 ? st[2] : st[3])
                        : k == 7 ? (uint64_t)hbs32(n) << 32
                        : k < 8 || k > 11 ? 0
                        : k == 8 ? pl[0] : k == 9 ? pl[1]
                        : k == 10 ? pl[2] : pl[3];
  uint64_t sx0 = hsel4(q, H_SCHED_X0), sy0 = hsel4(q, H_SCHED_Y0);
  uint64_t sx1 = hsel4(q, H_SCHED_X1), sy1 = hsel4(q, H_SCHED_Y1);
  uint64_t a = hsel4(q, hkH[0], hkH[1], hkH[2], hkH[3]);
  uint64_t b = hsel4(q, hkH[4], hkH[5], hkH[6], hkH[7]);
  uint64_t c = hsel4(q, hkIV[0], hkIV[1], hkIV[2], hkIV[3]);
  uint64_t d = hsel4(q, hkIV[4] ^ 96, hkIV[5], ~hkIV[6], hkIV[7]);
  uint64_t x0 = __shfl_sync(0xffffffffu, mine, (int)(sx0 & 15));
  uint64_t y0 = __shfl_sync(0xffffffffu, mine, (int)(sy0 & 15));
  uint64_t x1 = __shfl_sync(0xffffffffu, mine, (int)(sx1 & 15));
  uint64_t y1 = __shfl_sync(0xffffffffu, mine, (int)(sy1 & 15));
#pragma unroll 1
  for (int r = 0; r < 12; ++r) {
    sx0 >>= 4;
    sy0 >>= 4;
    sx1 >>= 4;
    sy1 >>= 4;
    H_G(a, b, c, d, x0, y0)
    x0 = __shfl_sync(0xffffffffu, mine, (int)(sx0 & 15));
    y0 = __shfl_sync(0xffffffffu, mine, (int)(sy0 & 15));
    b = __shfl_sync(0xffffffffu, b, q + 1, 4);
    c = __shfl_sync(0xffffffffu, c, q + 2, 4);
    d = __shfl_sync(0xffffffffu, d, q + 3, 4);
    H_G(a, b, c, d, x1, y1)
    x1 = __shfl_sync(0xffffffffu, mine, (int)(sx1 & 15));
    y1 = __shfl_sync(0xffffffffu, mine, (int)(sy1 & 15));
    b = __shfl_sync(0xffffffffu, b, q + 3, 4);
    c = __shfl_sync(0xffffffffu, c, q + 2, 4);
    d = __shfl_sync(0xffffffffu, d, q + 1, 4);
  }
  const uint64_t w = hsel4(q, hkH[0], hkH[1], hkH[2], hkH[3]) ^ a ^ c;
#pragma unroll
  for (int j = 0; j < 4; ++j) st[j] = __shfl_sync(0xffffffffu, w, j, 4);
}

// ---- micro-kernels: one warp, lane 0 reports --------------------------

// out: [0..3] the final 64-bit words, [4] clock64 cycles of the chain
template <int kVariant>
__global__ void __launch_bounds__(32) mb_compress(int n, const uint64_t* in,
                                                  uint64_t* out) {
  uint64_t st[4], pl[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    st[j] = in[j];
    pl[j] = in[4 + j];
  }
  uint32_t cnt = (uint32_t)in[8];
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    if (kVariant == 1) {
      h_compress1(st, cnt, pl);
      cnt += 1;
    } else if (kVariant == 3) {
      h_compress4_rolled(st, cnt, pl);
      cnt += 1;
    } else if (kVariant == 2) {
#ifndef K4_OLD
      compress(st, cnt, pl, 96);  // K4's own: four lanes, rounds a loop
      cnt += 1;
#endif
    } else {
#ifdef K4_OLD
      step(st, cnt, pl);          // the one-warp K4's (increments cnt)
#endif
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = st[j];
    out[4] = (uint64_t)(t1 - t0);
  }
}

// out: [0..7] the product's words, [8] cycles (as 32-bit halves)
__global__ void __launch_bounds__(32) mb_mont(int n, const uint32_t* in,
                                              uint32_t* out) {
  uint32_t a[8], b[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    a[l] = in[l];
    b[l] = in[8 + l];
  }
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) fr::mont_mul8(a, b, a);
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < 8; ++l) out[l] = a[l];
    const long long c = t1 - t0;
    out[8] = (uint32_t)c;
    out[9] = (uint32_t)(c >> 32);
  }
}

// a chain of 2n dependent ALU instructions (funnel shift, then add)
__global__ void __launch_bounds__(32) mb_alu(int n, const uint32_t* in,
                                             uint32_t* out) {
  uint32_t x = in[0];
  const uint32_t y = in[1];
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) x = __funnelshift_l(x, x, 7) + y;
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = x;
    const long long c = t1 - t0;
    out[8] = (uint32_t)c;
    out[9] = (uint32_t)(c >> 32);
  }
}

__global__ void __launch_bounds__(32)
mb_empty(const __grid_constant__ Tail t) {}

// globaltimer (ns) and clock64 at the start and end of a spin of n
// dependent ALU steps: the SM clock's rate
__global__ void __launch_bounds__(32) mb_clock(int n, long long* out) {
  uint32_t x = threadIdx.x;
  const long long g0 = globaltimer(), c0 = clock64();
  for (int i = 0; i < n; ++i) x = __funnelshift_l(x, x, 7) + 0x9E3779B9u;
  const long long c1 = clock64(), g1 = globaltimer();
  if (threadIdx.x == 0) {
    out[0] = g1 - g0;
    out[1] = c1 - c0;
    out[2] = x;
  }
}

#ifdef K4_OLD
// The one-warp K4's body with stamps by lane 0 (instance 0's lane and the
// transcript's): 0 entry; 1 instance 0's claim and evals loaded; 2 its
// coefficients recovered; 3 scaled; 4 the batched sum (after __syncwarp);
// 5 the label absorbed; 6 + 2k coefficient k's canonical form, 7 + 2k its
// absorb; 12 the squeeze; 13 the challenge in Montgomery form and the
// buffers written; 14 the claims at the challenge (Horner); 1-3 are of lane
// 0's first instance, 15 the end of its instances (a second from 33 on).
__global__ void __launch_bounds__(32)
old_stamped(const __grid_constant__ Tail t) {
  __shared__ uint32_t coef[kMaxInst][4][8];
  __shared__ uint32_t scaled[kMaxInst][4][8];
  __shared__ int ncoef[kMaxInst];
  __shared__ uint32_t rch[8];
  const int lane = threadIdx.x;
  uint32_t* claims = (uint32_t*)t.claims;
  const uint32_t* weights = (const uint32_t*)t.coeffs;
  if (lane == 0) k4_stamps[kSlots - 2] = globaltimer();
  stamp(0);
  for (int i = lane; i < t.n_inst; i += 32) {
    uint32_t claim[8], c[4][8];
    copy8(claims + 8 * i, claim);
    int n = 1;
    if (t.evals[i] == 0) {
      if (i == lane) stamp_after(claim[0] | claim[7], 1);
      fr::mont_mul8(claim, t.inv2, c[0]);
    } else {
      const uint32_t* e = (const uint32_t*)t.evals[i];
      if (i == lane)
        stamp_after(claim[0] | claim[7] | e[0] | e[7 * t.degree[i]], 1);
      n = recover(e, t.degree[i], claim, t, c);
    }
    if (i == lane) stamp_after(c[0][0] | c[n - 1][7], 2);
    for (int k = 0; k < n; ++k) {
      copy8(c[k], coef[i][k]);
      fr::mont_mul8(c[k], weights + 8 * i, scaled[i][k]);
    }
    ncoef[i] = n;
    if (i == lane) stamp_after(scaled[i][n - 1][7], 3);
    if (lane == 0) stamp_after(scaled[i][n - 1][7], 15);
  }
  __syncwarp();
  if (lane == 0) {
    uint32_t b[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int l = 0; l < 8; ++l) b[k][l] = 0;
    for (int i = 0; i < t.n_inst; ++i)
      for (int k = 0; k < ncoef[i]; ++k) fr::add8(b[k], scaled[i][k], b[k]);
    stamp_after(b[0][7] | b[3][7], 4);
    const uint32_t* sw = (const uint32_t*)t.state;
    uint64_t st[4], payload[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st[j] = sw[2 * j] | ((uint64_t)sw[2 * j + 1] << 32);
    uint32_t n = sw[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      payload[j] = t.label[2 * j] | ((uint64_t)t.label[2 * j + 1] << 32);
    step(st, n, payload);
    stamp_after((uint32_t)st[3], 5);
    uint32_t* comp = (uint32_t*)t.comp + (uint64_t)t.round * t.width * 8;
    const uint32_t one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
    for (int k = 0; k < t.n_c; ++k) {
      const uint32_t* bk = b[k == 0 ? 0 : k + 1];
      uint32_t canon[8];
      copy8(bk, comp + 8 * k);
      fr::mont_mul8(bk, one, canon);
      stamp_after(canon[7], 6 + 2 * k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        payload[j] = bswap32(canon[7 - 2 * j])
                     | ((uint64_t)bswap32(canon[6 - 2 * j]) << 32);
      step(st, n, payload);
      stamp_after((uint32_t)st[3], 7 + 2 * k);
    }
    step(st, n, nullptr);
    stamp_after((uint32_t)st[3], 12);
    uint32_t raw[8] = {(uint32_t)st[0], (uint32_t)(st[0] >> 32),
                       (uint32_t)st[1],
                       (uint32_t)(st[1] >> 32) & 0x1FFFFFFFu, 0, 0, 0, 0};
    const uint32_t r2[8] = FR_R2_WORDS;
    fr::mont_mul8(raw, r2, rch);
    copy8(rch, (uint32_t*)t.r + 8 * (uint64_t)t.round);
    uint32_t* so = (uint32_t*)t.state;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      so[2 * j] = (uint32_t)st[j];
      so[2 * j + 1] = (uint32_t)(st[j] >> 32);
    }
    so[8] = n;
    stamp_after(rch[7], 13);
  }
  __syncwarp();
  for (int i = lane; i < t.n_inst; i += 32) {
    uint32_t acc[8], r[8];
    copy8(rch, r);
    const int n = ncoef[i];
    copy8(coef[i][n - 1], acc);
    for (int k = n - 2; k >= 0; --k) {
      fr::mont_mul8(acc, r, acc);
      fr::add8(acc, coef[i][k], acc);
    }
    copy8(acc, claims + 8 * i);
    stamp_after(acc[7], 14);
  }
  if (lane == 0) k4_stamps[kSlots - 3] = globaltimer();
}
#endif

}  // namespace

extern "C" int k4p_empty(const void* tail, void* stream) {
  mb_empty<<<1, 32, 0, (cudaStream_t)stream>>>(*(const Tail*)tail);
  return (int)cudaGetLastError();
}

#ifdef K4_OLD
extern "C" int k4p_old_stamped(const void* tail, void* stream) {
  old_stamped<<<1, 32, 0, (cudaStream_t)stream>>>(*(const Tail*)tail);
  return (int)cudaGetLastError();
}
#endif

// which: 0 the one-warp K4's `step` (K4_OLD only), 1 one lane
// (unrolled), 3 four lanes with the rounds a loop, 2 K4's `compress` (four
// lanes, unrolled; not K4_OLD), 10 Montgomery
// products, 11 ALU steps, 12 the clock spin
extern "C" int k4p_micro(int which, int n, const void* in, void* out,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (which) {
    case 0:
#ifdef K4_OLD
      mb_compress<0><<<1, 32, 0, s>>>(n, (const uint64_t*)in, (uint64_t*)out);
      break;
#else
      return -1;
#endif
    case 1:
      mb_compress<1><<<1, 32, 0, s>>>(n, (const uint64_t*)in, (uint64_t*)out);
      break;
    case 3:
      mb_compress<3><<<1, 32, 0, s>>>(n, (const uint64_t*)in, (uint64_t*)out);
      break;
    case 2:
#ifndef K4_OLD
      mb_compress<2><<<1, 32, 0, s>>>(n, (const uint64_t*)in, (uint64_t*)out);
      break;
#else
      return -1;
#endif
    case 10:
      mb_mont<<<1, 32, 0, s>>>(n, (const uint32_t*)in, (uint32_t*)out);
      break;
    case 11:
      mb_alu<<<1, 32, 0, s>>>(n, (const uint32_t*)in, (uint32_t*)out);
      break;
    case 12:
      mb_clock<<<1, 32, 0, s>>>(n, (long long*)out);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

// copies the stamps to the host (synchronizes) and clears them
extern "C" int k4p_stamps(long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, k4_stamps, sizeof(k4_stamps));
  if (e != cudaSuccess) return (int)e;
  const long long zero[kSlots] = {0};
  return (int)cudaMemcpyToSymbol(k4_stamps, zero, sizeof(zero));
}
