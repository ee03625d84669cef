// K4: one batched sumcheck round's tail on the card -- from the instances'
// message evals to the round's Fiat-Shamir challenge -- so that a stage's
// round loop never copies a message back to the host.
//
// K4 replaces no Pallas kernel.  Its JAX counterpart is jnp code: the
// Blake2b transcript of the JAX package's `transcript/device.py` (`compress`,
// `absorb32`, `squeeze`, `canonical_words_be`, `challenge125_to_mont`) and
// the round tail of its scan tier (`sumcheck/scan.py`, the loop body after
// the instances' messages, with `_coeffs_from_evals` and `_horner` of
// `sumcheck/fused.py`).  The port's plain version is
// `transcript/device.py:round_tail_plain`; K4 equals it bit for bit.
//
// A round: each instance's polynomial from its evals at X in {0, 2, .., d}
// and its claim s(0) + s(1) (degree 1-3, `UniPoly.from_evals_and_hint`), or
// the constant claim/2 when it is inactive this round; their random linear
// combination with the batching coefficients, compressed (the linear
// coefficient dropped: n_c coefficients); the transcript -- absorb
// label_with_len("sumcheck_poly", n_c), absorb each compressed coefficient
// as 32 big-endian bytes of its canonical value, squeeze -- and the
// challenge (the squeeze's first 16 bytes read little-endian, the top 3
// bits of the 128 cleared: `challenge_scalar_optimized`) in Montgomery
// form; each instance's claim at the challenge.  Every absorb or squeeze is
// one Blake2b-256 compression of one final block: state (32 B) || 28 zero
// bytes || n_rounds (big-endian u32) || payload (32 B, or none).
//
// What bounds it: latency.  A round reads a few hundred bytes and does
// 2 + n_c dependent compressions and a few dozen Montgomery products:
// ~10^-6 ms at the card's byte and operation rates, against microseconds
// of dependent steps -- and of instruction fetch: a launch runs its code
// once, from cold caches (experiments/k4_parts.py: fully unrolled
// products ran ~3x slower in the kernel than warm in a loop).  The design
// shortens the chain and keeps the code small:
//
//   * one block of 7 warps.  Warp 3, the transcript warp (alone on its
//     SM sub-partition), loads the state and absorbs the label at once
//     (that needs no coefficient), while the six field warps scale the
//     instances' polynomials: field warp 2j + h takes term j of instance
//     i = 32h + lane.  With s and x sums of an instance's evals, the
//     batched compressed polynomial is b0 = sum A, b2 = sum B - 3 sum C,
//     b3 = sum C for A = c0 w, B = s w/2, C = x w/6 (w the batching
//     coefficient, w/2 and w/6 made once a stage by the wrapper): one
//     product a lane, by w's plain forms, gives each term's canonical
//     value (x R * w * R^-1 = x w), which the transcript absorbs -- no
//     canonical conversion on the chain.  A warp sums its lanes by
//     shuffles, skipping the levels past the last instance;
//   * the transcript warp adds the halves and runs the n_c absorbs and
//     the squeeze through one copy of `compress`, on four lanes: lane q of
//     a quad holds column q of the 4 x 4 state and runs its G function;
//     the diagonal step rotates rows b, c, d across the quad by shuffles
//     and back.  On one lane the four G functions of a half-round take
//     ~2x the cycles of the four lanes (experiments/k4_parts.py);
//   * meanwhile the field warps write the coefficients' Montgomery forms
//     (b R^2 R^-1) and recover each instance's coefficient c_{j+1} (two
//     products at every degree, so no lane waits on another's branch);
//     after the squeeze four lanes of the transcript warp take r, r^2 and
//     r^3 (exact below 2^375: its low 8 words and its high 4) to
//     Montgomery form at once, and each field lane adds c_{j+1} r^{j+1} to
//     its instance's claim: two products deep from the squeeze;
//   * a Montgomery product's loop over its words is not unrolled (its
//     code is fetched once a launch); no array is indexed at run time, so
//     nothing lives in local memory.
//
// Fields are the port's Montgomery limbs (8 x 32 bits, R = 2^256,
// `fr.cuh`).  `K4_STAMP` / `K4_STAMP_AFTER` are empty here;
// experiments/k4_parts.cu defines them to take clock64 stamps.

#include "fr.cuh"

#ifndef K4_STAMP
#define K4_STAMP(slot)
#define K4_STAMP_AFTER(value, slot)
#endif

namespace {

constexpr int kMaxInst = 64;
constexpr int kWords = 3;                  // `weights` words8 an instance
// 7 warps: warp 3 the transcript warp (alone on its SM sub-partition, as
// warp w runs on sub-partition w % 4), the others the field warps
constexpr int kThreads = 7 * 32;
constexpr int kTranscriptWarp = 3;

// The launch record (`kernels.RoundTail` in field/kernels.py).  The
// wrapper fills it once a stage and writes per round only `evals`, `n_c`
// and `round`.
struct Tail {
  unsigned long long evals[kMaxInst];  // per round: instance i's evals
                                       // (8, d_i), 0 if inactive
  int32_t degree[kMaxInst];            // d_i in 1..3
  int32_t n_inst;
  int32_t n_c;                         // per round: compressed length
  int32_t width;                       // comp's coefficients a round
  int32_t round;                       // per round
  unsigned long long state;            // uint32[9]: state words, n_rounds
  unsigned long long claims;           // uint32[n_inst][8], Montgomery
  unsigned long long weights;          // uint32[n_inst][3][8]: w, w/2 and
                                       // w/6 as plain values
  unsigned long long comp;             // uint32[rounds][width][8]
  unsigned long long r;                // uint32[rounds][8]
  uint32_t label[3][8];                // label_with_len payload, n_c = 1..3
  uint32_t inv2[8];                    // 1/2, Montgomery
  uint32_t inv6[8];                    // 1/6, Montgomery
};

// ---- Blake2b-256 of one final block, on the four lanes of a quad --------

// Blake2b-256's chaining value (the IV, word 0 xor the parameter block's
// first word 0x01010020: digest 32, no key, fanout 1, depth 1) and the IV
#define B2_H_WORDS                                                        \
  {0x6A09E667F3BCC908ull ^ 0x01010020ull, 0xBB67AE8584CAA73Bull,          \
   0x3C6EF372FE94F82Bull, 0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull,   \
   0x9B05688C2B3E6C1Full, 0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull}
#define B2_IV_WORDS                                                       \
  {0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull,   \
   0xA54FF53A5F1D36F1ull, 0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,   \
   0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull}

__device__ __forceinline__ uint64_t pack64(uint32_t lo, uint32_t hi) {
  uint64_t r;
  asm("mov.b64 %0, {%1, %2};" : "=l"(r) : "r"(lo), "r"(hi));
  return r;
}

__device__ __forceinline__ void split64(uint64_t x, uint32_t& lo,
                                        uint32_t& hi) {
  asm("mov.b64 {%0, %1}, %2;" : "=r"(lo), "=r"(hi) : "l"(x));
}

// rotr(x ^ y, n) for Blake2b's rotations by 32, 24, 16 and 63
__device__ __forceinline__ uint64_t xor_rotr32(uint64_t x, uint64_t y) {
  uint32_t lo, hi;
  split64(x ^ y, lo, hi);
  return pack64(hi, lo);
}

__device__ __forceinline__ uint64_t xor_rotr24(uint64_t x, uint64_t y) {
  uint32_t lo, hi;
  split64(x ^ y, lo, hi);
  return pack64(__byte_perm(lo, hi, 0x6543), __byte_perm(hi, lo, 0x6543));
}

__device__ __forceinline__ uint64_t xor_rotr16(uint64_t x, uint64_t y) {
  uint32_t lo, hi;
  split64(x ^ y, lo, hi);
  return pack64(__byte_perm(lo, hi, 0x5432), __byte_perm(hi, lo, 0x5432));
}

__device__ __forceinline__ uint64_t xor_rotr63(uint64_t x, uint64_t y) {
  uint32_t lo, hi;
  split64(x ^ y, lo, hi);
  return pack64(__funnelshift_l(hi, lo, 1), __funnelshift_l(lo, hi, 1));
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// the value of lane q (0..3) of a quad: a, b, c or d
__device__ __forceinline__ uint64_t quad_pick(int q, uint64_t a, uint64_t b,
                                              uint64_t c, uint64_t d) {
  return q == 0 ? a : q == 1 ? b : q == 2 ? c : d;
}

#define B2_G(a, b, c, d, x, y) \
  a = a + b + (x);             \
  d = xor_rotr32(d, a);        \
  c = c + d;                   \
  b = xor_rotr24(b, c);        \
  a = a + b + (y);             \
  d = xor_rotr16(d, a);        \
  c = c + d;                   \
  b = xor_rotr63(b, c);

#define B2_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, \
                 s14, s15)                                                   \
  {                                                                          \
    const uint64_t x0 = quad_pick(q, m[s0], m[s2], m[s4], m[s6]);            \
    const uint64_t y0 = quad_pick(q, m[s1], m[s3], m[s5], m[s7]);            \
    const uint64_t x1 = quad_pick(q, m[s8], m[s10], m[s12], m[s14]);         \
    const uint64_t y1 = quad_pick(q, m[s9], m[s11], m[s13], m[s15]);         \
    B2_G(a, b, c, d, x0, y0)                                                 \
    b = __shfl_sync(0xffffffffu, b, q + 1, 4);                               \
    c = __shfl_sync(0xffffffffu, c, q + 2, 4);                               \
    d = __shfl_sync(0xffffffffu, d, q + 3, 4);                               \
    B2_G(a, b, c, d, x1, y1)                                                 \
    b = __shfl_sync(0xffffffffu, b, q + 3, 4);                               \
    c = __shfl_sync(0xffffffffu, c, q + 2, 4);                               \
    d = __shfl_sync(0xffffffffu, d, q + 1, 4);                               \
  }

// One transcript step on the whole warp (each quad alike): st = Blake2b-256
// (st || 28 zero bytes || n BE || payload), of `len` bytes: 96 with the
// 32-byte payload pl, 64 (a squeeze) without.  Lane q of a quad holds
// column q (v[q], v[4 + q], v[8 + q], v[12 + q]) and runs its G function;
// for the diagonal G functions (0, 5, 10, 15), (1, 6, 11, 12), .. lane q
// takes b from lane q + 1, c from q + 2 and d from q + 3, and gives them
// back after.  The rounds are unrolled (every message index a constant);
// the kernel has one copy of this code for all its 2 + n_c steps, so only
// the first waits for the instruction fetch.  Returns with every lane
// holding the new state.
__device__ __forceinline__ void compress(uint64_t st[4], uint32_t n,
                                         const uint64_t pl[4], uint32_t len) {
  const uint64_t H[8] = B2_H_WORDS, IV[8] = B2_IV_WORDS;
  const int q = threadIdx.x & 3;
  const bool with = len == 96;
  const uint64_t m[16] = {st[0], st[1], st[2], st[3], 0, 0, 0,
                          (uint64_t)bswap32(n) << 32, with ? pl[0] : 0,
                          with ? pl[1] : 0, with ? pl[2] : 0,
                          with ? pl[3] : 0, 0, 0, 0, 0};
  uint64_t a = quad_pick(q, H[0], H[1], H[2], H[3]);
  uint64_t b = quad_pick(q, H[4], H[5], H[6], H[7]);
  uint64_t c = quad_pick(q, IV[0], IV[1], IV[2], IV[3]);
  // v[12] ^= the message's byte length; v[14] = ~v[14]: the final block
  uint64_t d = quad_pick(q, IV[4] ^ len, IV[5], ~IV[6], IV[7]);
  B2_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  B2_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  B2_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  B2_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  B2_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  B2_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  B2_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  B2_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  B2_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  B2_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  B2_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  B2_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  // the new state's word q: h[q] ^ v[q] ^ v[8 + q]
  const uint64_t w = quad_pick(q, H[0], H[1], H[2], H[3]) ^ a ^ c;
#pragma unroll
  for (int j = 0; j < 4; ++j) st[j] = __shfl_sync(0xffffffffu, w, j, 4);
}

// ---- field helpers ------------------------------------------------------

__device__ __forceinline__ void load8(const uint32_t* p, uint32_t x[8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l) x[l] = p[l];
}

__device__ __forceinline__ void store8(const uint32_t x[8], uint32_t* p) {
#pragma unroll
  for (int l = 0; l < 8; ++l) p[l] = x[l];
}

__device__ __forceinline__ void zero8(uint32_t x[8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l) x[l] = 0;
}

__device__ __forceinline__ void copy8(const uint32_t x[8], uint32_t out[8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l) out[l] = x[l];
}

// out = c ? a : b
__device__ __forceinline__ void pick8(bool c, const uint32_t a[8],
                                      const uint32_t b[8], uint32_t out[8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l) out[l] = c ? a[l] : b[l];
}

// out = 3 x mod p
__device__ __forceinline__ void triple8(const uint32_t x[8], uint32_t out[8]) {
  uint32_t t[8];
  fr::add8(x, x, t);
  fr::add8(x, t, out);
}

// out = a b R^-1 mod p for a < 2^256, b < p (out may alias a or b):
// `fr::mont_mul8`'s CIOS rows, with a's words shifting down through
// registers so that the loop over them is not unrolled -- ~50
// instructions of code for 8 passes, fetched once a launch, where the
// unrolled product is ~300.
__device__ __forceinline__ void mont_mul(const uint32_t a[8],
                                         const uint32_t b[8],
                                         uint32_t out[8]) {
  const uint32_t p[8] = FR_P_WORDS;
  uint32_t t[9], x[8], y[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    x[l] = a[l];
    y[l] = b[l];
    t[l] = 0;
  }
  t[8] = 0;
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    fr::mul_add_row(t, x[0], y);
    fr::mul_add_row(t, t[0] * fr::kN0, p);
#pragma unroll
    for (int l = 0; l < 8; ++l) t[l] = t[l + 1];
    t[8] = 0;
#pragma unroll
    for (int l = 0; l < 7; ++l) x[l] = x[l + 1];
    x[7] = 0;
  }
  uint32_t d[8];
  const uint32_t keep = fr::sub_words(t, p, d);      // t < p: keep t
#pragma unroll
  for (int l = 0; l < 8; ++l) out[l] = keep ? t[l] : d[l];
}

// out[0 .. kA + kB) = a * b, exactly (schoolbook)
template <int kA, int kB>
__device__ __forceinline__ void mul_exact(const uint32_t a[kA],
                                          const uint32_t b[kB],
                                          uint32_t out[kA + kB]) {
#pragma unroll
  for (int l = 0; l < kA + kB; ++l) out[l] = 0;
#pragma unroll
  for (int i = 0; i < kA; ++i) {
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const uint64_t v = (uint64_t)a[i] * b[j] + out[i + j] + carry;
      out[i + j] = (uint32_t)v;
      carry = (uint32_t)(v >> 32);
    }
    out[i + kB] = carry;
  }
}

// Arrive at (and wait on) named barrier `id` with `count` threads; the
// transcript warp and the field warps arrive from different code.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" : : "r"(id), "r"(count) : "memory");
}

// ---- the kernel -----------------------------------------------------------

// __grid_constant__: the record stays in the parameter bank though its
// arrays are read by address.
__global__ void __launch_bounds__(kThreads)
k4_round_tail(const __grid_constant__ Tail t) {
  __shared__ uint32_t part[3][2][8];     // (term, half): canonical sums
  __shared__ uint32_t rpow[3][8];        // r, r^2, r^3, Montgomery
  __shared__ uint32_t term[2][kMaxInst][8];   // c2 r^2, c3 r^3
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kTranscriptWarp) {
    // ---- the transcript warp: 2 + n_c steps through one copy of
    // `compress`, the label's before barrier 1 (beside the field work),
    // the coefficients' and the squeeze after
    K4_STAMP(0);
    const uint32_t* sw = (const uint32_t*)t.state;
    uint64_t st[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) st[k] = pack64(sw[2 * k], sw[2 * k + 1]);
    uint32_t n = sw[8];
    K4_STAMP_AFTER((uint32_t)st[3] ^ n, 1);
    uint64_t pl[4], coef[3][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int lo = 2 * k, hi = 2 * k + 1;
      pl[k] = t.n_c == 1 ? pack64(t.label[0][lo], t.label[0][hi])
              : t.n_c == 2 ? pack64(t.label[1][lo], t.label[1][hi])
                           : pack64(t.label[2][lo], t.label[2][hi]);
    }
    for (int step = 0;; ++step) {
      compress(st, n, pl, step <= t.n_c ? 96 : 64);
      n += 1;
      if (step == 0) {
        K4_STAMP_AFTER((uint32_t)st[3], 2);
        named_barrier(1, kThreads);
        // the compressed coefficients' canonical values b0, b2 = B - 3 C,
        // b3 = C, each as its absorb payload (32 big-endian bytes)
        uint32_t b[3][8], u[8];
#pragma unroll
        for (int k = 0; k < 3; ++k) fr::add8(part[k][0], part[k][1], b[k]);
        fr::add8(b[2], b[2], u);
        fr::add8(b[2], u, u);
        fr::sub8(b[1], u, b[1]);
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            coef[c][k] = pack64(bswap32(b[c][7 - 2 * k]),
                                bswap32(b[c][6 - 2 * k]));
        K4_STAMP_AFTER((uint32_t)coef[2][3], 3);
      }
      if (step == t.n_c) K4_STAMP_AFTER((uint32_t)st[3], 4);
      if (step == t.n_c + 1) break;
      // the next step's payload, picked by constant indices
#pragma unroll
      for (int k = 0; k < 4; ++k)
        pl[k] = step == 0 ? coef[0][k] : step == 1 ? coef[1][k] : coef[2][k];
    }
    K4_STAMP_AFTER((uint32_t)st[3], 5);
    // the challenge r: the squeeze's low 125 bits.  r, r^2 and r^3 are
    // exact below 2^375; lanes 0-3 take r, r^2, r^3's low 8 words and its
    // high 4 to Montgomery form at once (x R^2 R^-1 = x R, and x 2^768
    // R^-1 = (x 2^256) R for the high words), lane 2 adds lane 3's
    uint32_t r1[4], r2[8], r3[12];
    r1[0] = (uint32_t)st[0];
    r1[1] = (uint32_t)(st[0] >> 32);
    r1[2] = (uint32_t)st[1];
    r1[3] = (uint32_t)(st[1] >> 32) & 0x1FFFFFFFu;
    mul_exact<4, 4>(r1, r1, r2);
    mul_exact<4, 8>(r1, r2, r3);
    const uint32_t k512[8] = FR_R2_WORDS;
    const uint32_t k768[8] = {0xb4bf0040u, 0x5e94d8e1u, 0x1cfbb6b8u,
                              0x2a489cbeu, 0xa19fcfedu, 0x893cc664u,
                              0x7fcc657cu, 0x0cf8594bu};   // 2^768 mod p
    uint32_t x[8], y[8], rm[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      x[l] = lane == 1 ? r2[l] : lane == 2 ? r3[l]
             : lane == 3 ? (l < 4 ? r3[8 + l] : 0) : (l < 4 ? r1[l] : 0);
      y[l] = lane == 3 ? k768[l] : k512[l];
    }
    mont_mul(x, y, rm);
    uint32_t hi[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) hi[l] = __shfl_sync(0xffffffffu, rm[l], 3);
    if (lane == 2) fr::add8(rm, hi, rm);
    if (lane < 3) store8(rm, rpow[lane]);
    if (lane == 0) {
      store8(rm, (uint32_t*)t.r + 8 * (uint64_t)t.round);
      uint32_t* so = (uint32_t*)t.state;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        so[2 * k] = (uint32_t)st[k];
        so[2 * k + 1] = (uint32_t)(st[k] >> 32);
      }
      so[8] = n;
    }
    K4_STAMP_AFTER(rm[7], 6);
    named_barrier(2, kThreads);
    return;
  }

  // ---- the field warps: f = 2j + h, term j of instance i = 32h + lane:
  // with s = e0 + e2 - 2 e1 (0 at degree 1) and x = e3 - e0 + 3 (e1 - e2)
  // (0 below degree 3) the coefficients are c0 = e0 (claim/2 inactive),
  // c3 = x/6, c2 = s/2 - 3 c3, c1 = e1 - e0 - c2 - c3, so the batched
  // compressed polynomial is b0 = sum A, b2 = sum B - 3 sum C, b3 = sum C
  // with A = c0 w, B = s w/2, C = x w/6: one product a lane, by w's plain
  // forms, gives each term's canonical value (x R * w * R^-1 = x w)
  const int f = warp < kTranscriptWarp ? warp : warp - 1;
  const int j = f >> 1, h = f & 1, i = 32 * h + lane;
  const bool live = i < t.n_inst;
  uint32_t claim[8], e0[8], e1[8], s[8], x[8];
  bool active = false;
  zero8(claim);
  zero8(e0);
  zero8(e1);
  zero8(s);
  zero8(x);
  if (f == 0) K4_STAMP(32);
  if (live) {
    load8((const uint32_t*)t.claims + 8 * i, claim);
    const uint32_t* e = (const uint32_t*)t.evals[i];
    active = e != nullptr;
    if (active) {
      const int d = t.degree[i];
      uint32_t e2[8], u[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) e0[l] = e[l * d];
      fr::sub8(claim, e0, e1);
      if (d >= 2) {
#pragma unroll
        for (int l = 0; l < 8; ++l) e2[l] = e[l * d + 1];
        fr::add8(e0, e2, s);
        fr::add8(e1, e1, u);
        fr::sub8(s, u, s);
      }
      if (d == 3) {
#pragma unroll
        for (int l = 0; l < 8; ++l) x[l] = e[l * d + 2];
        fr::sub8(x, e0, x);
        fr::sub8(e1, e2, u);
        triple8(u, u);
        fr::add8(x, u, x);
      }
    }
  }
  if (f == 0) K4_STAMP_AFTER(e0[0] ^ claim[0] ^ x[7], 33);
  uint32_t v[8];
  zero8(v);
  if (live) {
    const uint32_t* wt = (const uint32_t*)t.weights + 8 * kWords * i;
    uint32_t a[8], w[8];
    // A: e0 w, or claim w/2 inactive; B: s w/2; C: x w/6
#pragma unroll
    for (int l = 0; l < 8; ++l)
      a[l] = j == 0 ? (active ? e0[l] : claim[l]) : j == 1 ? s[l] : x[l];
    load8(wt + 8 * (j == 0 ? (active ? 0 : 1) : j == 1 ? 1 : 2), w);
    mont_mul(a, w, v);
  }
  if (f == 0) K4_STAMP_AFTER(v[7], 34);
  // the warp's sum over its lanes (lanes past the last instance hold 0,
  // so levels at or past their count add nothing and are skipped)
  const int count = min(max(t.n_inst - 32 * h, 0), 32);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    if (off < count) {
      uint32_t o[8];
#pragma unroll
      for (int l = 0; l < 8; ++l)
        o[l] = __shfl_down_sync(0xffffffffu, v[l], off);
      fr::add8(v, o, v);
    }
  }
  if (lane == 0) store8(v, part[j][h]);
  if (f == 0) K4_STAMP_AFTER(v[7], 35);
  named_barrier(1, kThreads);

  // ---- while the transcript runs: the compressed coefficients in
  // Montgomery form into comp (field warp 5's lanes < n_c: b R^2 R^-1 =
  // b R),
  // and each lane's coefficient for its claim (warps j = 0: c0 and c1,
  // j = 1: c2, j = 2: c3; the degree shows only as zeros in s and x)
  if (f == 5 && lane < t.n_c) {
    uint32_t b[8], u[8];
    const int k = lane == 0 ? 0 : lane == 1 ? 1 : 2;
    fr::add8(part[k][0], part[k][1], b);
    if (k == 1) {                        // b2 = B - 3 C
      uint32_t cs[8];
      fr::add8(part[2][0], part[2][1], cs);
      triple8(cs, u);
      fr::sub8(b, u, b);
    }
    const uint32_t r2[8] = FR_R2_WORDS;
    mont_mul(b, r2, b);
    store8(b, (uint32_t*)t.comp + 8 * ((uint64_t)t.round * t.width + lane));
  }
  uint32_t c[8], c0[8];
  {
    const uint32_t inv2[8] = {t.inv2[0], t.inv2[1], t.inv2[2], t.inv2[3],
                              t.inv2[4], t.inv2[5], t.inv2[6], t.inv2[7]};
    const uint32_t inv6[8] = {t.inv6[0], t.inv6[1], t.inv6[2], t.inv6[3],
                              t.inv6[4], t.inv6[5], t.inv6[6], t.inv6[7]};
    uint32_t c3[8], half[8], u[8];
    mont_mul(x, inv6, c3);
    if (j == 2) {
      copy8(c3, c);
    } else {
      pick8(active, s, claim, u);
      mont_mul(u, inv2, half);          // s/2, or claim/2 inactive
      pick8(active, e0, half, c0);
      triple8(c3, u);
      fr::sub8(half, u, c);              // c2
      if (j == 0) {
        fr::sub8(e1, e0, u);
        fr::sub8(u, c, u);
        fr::sub8(u, c3, c);              // c1
      }
      if (!active) zero8(c);
    }
  }
  named_barrier(2, kThreads);

  // ---- each claim at the challenge: c0 + c1 r + c2 r^2 + c3 r^3, one
  // product a lane (warps j: c_{j+1} r^{j+1}), summed by warps j = 0
  if (f == 0) K4_STAMP_AFTER(rpow[0][7], 36);
  uint32_t pw[8];
  load8(rpow[j], pw);
  mont_mul(c, pw, c);
  if (j != 0) store8(c, term[j - 1][i]);
  named_barrier(3, kThreads - 32);
  if (j == 0 && live) {
    fr::add8(c, c0, c);
    fr::add8(c, term[0][i], c);
    fr::add8(c, term[1][i], c);
    store8(c, (uint32_t*)t.claims + 8 * i);
    if (f == 0) K4_STAMP_AFTER(c[7], 37);
  }
}

}  // namespace

// sizeof(Tail), for the wrapper's check of its ctypes layout.
extern "C" int jolt_k4_launch_size() { return (int)sizeof(Tail); }

// Launches K4 on `stream` with the launch record `tail` (checked by the
// caller: n_inst <= 64, degrees 1..3, 1 <= n_c <= width <= 3, every pointer
// on the current device).  Returns cudaGetLastError() (0 on success).
extern "C" int jolt_k4(const void* tail, void* stream) {
  k4_round_tail<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      *(const Tail*)tail);
  return (int)cudaGetLastError();
}
