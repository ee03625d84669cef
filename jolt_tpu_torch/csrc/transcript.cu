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
// One launch a round, one warp, on the stage's device buffers (`Tail`):
//   1. lane i (i < n_inst, strided by 32) recovers instance i's round
//      polynomial: from its evals at X in {0, 2, .., d} and its claim
//      s(0) + s(1) the d + 1 coefficients (degree 1-3, as the host's
//      `UniPoly.from_evals_and_hint`), or the constant claim/2 when the
//      instance is inactive this round (evals pointer 0); it also scales
//      them by the instance's batching coefficient;
//   2. lane 0 sums the scaled polynomials (the random linear combination),
//      drops the linear coefficient (compression), and runs the
//      transcript: absorb label_with_len("sumcheck_poly", n_c), absorb each
//      of the n_c coefficients as 32 big-endian bytes of its canonical
//      value, squeeze; the challenge is the squeeze's first 16 bytes read
//      little-endian with the top 3 bits of the 128 cleared
//      (`challenge_scalar_optimized`), taken to Montgomery form; it writes
//      the compressed coefficients and the challenge into the stage's
//      buffers at this round and the new state and n_rounds in place;
//   3. lane i replaces instance i's claim by its polynomial at the
//      challenge (Horner).
// Every absorb or squeeze is one Blake2b-256 compression of one final
// block: state (32 B) || 28 zero bytes || n_rounds (big-endian u32) ||
// payload (32 B, or none for a squeeze).
//
// What bounds it: latency.  A round reads a few hundred bytes and does
// 2 + n_c dependent compressions (12 rounds of 8 G functions on 64-bit
// words each) and a few dozen Montgomery products, one after another on one
// lane: ~10^-6 ms of the card's operation and byte rates, against a few
// microseconds of dependent instructions and the launch itself.  The
// design keeps it to one launch a round and no host round trip; the
// instance work is spread over the warp's lanes, the hashing is serial by
// nature.  Fields are the port's Montgomery limbs (8 x 32 bits, R = 2^256,
// `fr.cuh`).

#include "fr.cuh"

namespace {

constexpr int kMaxInst = 64;

// The launch record (`kernels.RoundTail` in field/kernels.py).
struct Tail {
  unsigned long long evals[kMaxInst];  // instance i's evals (8, d_i), 0 if
                                       // inactive this round
  int32_t degree[kMaxInst];            // d_i in 1..3
  int32_t n_inst;
  int32_t n_c;                         // this round's compressed length
  int32_t width;                       // comp's coefficients a round
  int32_t round;
  unsigned long long state;            // uint32[9]: state words, n_rounds
  unsigned long long claims;           // uint32[n_inst][8]
  unsigned long long coeffs;           // uint32[n_inst][8]
  unsigned long long comp;             // uint32[rounds][width][8]
  unsigned long long r;                // uint32[rounds][8]
  uint32_t label[8];                   // label_with_len payload words
  uint32_t inv2[8];                    // 1/2, Montgomery
  uint32_t inv6[8];                    // 1/6, Montgomery
};

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

#define B2_G(a, b, c, d, x, y)          \
  v[a] = v[a] + v[b] + (x);            \
  v[d] = rotr64(v[d] ^ v[a], 32);      \
  v[c] = v[c] + v[d];                  \
  v[b] = rotr64(v[b] ^ v[c], 24);      \
  v[a] = v[a] + v[b] + (y);            \
  v[d] = rotr64(v[d] ^ v[a], 16);      \
  v[c] = v[c] + v[d];                  \
  v[b] = rotr64(v[b] ^ v[c], 63);

#define B2_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, \
                 s14, s15)                                                   \
  B2_G(0, 4, 8, 12, m[s0], m[s1])                                            \
  B2_G(1, 5, 9, 13, m[s2], m[s3])                                            \
  B2_G(2, 6, 10, 14, m[s4], m[s5])                                           \
  B2_G(3, 7, 11, 15, m[s6], m[s7])                                           \
  B2_G(0, 5, 10, 15, m[s8], m[s9])                                           \
  B2_G(1, 6, 11, 12, m[s10], m[s11])                                         \
  B2_G(2, 7, 8, 13, m[s12], m[s13])                                          \
  B2_G(3, 4, 9, 14, m[s14], m[s15])

// One transcript step: state = Blake2b-256(state || 28 zero bytes ||
// n_rounds BE || payload), n_rounds += 1.  payload null: a squeeze.
__device__ void step(uint64_t st[4], uint32_t& n, const uint64_t* payload) {
  const uint64_t iv[8] = {0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull,
                          0x3C6EF372FE94F82Bull, 0xA54FF53A5F1D36F1ull,
                          0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full,
                          0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull};
  uint64_t m[16];
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = st[j];
  m[4] = m[5] = m[6] = 0;
  m[7] = (uint64_t)bswap32(n) << 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) m[8 + j] = payload ? payload[j] : 0;
  m[12] = m[13] = m[14] = m[15] = 0;
  uint64_t h[8], v[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = iv[j];
    v[8 + j] = iv[j];
  }
  h[0] ^= 0x01010020ull;             // digest length 32, fanout 1, depth 1
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = h[j];
  v[12] ^= payload ? 96 : 64;        // the message's byte length
  v[14] = ~v[14];                    // the final block
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
#pragma unroll
  for (int j = 0; j < 4; ++j) st[j] = h[j] ^ v[j] ^ v[j + 8];
  n += 1;
}

__device__ __forceinline__ void copy8(const uint32_t* a, uint32_t* out) {
#pragma unroll
  for (int l = 0; l < 8; ++l) out[l] = a[l];
}

// Instance i's round polynomial (Montgomery coefficients c[0..n)) from its
// evals e (8, d) at X = 0, 2, .., d and its claim; returns n = d + 1.
__device__ int recover(const uint32_t* e, int d, const uint32_t claim[8],
                       const Tail& t, uint32_t c[4][8]) {
  uint32_t e0[8], e1[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) e0[l] = e[l * d];
  fr::sub8(claim, e0, e1);
  copy8(e0, c[0]);
  if (d == 1) {
    fr::sub8(e1, e0, c[1]);
    return 2;
  }
  uint32_t e2[8], s[8], t2[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) e2[l] = e[l * d + 1];
  fr::add8(e0, e2, s);                         // s = e0 + e2 - 2 e1
  fr::add8(e1, e1, t2);
  fr::sub8(s, t2, s);
  if (d == 2) {
    fr::mont_mul8(s, t.inv2, c[2]);            // c2 = s / 2
    fr::sub8(e1, e0, c[1]);
    fr::sub8(c[1], c[2], c[1]);                // c1 = e1 - e0 - c2
    return 3;
  }
  uint32_t e3[8], d12[8], x[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) e3[l] = e[l * d + 2];
  fr::sub8(e1, e2, d12);                       // c3 = (e3 - e0 + 3 d12) / 6
  fr::sub8(e3, e0, x);
  fr::add8(d12, d12, t2);
  fr::add8(d12, t2, t2);
  fr::add8(x, t2, x);
  fr::mont_mul8(x, t.inv6, c[3]);
  fr::mont_mul8(s, t.inv2, c[2]);              // c2 = s / 2 - 3 c3
  fr::add8(c[3], c[3], t2);
  fr::add8(c[3], t2, t2);
  fr::sub8(c[2], t2, c[2]);
  fr::sub8(e1, e0, c[1]);                      // c1 = e1 - e0 - c2 - c3
  fr::sub8(c[1], c[2], c[1]);
  fr::sub8(c[1], c[3], c[1]);
  return 4;
}

// __grid_constant__: the record stays in the parameter bank though its
// arrays are read by address.
__global__ void __launch_bounds__(32)
k4_round_tail(const __grid_constant__ Tail t) {
  __shared__ uint32_t coef[kMaxInst][4][8];    // each instance's polynomial
  __shared__ uint32_t scaled[kMaxInst][4][8];  // times its batching coeff
  __shared__ int ncoef[kMaxInst];
  __shared__ uint32_t rch[8];                  // the round's challenge
  const int lane = threadIdx.x;
  uint32_t* claims = (uint32_t*)t.claims;
  const uint32_t* weights = (const uint32_t*)t.coeffs;

  for (int i = lane; i < t.n_inst; i += 32) {
    uint32_t claim[8], c[4][8];
    copy8(claims + 8 * i, claim);
    int n = 1;
    if (t.evals[i] == 0)
      fr::mont_mul8(claim, t.inv2, c[0]);      // inactive: claim / 2
    else
      n = recover((const uint32_t*)t.evals[i], t.degree[i], claim, t, c);
    for (int k = 0; k < n; ++k) {
      copy8(c[k], coef[i][k]);
      fr::mont_mul8(c[k], weights + 8 * i, scaled[i][k]);
    }
    ncoef[i] = n;
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
    uint32_t* comp = (uint32_t*)t.comp + (uint64_t)t.round * t.width * 8;
    const uint32_t one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
    for (int k = 0; k < t.n_c; ++k) {
      const uint32_t* bk = b[k == 0 ? 0 : k + 1];   // [c0, c2, c3, ..]
      uint32_t canon[8];
      copy8(bk, comp + 8 * k);
      fr::mont_mul8(bk, one, canon);               // x R^-1: canonical
#pragma unroll
      for (int j = 0; j < 4; ++j)                  // 32 big-endian bytes
        payload[j] = bswap32(canon[7 - 2 * j])
                     | ((uint64_t)bswap32(canon[6 - 2 * j]) << 32);
      step(st, n, payload);
    }
    step(st, n, nullptr);                          // the squeeze
    uint32_t raw[8] = {(uint32_t)st[0], (uint32_t)(st[0] >> 32),
                       (uint32_t)st[1],
                       (uint32_t)(st[1] >> 32) & 0x1FFFFFFFu, 0, 0, 0, 0};
    const uint32_t r2[8] = FR_R2_WORDS;
    fr::mont_mul8(raw, r2, rch);                   // raw R^2 R^-1 = raw R
    copy8(rch, (uint32_t*)t.r + 8 * (uint64_t)t.round);
    uint32_t* so = (uint32_t*)t.state;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      so[2 * j] = (uint32_t)st[j];
      so[2 * j + 1] = (uint32_t)(st[j] >> 32);
    }
    so[8] = n;
  }
  __syncwarp();

  for (int i = lane; i < t.n_inst; i += 32) {
    uint32_t acc[8], r[8];
    copy8(rch, r);
    const int n = ncoef[i];
    copy8(coef[i][n - 1], acc);
    for (int k = n - 2; k >= 0; --k) {             // Horner at r
      fr::mont_mul8(acc, r, acc);
      fr::add8(acc, coef[i][k], acc);
    }
    copy8(acc, claims + 8 * i);
  }
}

}  // namespace

// sizeof(Tail), for the wrapper's check of its ctypes layout.
extern "C" int jolt_k4_launch_size() { return (int)sizeof(Tail); }

// Launches K4 on `stream` with the launch record `tail` (checked by the
// caller: n_inst <= 64, degrees 1..3, 1 <= n_c <= width <= 3, every pointer
// on the current device).  Returns cudaGetLastError() (0 on success).
extern "C" int jolt_k4(const void* tail, void* stream) {
  k4_round_tail<<<1, 32, 0, (cudaStream_t)stream>>>(*(const Tail*)tail);
  return (int)cudaGetLastError();
}
