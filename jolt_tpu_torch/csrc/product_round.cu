// K2: one HighToLow round of a product sumcheck of NF = 2 or 3 factors at
// degree NF -- the round message's evaluations at X in {0, 2, .., NF} and
// the factors bound at a challenge r -- in one pass over memory, with the
// message finished mod p on the card.
//
// Replaces the JAX package's Pallas kernel
// `field/pallas_ops.py:product_round_deg3` (body `_round_kernel_deg3`: NF = 3,
// message then bind at the same r), in the port's layout: 8 x 32-bit limbs,
// R = 2^256, int32 tensors (8, T).  For a pair (lo, hi) of a factor, its
// value at X is lo + X (hi - lo) and its bind at r is lo + r (hi - lo).
// Four pass orders (`Order`):
//   kMessageBind  message over the pairs (p[i], p[i + T/2]), and each factor
//                 bound at r into b[i] (length T/2): the TPU kernel's
//                 function, which `round_step` serves;
//   kMessage      the message alone: the first round of a live sumcheck;
//   kBindMessage  each factor bound at r first (b[i] from p[i], p[i + T/2]
//                 and b[i + T/4] from p[i + T/4], p[i + 3T/4]), then the
//                 message over the bound pairs (b[i], b[i + T/4]): a live
//                 round, which binds at r_j and messages round j + 1, the
//                 only fusion a Fiat-Shamir prover can use (r_j is drawn
//                 from round j's message);
//   kBind         the bind alone: the last round's challenge.
//
// Design:
//   * One thread per pair (per pair of bound pairs in kBindMessage) in a
//     grid-stride loop; loads and stores coalesce on every limb plane
//     (neighbouring threads, neighbouring words).  Blocks of 128 threads,
//     halved down to 32 while the grid would hold fewer than two blocks per
//     SM, so T = 2^14 still spreads over the card (256 blocks of 32 threads
//     in kMessageBind; kBindMessage has only T/4 = 4096 threads there).
//   * Registers: the message is formed one eval point at a time, and each
//     factor's pair is loaded again for every point (from L1/L2; DRAM reads
//     each word once), so no thread holds more than the running product, one
//     pair and its slope: __launch_bounds__(128, 8) caps a thread at 64
//     registers, 1024 threads an SM, twice the occupancy of the first K2.
//     The loads are opaque (volatile asm) so the compiler cannot merge them
//     back into one long-lived copy; kBindMessage reloads its own bound
//     values through L2 (`ld.global.cg`).  r is passed by value and sits in
//     the kernel's parameter bank.
//   * Sums: each thread's products, one 32-bit limb plane at a time, are
//     summed over the warp exactly as 16-bit halves by `redux.sync`
//     (< 2^21 each), then per block in shared memory, into one uint64 per
//     (eval point, limb) column and block (< 2^63 for < 2^31 pairs).  A
//     second kernel adds the blocks' columns, carries them into 8 words plus
//     h < 2^32 above 2^256, and reduces S = lo + h 2^256 mod p as
//     mont(lo, R mod p) + mont(h, R^2 mod p): the same unique value < p as
//     `ops.reduce_cols`, so the message is bit-equal to the plain version.
//     A round is therefore one launch of the pass kernel plus one of the
//     finish kernel, with no torch op between them.
//   * The word arithmetic is `fr.cuh`'s PTX carry chains.
//
// What bounds it on an H100 SXM (3.35 TB/s; 16.7 T int32 multiply-adds/s =
// 132 SMs x 64 per clock x 1.98 GHz; a Montgomery product is 272
// multiply-adds), per pair of the input, with NF factors:
//   kMessageBind  reads 64 NF B, writes 32 NF B; NF binds + (NF - 1) NF
//                 products (NF = 3: 9 products, 0.0192 ms at T = 2^18,
//                 bytes 0.0113 ms: bound by operations);
//   kMessage      reads 64 NF B; (NF - 1) NF products;
//   kBindMessage  reads 64 NF B, writes 32 NF B; NF binds + (NF - 1) NF / 2
//                 products (the message is over T/4 pairs);
//   kBind         reads 64 NF B, writes 32 NF B; NF binds.
// The bind-only order, and every order at NF = 2 but message-then-bind, is
// bound by bytes (NF = 2, T = 2^18: 0.0050-0.0075 ms of bytes against
// 0.0043-0.0064 ms of products); `chip_smoke.py` computes each bound.
//
// Tensor cores (wgmma) do not fit: a 256-bit modular product is a chain of
// 32-bit multiplies whose carries run through every word, and the tensor
// cores multiply 8-bit integers or floats into sums without carries
// between lanes.  Using them (e.g. for the 16-bit sub-products of many
// independent products) is left to a later change.

#include "fr.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMinBlocks = 8;      // 8 x 128 threads x 64 registers = one SM
constexpr int kMaxWarps = kMaxThreads / 32;

enum Order : int { kMessageBind = 0, kMessage = 1, kBindMessage = 2,
                   kBind = 3 };

struct Factors {
  const uint32_t* p[3];    // inputs, (8, T) each
  uint32_t* b[3];          // bound factors, (8, T/2) each
};

struct Scalar {
  uint32_t w[8];
};

// The 8 limbs of one entry, from limb planes `stride` words apart.
__device__ __forceinline__ void load_in(const uint32_t* p, uint64_t stride,
                                        uint32_t v[8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l)
    asm volatile("ld.global.nc.u32 %0, [%1];"
                 : "=r"(v[l]) : "l"(p + l * stride));
}

// The same from a tensor this kernel wrote (coherent, through L2).
__device__ __forceinline__ void load_own(const uint32_t* p, uint64_t stride,
                                         uint32_t v[8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l)
    asm volatile("ld.global.cg.u32 %0, [%1];"
                 : "=r"(v[l]) : "l"(p + l * stride) : "memory");
}

__device__ __forceinline__ void store8(uint32_t* p, uint64_t stride,
                                       const uint32_t v[8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l)
    asm volatile("st.global.u32 [%0], %1;"
                 :: "l"(p + l * stride), "r"(v[l]) : "memory");
}

// out = lo + r (hi - lo)   (out may alias lo or hi)
__device__ __forceinline__ void bind(const uint32_t lo[8],
                                     const uint32_t hi[8], const Scalar& r,
                                     uint32_t out[8]) {
  uint32_t m[8];
  fr::sub8(hi, lo, m);
  fr::mont_mul8(m, r.w, m);
  fr::add8(lo, m, out);
}

// One round over the n work items of `order` (n = T/2, or T/4 for
// kBindMessage).  partial is (8 NF, gridDim.x) uint64: column k * 8 + l
// holds, per block, the exact sum of limb l of the products at the k-th
// eval point.
template <int NF, int ORDER>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
round_kernel(Factors fs, Scalar r, unsigned long long* __restrict__ partial,
             uint32_t n) {
  constexpr bool kMsg = ORDER != kBind;
  constexpr int kCols = 8 * NF;
  __shared__ unsigned long long warp_sums[kMaxWarps][kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (kMsg && lane == 0) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) warp_sums[warp][c] = 0;
  }
  // the message's pairs (i, i + n), limb planes 2n apart: in the inputs, or
  // in the bound factors after a bind-first pass
  const uint64_t n2 = 2ull * n;
  const uint32_t step = gridDim.x * blockDim.x;
  // the loop bound is the same for every thread of a block, so whole warps
  // reach each redux.sync
  for (uint32_t base = blockIdx.x * blockDim.x; base < n; base += step) {
    const uint32_t i = base + threadIdx.x;
    const bool live = i < n;
    if (live && (ORDER == kMessageBind || ORDER == kBind)) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        uint32_t lo[8], hi[8];
        load_in(fs.p[f] + i, n2, lo);
        load_in(fs.p[f] + i + n, n2, hi);
        bind(lo, hi, r, lo);
        store8(fs.b[f] + i, n, lo);
      }
    }
    if (live && ORDER == kBindMessage) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t lo[8], hi[8];
          load_in(fs.p[f] + i + h * (uint64_t)n, 2 * n2, lo);
          load_in(fs.p[f] + i + (2 + h) * (uint64_t)n, 2 * n2, hi);
          bind(lo, hi, r, lo);
          store8(fs.b[f] + i + h * (uint64_t)n, n2, lo);
        }
      }
    }
    if (!kMsg) continue;
#pragma unroll
    for (int k = 0; k < NF; ++k) {        // X = 0, then X = k + 1
      uint32_t acc[8];
      if (live) {
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          uint32_t lo[8], ev[8];
          if (ORDER == kBindMessage)
            load_own(fs.b[f] + i, n2, lo);
          else
            load_in(fs.p[f] + i, n2, lo);
          if (k == 0) {
#pragma unroll
            for (int l = 0; l < 8; ++l) ev[l] = lo[l];
          } else {
            uint32_t hi[8], m[8];
            if (ORDER == kBindMessage)
              load_own(fs.b[f] + i + n, n2, hi);
            else
              load_in(fs.p[f] + i + n, n2, hi);
            fr::sub8(hi, lo, m);
            fr::add8(hi, m, ev);
#pragma unroll
            for (int x = 2; x <= k; ++x) fr::add8(ev, m, ev);
          }
          if (f == 0) {
#pragma unroll
            for (int l = 0; l < 8; ++l) acc[l] = ev[l];
          } else {
            fr::mont_mul8(acc, ev, acc);
          }
        }
      } else {
#pragma unroll
        for (int l = 0; l < 8; ++l) acc[l] = 0;
      }
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const uint32_t s_lo = __reduce_add_sync(0xffffffffu, acc[l] & 0xffffu);
        const uint32_t s_hi = __reduce_add_sync(0xffffffffu, acc[l] >> 16);
        if (lane == 0)
          warp_sums[warp][k * 8 + l] +=
              s_lo + ((unsigned long long)s_hi << 16);
      }
    }
  }
  if (kMsg) {
    __syncthreads();
    if (threadIdx.x < kCols) {
      unsigned long long s = 0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
        s += warp_sums[w][threadIdx.x];
      partial[(uint64_t)threadIdx.x * gridDim.x + blockIdx.x] = s;
    }
  }
}

// The message mod p from the blocks' column sums: one block of 32 x 8 NF
// threads, warp c adding column c; then thread k < NF carries eval point
// k's 8 columns into words lo + h 2^256 and reduces them.  msg is (8, NF, 1)
// Montgomery limbs.
template <int NF>
__global__ void finish_kernel(const unsigned long long* __restrict__ partial,
                              uint32_t blocks, uint32_t* __restrict__ msg) {
  constexpr int kCols = 8 * NF;
  __shared__ unsigned long long cols[kCols];
  const int c = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long s = 0;
  for (uint32_t j = lane; j < blocks; j += 32)
    s += partial[(uint64_t)c * blocks + j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) cols[c] = s;
  __syncthreads();
  if (threadIdx.x < NF) {
    const int k = threadIdx.x;
    const uint32_t r1[8] = FR_R_WORDS, r2[8] = FR_R2_WORDS;
    uint32_t lo[8], h[8];
    unsigned long long carry = 0;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const unsigned long long v = cols[k * 8 + l] + carry;
      lo[l] = (uint32_t)v;
      carry = v >> 32;
      h[l] = 0;
    }
    h[0] = (uint32_t)carry;
    fr::mont_mul8(lo, r1, lo);       // lo mod p
    fr::mont_mul8(h, r2, h);         // h 2^256 mod p
    fr::add8(lo, h, lo);
#pragma unroll
    for (int l = 0; l < 8; ++l) msg[l * NF + k] = lo[l];
  }
}

struct Plan {
  uint32_t n;           // work items
  int threads;
  unsigned blocks;
};

// The launch shape for `order` at T entries a factor, on the current device.
cudaError_t plan(int order, int64_t T, Plan* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t n = order == kBindMessage ? T / 4 : T / 2;
  int threads = kMaxThreads;
  while (threads > 32 && (n + threads - 1) / threads < 2 * sms) threads >>= 1;
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * kMinBlocks * (kMaxThreads / threads);
  if (blocks > cap) blocks = cap;
  *out = {(uint32_t)n, threads, (unsigned)blocks};
  return cudaSuccess;
}

template <int NF>
void launch_pass(int order, const Plan& pl, const Factors& fs,
                 const Scalar& r, unsigned long long* partial,
                 cudaStream_t s) {
  switch (order) {
    case kMessageBind:
      round_kernel<NF, kMessageBind><<<pl.blocks, pl.threads, 0, s>>>(
          fs, r, partial, pl.n);
      break;
    case kMessage:
      round_kernel<NF, kMessage><<<pl.blocks, pl.threads, 0, s>>>(
          fs, r, partial, pl.n);
      break;
    case kBindMessage:
      round_kernel<NF, kBindMessage><<<pl.blocks, pl.threads, 0, s>>>(
          fs, r, partial, pl.n);
      break;
    default:
      round_kernel<NF, kBind><<<pl.blocks, pl.threads, 0, s>>>(
          fs, r, partial, pl.n);
  }
}

}  // namespace

// The pass kernel's grid size for `order` at T (the column count of the
// partial sums); negative: a CUDA error.
extern "C" int jolt_product_round_blocks(int order, int64_t T) {
  Plan pl;
  cudaError_t err = plan(order, T, &pl);
  return err == cudaSuccess ? (int)pl.blocks : -(int)err;
}

// Launches K2 on `stream`.  nf in {2, 3} and order in {0..3} (`Order`),
// checked by the caller, as are the shapes: p* (8, T) contiguous, b* (8, T/2)
// (unused by kMessage), r_words 8 host words of r's Montgomery form (unused
// by kMessage), partial (8 nf, jolt_product_round_blocks(order, T)) uint64
// (unused by kBind).  With msg (8, nf, 1) non-null and a message order, the
// finish kernel follows and writes the message mod p; with msg null the
// block sums stay in partial.  Returns cudaGetLastError() (0 on success).
extern "C" int jolt_product_round(int nf, int order, int64_t T,
                                  const void* p0, const void* p1,
                                  const void* p2, void* b0, void* b1,
                                  void* b2, const void* r_words,
                                  void* partial, void* msg, void* stream) {
  Plan pl;
  cudaError_t err = plan(order, T, &pl);
  if (err != cudaSuccess) return (int)err;
  Factors fs = {{(const uint32_t*)p0, (const uint32_t*)p1,
                 (const uint32_t*)p2},
                {(uint32_t*)b0, (uint32_t*)b1, (uint32_t*)b2}};
  Scalar r = {};
  if (r_words != nullptr)
    for (int l = 0; l < 8; ++l) r.w[l] = ((const uint32_t*)r_words)[l];
  cudaStream_t s = (cudaStream_t)stream;
  auto* sums = (unsigned long long*)partial;
  if (nf == 2)
    launch_pass<2>(order, pl, fs, r, sums, s);
  else
    launch_pass<3>(order, pl, fs, r, sums, s);
  err = cudaGetLastError();
  if (err != cudaSuccess || order == kBind || msg == nullptr) return (int)err;
  if (nf == 2)
    finish_kernel<2><<<1, 32 * 16, 0, s>>>(sums, pl.blocks, (uint32_t*)msg);
  else
    finish_kernel<3><<<1, 32 * 24, 0, s>>>(sums, pl.blocks, (uint32_t*)msg);
  return (int)cudaGetLastError();
}
