// K2: one HighToLow round of a degree-3, three-factor product sumcheck:
// the round message's evaluations at X in {0, 2, 3} and the three bound
// factors, in one pass over memory.
//
// Replaces the JAX package's Pallas kernel
// `field/pallas_ops.py:product_round_deg3` (body `_round_kernel_deg3`), in
// the port's layout: 8 x 32-bit limbs, R = 2^256, int32 tensors (8, T).
// For each pair i < T/2 with lo = p[:, i], hi = p[:, i + T/2] of each
// factor p0, p1, p2:
//   m = hi - lo, e2 = hi + m, e3 = e2 + m      (evals at X = 0, 2, 3)
//   bound[:, i] = lo + r * m                  (written at length T/2)
//   prod_k = ev_k(p0) * ev_k(p1) * ev_k(p2)   (k over the three points)
// and the message is the sum over pairs of prod_k.  Each thread block
// writes the exact sums of the 32-bit limb planes of its products, one
// (8, 3) block of uint64 partials (a block of 256 words of < 2^32 stays
// below 2^40); the wrapper adds the blocks in int64 and reduces mod p
// (`ops.reduce_cols`).  This replaces the reference's lazy uint32 sums of
// 13-bit limbs.
//
// Design: one thread per pair, coalesced loads and stores of every limb
// plane (neighbouring threads, neighbouring words), the shared CIOS product
// `fr::mont_mul8` (fr.cuh) for the 3 binds and the 6 products, then the
// block sums by 64-bit warp shuffles and one shared-memory pass.
//
// What bounds it on an H100 SXM: per pair it reads 6 x 32 B and writes
// 3 x 32 B (288 B) and does 9 Montgomery products of 272 32-bit
// multiply-adds each (2448).  At 3.35 TB/s and 16.7 T int32 multiply-adds/s
// (132 SMs x 64 per clock x 1.98 GHz) the multiplies take 146.6 ps and the
// bytes 86.0 ps per pair: the kernel is bound by operations (T = 2^18:
// 0.0192 ms, bytes alone 0.0113 ms; T = 2^20: 0.077 ms, bytes 0.045 ms).
//
// Left for later: wgmma, TMA and PTX carry chains; a kernel that fuses the
// bind of round j with the message of round j + 1 (the only fusion a
// Fiat-Shamir prover round can use: r_j is drawn from round j's message).

#include "fr.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
product_round_deg3_kernel(const uint32_t* __restrict__ p0,
                          const uint32_t* __restrict__ p1,
                          const uint32_t* __restrict__ p2,
                          const uint32_t* __restrict__ r,
                          uint32_t* __restrict__ b0,
                          uint32_t* __restrict__ b1,
                          uint32_t* __restrict__ b2,
                          unsigned long long* __restrict__ partial,
                          uint32_t half) {
  __shared__ unsigned long long warp_sums[kWarps][24];
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  const uint64_t T = 2ull * half;
  uint32_t acc[3][8];
  if (i < half) {
    uint32_t rr[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) rr[l] = r[l];
    const uint32_t* ps[3] = {p0, p1, p2};
    uint32_t* bs[3] = {b0, b1, b2};
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      uint32_t lo[8], hi[8], m[8], e2[8], e3[8], t[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        lo[l] = ps[f][l * T + i];
        hi[l] = ps[f][l * T + half + i];
      }
      fr::sub8(hi, lo, m);
      fr::add8(hi, m, e2);
      fr::add8(e2, m, e3);
      fr::mont_mul8(m, rr, t);
      fr::add8(lo, t, t);
#pragma unroll
      for (int l = 0; l < 8; ++l) bs[f][(uint64_t)l * half + i] = t[l];
      if (f == 0) {
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          acc[0][l] = lo[l];
          acc[1][l] = e2[l];
          acc[2][l] = e3[l];
        }
      } else {
        fr::mont_mul8(acc[0], lo, acc[0]);
        fr::mont_mul8(acc[1], e2, acc[1]);
        fr::mont_mul8(acc[2], e3, acc[2]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 8; ++l) acc[k][l] = 0;
  }
  // exact block sums of each limb plane: warp shuffles, then shared memory
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      unsigned long long v = acc[k][l];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_sums[warp][l * 3 + k] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < 24) {
    unsigned long long s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    partial[(uint64_t)blockIdx.x * 24 + threadIdx.x] = s;
  }
}

}  // namespace

extern "C" int jolt_product_round_blocks(int64_t half) {
  return (int)((half + kThreads - 1) / kThreads);
}

// Launches K2 on `stream`: p0..p2 (8, 2 half), r (8, 1) contiguous;
// b0..b2 (8, half); partial (blocks, 8, 3) uint64.  Returns
// cudaGetLastError() (0 on success).
extern "C" int jolt_product_round_deg3(const void* p0, const void* p1,
                                       const void* p2, const void* r,
                                       void* b0, void* b1, void* b2,
                                       void* partial, int64_t half,
                                       void* stream) {
  unsigned blocks = (unsigned)jolt_product_round_blocks(half);
  product_round_deg3_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p0, (const uint32_t*)p1, (const uint32_t*)p2,
      (const uint32_t*)r, (uint32_t*)b0, (uint32_t*)b1, (uint32_t*)b2,
      (unsigned long long*)partial, (uint32_t)half);
  return (int)cudaGetLastError();
}
