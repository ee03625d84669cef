// K1: elementwise BN254 Fr Montgomery product out = a * b * 2^-256 mod p.
//
// Replaces the JAX package's Pallas kernel `field/pallas_ops.py:mont_mul`
// (body `_mont_mul_kernel`: a 20 x 13-bit-limb schoolbook, a 20-step
// base-2^13 reduction and one conditional subtract, on (20, N) uint32
// blocks).  This kernel computes the same function in the port's layout:
// 8 x 32-bit limbs, R = 2^256, limbs-first (8, n0, n1) int32 tensors.
//
// Design: one thread per element.  CIOS Montgomery multiplication over
// 8 words on 32-bit multiply-add carry chains, then one conditional
// subtract of p.  Takes
// a < 2^256 and b < p, so the value before the subtract is < 2p.  Each
// operand comes with (limb, row, column) strides in elements, so a
// broadcast scalar or per-row weight is read in place with stride 0; the
// output is contiguous (8, n0, n1).  Neighbouring threads read neighbouring
// words of each limb plane, so loads and stores coalesce.
//
// What bounds it on an H100 SXM: per element it reads 2 x 32 B and writes
// 32 B (96 B) and does 136 32x32->64 multiplies (64 for a*b, 8 for the
// reduction factors, 64 for m*p), i.e. 272 32-bit multiply-adds (low and
// high halves).  At 3.35 TB/s and 132 SMs x 64 integer multiply-adds per
// clock at 1.98 GHz (16.7 T/s, half the float32 FMA rate), memory takes
// 28.7 ps and multiplies 16.3 ps per element: the kernel is bound by bytes
// when both operands stream, and close to balanced when one is a scalar.
//
// The CIOS product itself (`fr::mont_mul8`, on PTX carry chains) lives in
// `fr.cuh`, shared with K2 (`product_round.cu`).
//
// Left for later: the reduction is not interleaved with the schoolbook
// across warps, and nothing is fused around the product.

#include "fr.cuh"

namespace {

__global__ void mont_mul_kernel(uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                uint32_t n0, uint32_t n1,
                                int64_t a_l, int64_t a_0, int64_t a_1,
                                int64_t b_l, int64_t b_0, int64_t b_1) {
  uint32_t total = n0 * n1;
  uint32_t idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  uint32_t row = idx / n1, col = idx - row * n1;
  const uint32_t* pa = a + row * a_0 + col * a_1;
  const uint32_t* pb = b + row * b_0 + col * b_1;
  uint32_t x[8], y[8], z[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    x[l] = pa[l * a_l];
    y[l] = pb[l * b_l];
  }
  fr::mont_mul8(x, y, z);
#pragma unroll
  for (int l = 0; l < 8; ++l) out[(uint64_t)l * total + idx] = z[l];
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int jolt_mont_mul(void* out, const void* a, const void* b,
                             int64_t n0, int64_t n1,
                             int64_t a_l, int64_t a_0, int64_t a_1,
                             int64_t b_l, int64_t b_0, int64_t b_1,
                             void* stream) {
  const int threads = 256;
  int64_t total = n0 * n1;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  mont_mul_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b,
      (uint32_t)n0, (uint32_t)n1, a_l, a_0, a_1, b_l, b_0, b_1);
  return (int)cudaGetLastError();
}
