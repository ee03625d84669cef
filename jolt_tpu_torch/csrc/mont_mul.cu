// K1: the port's elementwise BN254 Fr kernel, in six forms (`Op`):
//   kMul     out = a * b * 2^-256 mod p  (a < 2^256, b < p)
//   kAdd     out = (a + b) mod p
//   kSub     out = (a - b) mod p
//   kBind    out = lo + r (hi - lo) mod p, lo = a, hi = b, r = c: the
//            HighToLow bind of two halves or the LowToHigh bind of
//            interleaved pairs, in one pass
//   kEvals   from pairs (lo, hi), the points X = 0, 2, .., deg written
//            straight into a (8, deg, n0, n1) output (lo + X (hi - lo))
//   kReduce  exact int64 limb-plane column sums S (8, n0, n1) -> S mod p in
//            Montgomery form, as mont(lo, R) + mont(h, R^2) with
//            S = lo + h 2^256, times an optional Fr scale c
// Every output is the unique normalized value < p, so the card is byte
// equal to the plain versions in `field/kernels.py` and to the CPU.
//
// Replaces the JAX package's Pallas kernel `field/pallas_ops.py:mont_mul`
// (body `_mont_mul_kernel`: a 20 x 13-bit-limb schoolbook and base-2^13
// reduction on (20, N) uint32 blocks).  The TPU kernel is one product;
// the torch port around it ran every add, sub, bind, eval point and mod-p
// finish as ~10-95 int64 torch launches each, so this kernel takes the
// product's place and those of the torch limb arithmetic around it.  Port
// layout: 8 x 32-bit limbs, R = 2^256, limbs-first (8, n0, n1) int32
// tensors; the wrapper collapses every batch to (rows n0, columns n1).
//
// Hopper design (an elementwise pass, bound by bytes):
//   * No division.  A 2-D grid: columns on blockIdx.x * blockDim.x +
//     threadIdx.x, rows on blockIdx.y, both grid-stride loops.  The wrapper
//     merges rows into one when every operand's rows follow on from its
//     columns, so a contiguous pass is a single row on a linear index.
//     Offsets are 32-bit (the wrapper raises on a tensor of 2^31 elements).
//   * Operand kinds (`Kind`), chosen by the wrapper and uniform across the
//     grid (a branch no warp diverges on): kScalar, a canonical value passed
//     by value in the kernel's parameters (a challenge, a constant: never
//     uploaded, never loaded); kRow, constant along a row (a per-row
//     weight, a device scalar), loaded once per thread; kVec, contiguous
//     columns, read with 64-bit loads at V = 2; kStrided, any strides (bind's
//     interleaved pairs among them), 32-bit loads.  A kind that read two
//     interleaved pairs as one 128-bit load was no faster than kStrided at
//     2^17-2^19 pairs (within 3 %, either way) and was dropped.
//   * V consecutive columns a thread, chosen per launch by its size
//     (`kTwoColumnsFrom`): V = 1 below 2^20 outputs, so that 2^17 outputs
//     give the 132 SMs ~990 threads each instead of ~500;
//     V = 2 from 2^20, with 64-bit loads and stores of each limb plane and
//     two independent carry chains to interleave.  The reduce form takes
//     V = 1.  V = 4 would hold 64 words of operands alone and exceed the 64
//     registers that keep 1024 threads an SM resident
//     (__launch_bounds__(128, 8)).  Blocks of 128 threads; the grid is
//     capped at eight waves of resident blocks and strides beyond.
//   * Shared memory and TMA are not used: an elementwise pass reuses no
//     data, so staging through shared memory buys nothing over coalesced
//     vector loads straight into registers.  Tensor cores are not used: a
//     256-bit modular product carries through every word, and the tensor
//     cores multiply small integers or floats without carries between lanes.
//   * The word arithmetic is `fr.cuh`'s PTX carry chains, shared with K2.
//
// What bounds each form on an H100 SXM (3.35 TB/s; 16.7 T int32
// multiply-adds/s = 132 SMs x 64 a clock x 1.98 GHz; a Montgomery product
// is 272 multiply-adds, 16.3 ps at that rate), per output element with
// every operand streaming (a scalar or per-row operand reads ~0 B):
//   kMul     reads 64 B, writes 32 B (28.7 ps), 1 product: bytes
//   kAdd/Sub reads 64 B, writes 32 B (28.7 ps), no product: bytes
//   kBind    reads 64 B, writes 32 B (28.7 ps), 1 product: bytes; a
//            (8, 2^17)-output bind moves 12.6 MB, 3.76 us
//   kEvals   reads 64 B, writes 32 deg B, no product: bytes
//   kReduce  reads 64 B, writes 32 B (28.7 ps); the function needs two
//            8-word-by-1-word folds (32 multiply-adds, 1.9 ps) and a
//            product only with the scale (16.3 ps): bytes.  This kernel
//            spends two full products on the folds (32.6 ps), so it is
//            bound by its operations, not by the function's.
// `workload.k1_bound_ms` computes each launch's bound from its shapes.

#include "fr.cuh"

namespace {

enum Op : int { kMul = 0, kAdd = 1, kSub = 2, kBind = 3, kEvals = 4,
                kReduce = 5 };
enum Kind : int { kNone = 0, kScalar = 1, kRow = 2, kVec = 3, kStrided = 4 };

// One operand over the (n0, n1) grid: element (limb l, row i, column j) at
// p + l sl + i s0 + j s1 (elements of 4 bytes; 8 for kReduce's sums).
struct Operand {
  unsigned long long p;
  int kind;
  uint32_t sl, s0, s1;
  uint32_t w[8];         // kScalar: the value's Montgomery words
};

struct Launch {
  int op, deg;
  uint32_t n0, n1;
  unsigned long long out;   // contiguous (8, n0, n1); kEvals (8, deg, n0, n1)
  Operand a, b, c;
};

static_assert(sizeof(Operand) == 56, "Operand layout (kernels.py _Operand)");
static_assert(sizeof(Launch) == 192, "Launch layout (kernels.py _Launch)");

constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;    // 8 x 128 threads x 64 registers = one SM
constexpr int kWaves = 8;

// Launches of fewer outputs than this take one column a thread (V = 1), so
// the grid holds twice the threads; larger ones take two (V = 2).  Measured
// (`chip_smoke.py` times each launch at both): V = 1 is 9-17 % faster at
// 2^17-2^18 outputs and 2-8 % at 2^19 for the product forms; V = 2 is 1-5 %
// faster from 2^20.
constexpr uint64_t kTwoColumnsFrom = 1ull << 20;

// The V columns c0, c0 + 1, .. of row `row` of operand o (cnt of them
// inside the row; the others repeat column c0 and are never stored).
template <int V>
__device__ __forceinline__ void load(const Operand& o, uint32_t row,
                                     uint32_t c0, int cnt, uint32_t x[V][8]) {
  if (o.kind == kScalar) {
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int l = 0; l < 8; ++l) x[e][l] = o.w[l];
    return;
  }
  const uint32_t* base = (const uint32_t*)o.p;
  if (o.kind == kRow) {
    const uint32_t off = row * o.s0;
#pragma unroll
    for (int l = 0; l < 8; ++l) x[0][l] = __ldg(base + (off + l * o.sl));
#pragma unroll
    for (int e = 1; e < V; ++e)
#pragma unroll
      for (int l = 0; l < 8; ++l) x[e][l] = x[0][l];
    return;
  }
  if (V == 2 && o.kind == kVec && cnt == 2) {
    const uint32_t off = row * o.s0 + c0;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const uint2 v = __ldg((const uint2*)(base + (off + l * o.sl)));
      x[0][l] = v.x;
      x[V - 1][l] = v.y;
    }
    return;
  }
  const uint32_t off = row * o.s0 + c0 * o.s1;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const uint32_t oe = off + (e < cnt ? e : 0) * o.s1;
#pragma unroll
    for (int l = 0; l < 8; ++l) x[e][l] = __ldg(base + (oe + l * o.sl));
  }
}

// The cnt columns of x at q (limb planes `plane` words apart); vec: q and
// `plane` are even, so two columns go as one 64-bit store.
template <int V>
__device__ __forceinline__ void store(uint32_t* q, uint32_t plane, int cnt,
                                      bool vec, const uint32_t x[V][8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    if (V == 2 && vec && cnt == 2) {
      *(uint2*)(q + l * plane) = make_uint2(x[0][l], x[V - 1][l]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (e < cnt) q[l * plane + e] = x[e][l];
    }
  }
}

// One step of the forms on two operands: V columns of row `row`.
template <int OP, int V>
__device__ __forceinline__ void step_two(const Launch& L, uint32_t row,
                                         uint32_t c0, int cnt, uint32_t N,
                                         bool vec_out, uint32_t* q) {
  uint32_t x[V][8], y[V][8];
  load<V>(L.a, row, c0, cnt, x);
  load<V>(L.b, row, c0, cnt, y);
  if (OP == kEvals) {
    // X = 0 is lo; X = 2 is hi + m with m = hi - lo; each further point
    // adds m once more
    const uint32_t plane = L.deg * N;
    store<V>(q, plane, cnt, vec_out, x);
    if (L.deg < 2) return;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      fr::sub8(y[e], x[e], x[e]);
      fr::add8(y[e], x[e], y[e]);
    }
    store<V>(q + N, plane, cnt, vec_out, y);
    for (int k = 2; k < L.deg; ++k) {
#pragma unroll
      for (int e = 0; e < V; ++e) fr::add8(y[e], x[e], y[e]);
      store<V>(q + k * N, plane, cnt, vec_out, y);
    }
    return;
  }
  if (OP == kBind) {
    uint32_t r[1][8];
    load<1>(L.c, row, c0, 1, r);           // by value, or one per row
#pragma unroll
    for (int e = 0; e < V; ++e) {
      uint32_t m[8];
      fr::sub8(y[e], x[e], m);
      fr::mont_mul8(m, r[0], m);
      fr::add8(x[e], m, x[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (OP == kMul) fr::mont_mul8(x[e], y[e], x[e]);
      if (OP == kAdd) fr::add8(x[e], y[e], x[e]);
      if (OP == kSub) fr::sub8(x[e], y[e], x[e]);
    }
  }
  store<V>(q, N, cnt, vec_out, x);
}

// One step of the reduce form: column c0 of row `row`.
__device__ __forceinline__ void step_reduce(const Launch& L, uint32_t row,
                                            uint32_t c0, uint32_t N,
                                            uint32_t* q) {
  // lo + h 2^256 from the carried column sums, then mod p
  const unsigned long long* s =
      (const unsigned long long*)L.a.p + (row * L.a.s0 + c0 * L.a.s1);
  const uint32_t r1[8] = FR_R_WORDS, r2[8] = FR_R2_WORDS;
  uint32_t x[1][8], h[8];
  unsigned long long carry = 0;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const unsigned long long v = __ldg(s + l * L.a.sl) + carry;
    x[0][l] = (uint32_t)v;
    carry = v >> 32;
    h[l] = 0;
  }
  h[0] = (uint32_t)carry;
  fr::mont_mul8(x[0], r1, x[0]);           // lo mod p
  fr::mont_mul8(h, r2, h);                 // h 2^256 mod p
  fr::add8(x[0], h, x[0]);
  if (L.c.kind != kNone) {
    uint32_t y[1][8];
    load<1>(L.c, row, c0, 1, y);
    fr::mont_mul8(x[0], y[0], x[0]);
  }
  store<1>(q, N, 1, false, x);
}

template <int OP, int V>
__device__ __forceinline__ void run(const Launch& L) {
  const uint32_t n0 = L.n0, n1 = L.n1, N = n0 * n1;
  const bool vec_out = (n1 & 1u) == 0;
  const uint32_t step = gridDim.x * blockDim.x * V;
  uint32_t* out = (uint32_t*)L.out;
  for (uint32_t row = blockIdx.y; row < n0; row += gridDim.y) {
    for (uint32_t c0 = (blockIdx.x * blockDim.x + threadIdx.x) * V; c0 < n1;
         c0 += step) {
      const int cnt = n1 - c0 < (uint32_t)V ? (int)(n1 - c0) : V;
      uint32_t* q = out + (row * n1 + c0);
      if constexpr (OP == kReduce)
        step_reduce(L, row, c0, N, q);
      else
        step_two<OP, V>(L, row, c0, cnt, N, vec_out, q);
    }
  }
}

// One kernel a form and column count, so a profile names the form of each
// launch (k1_<form>_v1 / _v2; the reduce form takes one column).
#define K1_FORM(name, op, v)                                            \
  __global__ void __launch_bounds__(kThreads, kMinBlocks)               \
      name(__grid_constant__ const Launch L) {                          \
    run<op, v>(L);                                                      \
  }
K1_FORM(k1_mul_v1, kMul, 1)
K1_FORM(k1_mul_v2, kMul, 2)
K1_FORM(k1_add_v1, kAdd, 1)
K1_FORM(k1_add_v2, kAdd, 2)
K1_FORM(k1_sub_v1, kSub, 1)
K1_FORM(k1_sub_v2, kSub, 2)
K1_FORM(k1_bind_v1, kBind, 1)
K1_FORM(k1_bind_v2, kBind, 2)
K1_FORM(k1_evals_v1, kEvals, 1)
K1_FORM(k1_evals_v2, kEvals, 2)
K1_FORM(k1_reduce, kReduce, 1)
#undef K1_FORM

// Columns a thread forced for every launch (1 or 2), or 0: by size.
int forced_columns = 0;

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

}  // namespace

// sizeof(Launch), for the wrapper's check of its ctypes mirror.
extern "C" int jolt_k1_launch_size() { return (int)sizeof(Launch); }

// Forces V (1 or 2 columns a thread) for every later launch of the forms
// that take both, or with 0 lets the launch's size choose; for timing the
// choice against the other.
extern "C" void jolt_k1_force_columns(int v) { forced_columns = v; }

// Launches K1's form L->op on `stream`.  The wrapper has checked the
// operands (kinds, strides, alignment of kVec, 32-bit extents)
// and made n0 n1 > 0.  Returns cudaGetLastError() (0 on success).
extern "C" int jolt_k1(const void* launch, void* stream) {
  const Launch& L = *(const Launch*)launch;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaGetLastError();
  const uint64_t n = (uint64_t)L.n0 * L.n1;
  const int V = L.op == kReduce ? 1
                : forced_columns ? forced_columns
                : n < kTwoColumnsFrom ? 1 : 2;
  uint64_t gx = (L.n1 + (uint64_t)kThreads * V - 1) / ((uint64_t)kThreads * V);
  const uint64_t gy = L.n0 < 65535u ? L.n0 : 65535u;
  const uint64_t cap = (uint64_t)sms * kMinBlocks * kWaves;
  if (gx * gy > cap) gx = cap / gy > 0 ? cap / gy : 1;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
#define K1_CASE(op, name)                                               \
  case op:                                                              \
    if (V == 1)                                                         \
      name##_v1<<<grid, kThreads, 0, s>>>(L);                           \
    else                                                                \
      name##_v2<<<grid, kThreads, 0, s>>>(L);                           \
    break;
  switch (L.op) {
    K1_CASE(kMul, k1_mul)
    K1_CASE(kAdd, k1_add)
    K1_CASE(kSub, k1_sub)
    K1_CASE(kBind, k1_bind)
    K1_CASE(kEvals, k1_evals)
    case kReduce: k1_reduce<<<grid, kThreads, 0, s>>>(L); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef K1_CASE
  return (int)cudaGetLastError();
}
