// K3: the port's BN254 G1 kernel, Jacobian coordinates over Fq (`fq.cuh`),
// in three forms (`Form`):
//   kAdd        out = a + b, add-2007-bl (11M + 5S) with the JAX package's
//               edge handling: a at infinity -> b, b at infinity -> a,
//               same x and same y -> double(a), same x and opposite y ->
//               (0, 0, 0);
//   kDouble     out = 2a, dbl-2009-l (2M + 5S); infinity (Z = 0) stays
//               Z = 0;
//   kScalarMul  out = k a per lane, the `bits`-step MSB-first
//               double-and-add over the lane's little-endian u32 scalar
//               words, the accumulator in registers: one launch for the
//               JAX package's 254-step `fori_loop`.
// A point at infinity is Z = 0 (X and Y may hold anything).  Every
// coordinate is a normalized Fq value in Montgomery form (R = 2^256), and
// each output coordinate is the same rational function of the inputs as
// in the JAX package, so the card's limbs equal the plain versions'
// (`curve/g1.py`) bit for bit and their canonical ints the JAX package's.
//
// It replaces no Pallas kernel: it is the hand kernel for the JAX
// package's jnp G1 (its `curve/g1.py`: `jacobian_add`,
// `jacobian_double`, `batch_scalar_mul`), which runs on its rolled Fq tier.
// In torch limb arithmetic one point add would be thousands of launches.
//
// Hopper design (a first kernel: right and simple):
//   * One thread a lane, grid-stride over lanes; X, Y, Z are three
//     (8, N) int32 tensors.  Each input point is read through its own limb
//     and lane strides (`Pt`), so a halving of one tensor (`_halve`, the
//     bucket grid's stride reduction) is one launch over its two halves
//     with no copy; outputs are contiguous (8, N).
//   * The edge cases are a branch per lane instead of the JAX package's
//     compute-both-and-select: the same result, and the common lanes skip
//     the doubling.
//   * What bounds it on an H100 SXM (3.35 TB/s; 16.7 T int32 multiply-adds
//     a second; an Fq product is 272 multiply-adds): an add reads 192 B and
//     writes 96 B (86 ps a lane) and needs 16 products (261 ps a lane):
//     operations.  At 2^20 lanes: 0.09 ms of bytes, 0.27 ms of products.
//     A double needs 7 products; a scalar multiplication of `bits` bits
//     about bits x 23 when every bit is set, bits x 7 + popcount x 16 as
//     the data has it (`workload.k3_bound_ms`).
//   * No shared memory, TMA or tensor cores: each lane's work is a chain
//     of 256-bit modular products carried through every word.  Bucket
//     accumulation in shared memory and mixed affine adds are later work.

#include "fq.cuh"

namespace {

enum Form : int { kAdd = 0, kDouble = 1, kScalarMul = 2 };

// One point operand: coordinate c's limb l of lane i at
// c + (l sl + i s1) int32 elements.
struct Pt {
  unsigned long long x, y, z;
  long long sl, s1;
};

struct G1Launch {
  int form, bits;
  unsigned long long n;              // lanes
  Pt a, b;                           // kAdd: a + b; others: a
  unsigned long long words;          // kScalarMul: word w of lane i at
  long long ws;                      //   words + w ws + i
  unsigned long long ox, oy, oz;     // contiguous (8, n)
};

static_assert(sizeof(Pt) == 40, "Pt layout (curve/g1.py _Pt)");
static_assert(sizeof(G1Launch) == 136, "G1Launch layout (curve/g1.py)");

constexpr int kThreads = 128;

struct Jac {
  uint32_t x[8], y[8], z[8];
};

__device__ __forceinline__ void load(const Pt& p, unsigned long long i,
                                     Jac& out) {
  const uint32_t* X = (const uint32_t*)p.x;
  const uint32_t* Y = (const uint32_t*)p.y;
  const uint32_t* Z = (const uint32_t*)p.z;
  const long long base = (long long)i * p.s1;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const long long off = base + l * p.sl;
    out.x[l] = __ldg(X + off);
    out.y[l] = __ldg(Y + off);
    out.z[l] = __ldg(Z + off);
  }
}

__device__ __forceinline__ void store(const G1Launch& L, unsigned long long i,
                                      const Jac& r) {
  uint32_t* X = (uint32_t*)L.ox;
  uint32_t* Y = (uint32_t*)L.oy;
  uint32_t* Z = (uint32_t*)L.oz;
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    X[l * L.n + i] = r.x[l];
    Y[l * L.n + i] = r.y[l];
    Z[l * L.n + i] = r.z[l];
  }
}

__device__ __forceinline__ void copy8(const uint32_t a[8], uint32_t o[8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l) o[l] = a[l];
}

// dbl-2009-l: A = X^2, B = Y^2, C = B^2, D = 2((X + B)^2 - A - C),
// E = 3A, F = E^2, X3 = F - 2D, Y3 = E (D - X3) - 8C, Z3 = 2 Y Z.
// o may alias p.
__device__ __noinline__ void dbl(const Jac& p, Jac& o) {
  uint32_t a[8], b[8], c[8], d[8], e[8], t[8], x3[8], y3[8], z3[8];
  fq::mont_mul8(p.x, p.x, a);
  fq::mont_mul8(p.y, p.y, b);
  fq::mont_mul8(b, b, c);
  fq::add8(p.x, b, t);
  fq::mont_mul8(t, t, t);
  fq::sub8(t, a, t);
  fq::sub8(t, c, t);
  fq::add8(t, t, d);
  fq::add8(a, a, e);
  fq::add8(e, a, e);
  fq::mont_mul8(e, e, t);                  // F
  fq::sub8(t, d, t);
  fq::sub8(t, d, x3);
  fq::sub8(d, x3, t);
  fq::mont_mul8(e, t, t);
  fq::add8(c, c, c);
  fq::add8(c, c, c);
  fq::add8(c, c, c);                       // 8C
  fq::sub8(t, c, y3);
  fq::mont_mul8(p.y, p.z, z3);
  fq::add8(z3, z3, z3);
  copy8(x3, o.x);
  copy8(y3, o.y);
  copy8(z3, o.z);
}

// add-2007-bl with the JAX package's edge handling (see the top).
// o may alias p or q.
__device__ __noinline__ void add(const Jac& p, const Jac& q, Jac& o) {
  if (fq::is_zero8(p.z)) {
    copy8(q.x, o.x);
    copy8(q.y, o.y);
    copy8(q.z, o.z);
    return;
  }
  if (fq::is_zero8(q.z)) {
    copy8(p.x, o.x);
    copy8(p.y, o.y);
    copy8(p.z, o.z);
    return;
  }
  uint32_t z1z1[8], z2z2[8], u1[8], u2[8], s1[8], s2[8], h[8], rr[8];
  fq::mont_mul8(p.z, p.z, z1z1);
  fq::mont_mul8(q.z, q.z, z2z2);
  fq::mont_mul8(p.x, z2z2, u1);
  fq::mont_mul8(q.x, z1z1, u2);
  fq::mont_mul8(p.y, q.z, s1);
  fq::mont_mul8(s1, z2z2, s1);
  fq::mont_mul8(q.y, p.z, s2);
  fq::mont_mul8(s2, z1z1, s2);
  fq::sub8(u2, u1, h);
  fq::sub8(s2, s1, rr);
  fq::add8(rr, rr, rr);
  if (fq::is_zero8(h)) {
    if (fq::is_zero8(rr)) {
      dbl(p, o);
    } else {
#pragma unroll
      for (int l = 0; l < 8; ++l) o.x[l] = o.y[l] = o.z[l] = 0;
    }
    return;
  }
  uint32_t i4[8], j[8], v[8], t[8], x3[8], y3[8], z3[8];
  fq::add8(h, h, i4);
  fq::mont_mul8(i4, i4, i4);               // I = (2H)^2
  fq::mont_mul8(h, i4, j);                 // J = H I
  fq::mont_mul8(u1, i4, v);                // V = U1 I
  fq::mont_mul8(rr, rr, t);
  fq::sub8(t, j, t);
  fq::sub8(t, v, t);
  fq::sub8(t, v, x3);                      // X3 = rr^2 - J - 2V
  fq::sub8(v, x3, t);
  fq::mont_mul8(rr, t, t);
  fq::mont_mul8(s1, j, s1);
  fq::add8(s1, s1, s1);
  fq::sub8(t, s1, y3);                     // Y3 = rr (V - X3) - 2 S1 J
  fq::add8(p.z, q.z, t);
  fq::mont_mul8(t, t, t);
  fq::sub8(t, z1z1, t);
  fq::sub8(t, z2z2, t);
  fq::mont_mul8(t, h, z3);                 // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  copy8(x3, o.x);
  copy8(y3, o.y);
  copy8(z3, o.z);
}

__global__ void __launch_bounds__(kThreads)
    k3_add(__grid_constant__ const G1Launch L) {
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < L.n; i += (unsigned long long)gridDim.x * blockDim.x) {
    Jac p, q;
    load(L.a, i, p);
    load(L.b, i, q);
    add(p, q, p);
    store(L, i, p);
  }
}

__global__ void __launch_bounds__(kThreads)
    k3_double(__grid_constant__ const G1Launch L) {
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < L.n; i += (unsigned long long)gridDim.x * blockDim.x) {
    Jac p;
    load(L.a, i, p);
    dbl(p, p);
    store(L, i, p);
  }
}

// The JAX package's body: acc = double(acc); acc = acc + (bit ? P : P with
// Z = 0) -- the masked point keeps its X and Y, which the add returns when
// acc is at infinity.
__global__ void __launch_bounds__(kThreads)
    k3_scalar_mul(__grid_constant__ const G1Launch L) {
  const uint32_t* W = (const uint32_t*)L.words;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < L.n; i += (unsigned long long)gridDim.x * blockDim.x) {
    Jac p, m, acc;
    load(L.a, i, p);
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      acc.x[l] = acc.y[l] = acc.z[l] = 0;
      m.x[l] = p.x[l];
      m.y[l] = p.y[l];
    }
    for (int k = L.bits - 1; k >= 0; --k) {
      dbl(acc, acc);
      const uint32_t w = __ldg(W + ((long long)(k >> 5) * L.ws + (long long)i));
      const bool bit = (w >> (k & 31)) & 1u;
#pragma unroll
      for (int l = 0; l < 8; ++l) m.z[l] = bit ? p.z[l] : 0u;
      add(acc, m, acc);
    }
    store(L, i, acc);
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

}  // namespace

// sizeof(G1Launch), for the wrapper's check of its ctypes mirror.
extern "C" int jolt_k3_launch_size() { return (int)sizeof(G1Launch); }

// Launches K3's form L->form on `stream`.  The wrapper has checked the
// operands (shapes, strides, n > 0).  Returns cudaGetLastError() (0 on
// success).
extern "C" int jolt_k3(const void* launch, void* stream) {
  const G1Launch& L = *(const G1Launch*)launch;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaGetLastError();
  unsigned long long blocks = (L.n + kThreads - 1) / kThreads;
  const unsigned long long cap = (unsigned long long)sms * 64;
  if (blocks > cap) blocks = cap;
  cudaStream_t s = (cudaStream_t)stream;
  switch (L.form) {
    case kAdd: k3_add<<<(unsigned)blocks, kThreads, 0, s>>>(L); break;
    case kDouble: k3_double<<<(unsigned)blocks, kThreads, 0, s>>>(L); break;
    case kScalarMul:
      k3_scalar_mul<<<(unsigned)blocks, kThreads, 0, s>>>(L);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
