// K3: the port's BN254 G1 kernel, Jacobian coordinates over Fq (`fq.cuh`),
// in six forms:
//   kAdd          out = a + b, add-2007-bl (11M + 5S) with the JAX
//                 package's edge handling: a at infinity -> b, b at
//                 infinity -> a, same x and same y -> double(a), same x and
//                 opposite y -> (0, 0, 0);
//   kDouble       out = 2a, dbl-2009-l (2M + 5S); infinity (Z = 0) stays
//                 Z = 0;
//   kScalarMul    out = k a per lane, the `bits`-step MSB-first
//                 double-and-add over the lane's little-endian u32 scalar
//                 words, the accumulator in registers: one launch for the
//                 JAX package's 254-step `fori_loop`;
//   kNormalize    Jacobian -> affine per lane, Z = Montgomery one (R mod
//                 q), infinity -> (0, 0, 0): Z^-1 = Z^(q-2) by
//                 square-and-multiply (253 squarings, 109 products);
//   bucket_sum    (`jolt_k3_bucket_sum`) one level of segment sums: each
//                 thread adds one chunk of a segment's consecutive entries
//                 (the wrapper's table: at most 32 at level 0, 8 above)
//                 from infinity, left to right --
//                 level 0 gathers affine bases through a lane list with
//                 mixed adds (madd-2007-bl, 7M + 4S), later levels add the
//                 Jacobian partials of the level before with the add above;
//   bucket_reduce (`jolt_k3_bucket_reduce`) sum_w 2^(c w) sum_k k B_{w,k}
//                 over the (n_win, 2^c) bucket sums in one launch: a block
//                 a window (chunked running sums, a suffix scan and two
//                 tree sums in shared memory), then the last block to
//                 finish combines the windows (Horner, the top first).
// A point at infinity is Z = 0 (X and Y may hold anything); an affine base
// is (X, Y) with Z = R, (0, 0) for infinity (not a curve point: y^2 = x^3
// + 3).  Every coordinate is a normalized Fq value in Montgomery form
// (R = 2^256), and each output coordinate is the same rational function of
// the inputs as in the plain versions (`curve/g1.py`), so the card's limbs
// equal theirs bit for bit.  A mixed add equals the generic add of the
// same points with Z2 = R as field values, coordinate by coordinate.
//
// It replaces no Pallas kernel: it is the hand kernel for the JAX
// package's jnp G1 (its `curve/g1.py`: `jacobian_add`,
// `jacobian_double`, `batch_scalar_mul`, `msm_pippenger`), which runs on
// its rolled Fq tier.
//
// Hopper design:
//   * Every formula is inlined on register arrays: no point goes through
//     a stack frame (ptxas: 0 bytes of stack and of spills in every
//     kernel).
//   * One thread a lane (a chunk, a window's bucket slice), grid-stride;
//     X, Y, Z are three (8, N) int32 tensors.  An operand of the
//     elementwise forms is read through its own limb and lane strides
//     (`Pt`), so a halving of one tensor is one launch over its two halves
//     with no copy; outputs are contiguous (8, N).  Small launches take
//     smaller blocks, so that more SMs get a warp.
//   * Affine bases are gathered point-major, (N, 16) words: a base is four
//     16-byte loads, two sectors, wherever the lane list points.
//   * The edge cases are a branch per lane instead of the JAX package's
//     compute-both-and-select: the same result, and the common lanes skip
//     the doubling.
//   * What bounds it on an H100 SXM (3.35 TB/s; 16.7 T int32 multiply-adds
//     a second; an Fq product is 272 multiply-adds): the products --
//     16 a generic add, 11 a mixed add, 7 a double, ~366 a normalization
//     (`workload.k3_bound_ms`).
//   * No TMA or tensor cores: each lane's work is a chain of 256-bit
//     modular products carried through every word.

#include "fq.cuh"

namespace {

enum Form : int { kAdd = 0, kDouble = 1, kScalarMul = 2, kNormalize = 3 };

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
// the most bucket-reduce threads a window (a power of two; `curve/g1.py`
// `_REDUCE_THREADS`): two shared Jacobian points each, 48 KiB
constexpr int kReduceThreads = 256;

struct Jac {
  uint32_t x[8], y[8], z[8];
};

__device__ __forceinline__ void copy8(const uint32_t a[8], uint32_t o[8]) {
#pragma unroll
  for (int l = 0; l < 8; ++l) o[l] = a[l];
}

__device__ __forceinline__ void set_infinity(Jac& o) {
#pragma unroll
  for (int l = 0; l < 8; ++l) o.x[l] = o.y[l] = o.z[l] = 0;
}

__device__ __forceinline__ void load_pt(const Pt& p, unsigned long long i,
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

// lane i of three contiguous (8, n) tensors
__device__ __forceinline__ void load_soa(const uint32_t* X, const uint32_t* Y,
                                         const uint32_t* Z,
                                         unsigned long long n,
                                         unsigned long long i, Jac& out) {
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    out.x[l] = __ldcg(X + l * n + i);
    out.y[l] = __ldcg(Y + l * n + i);
    out.z[l] = __ldcg(Z + l * n + i);
  }
}

__device__ __forceinline__ void store_soa(uint32_t* X, uint32_t* Y,
                                          uint32_t* Z, unsigned long long n,
                                          unsigned long long i,
                                          const Jac& r) {
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    X[l * n + i] = r.x[l];
    Y[l * n + i] = r.y[l];
    Z[l * n + i] = r.z[l];
  }
}

// dbl-2009-l: A = X^2, B = Y^2, C = B^2, D = 2((X + B)^2 - A - C),
// E = 3A, F = E^2, X3 = F - 2D, Y3 = E (D - X3) - 8C, Z3 = 2 Y Z.
// In place.
__device__ __forceinline__ void dbl(Jac& p) {
  uint32_t a[8], b[8], c[8], d[8], e[8], t[8];
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
  fq::mont_mul8(p.y, p.z, p.z);            // Z3 = 2 Y Z (Y still old)
  fq::add8(p.z, p.z, p.z);
  fq::mont_mul8(e, e, t);                  // F
  fq::sub8(t, d, t);
  fq::sub8(t, d, p.x);                     // X3 = F - 2D
  fq::sub8(d, p.x, t);
  fq::mont_mul8(e, t, t);
  fq::add8(c, c, c);
  fq::add8(c, c, c);
  fq::add8(c, c, c);                       // 8C
  fq::sub8(t, c, p.y);                     // Y3 = E (D - X3) - 8C
}

// p = p + q: add-2007-bl with the JAX package's edge handling (see the
// top).
__device__ __forceinline__ void add(Jac& p, const Jac& q) {
  if (fq::is_zero8(p.z)) {
    copy8(q.x, p.x);
    copy8(q.y, p.y);
    copy8(q.z, p.z);
    return;
  }
  if (fq::is_zero8(q.z)) return;
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
    if (fq::is_zero8(rr))
      dbl(p);
    else
      set_infinity(p);
    return;
  }
  uint32_t i4[8], j[8], v[8], t[8];
  fq::add8(h, h, i4);
  fq::mont_mul8(i4, i4, i4);               // I = (2H)^2
  fq::mont_mul8(h, i4, j);                 // J = H I
  fq::mont_mul8(u1, i4, v);                // V = U1 I
  fq::add8(p.z, q.z, t);
  fq::mont_mul8(t, t, t);
  fq::sub8(t, z1z1, t);
  fq::sub8(t, z2z2, t);
  fq::mont_mul8(t, h, p.z);                // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H
  fq::mont_mul8(rr, rr, t);
  fq::sub8(t, j, t);
  fq::sub8(t, v, t);
  fq::sub8(t, v, p.x);                     // X3 = rr^2 - J - 2V
  fq::sub8(v, p.x, t);
  fq::mont_mul8(rr, t, t);
  fq::mont_mul8(s1, j, s1);
  fq::add8(s1, s1, s1);
  fq::sub8(t, s1, p.y);                    // Y3 = rr (V - X3) - 2 S1 J
}

// p = p + (qx, qy, R), or p itself when q is infinity: madd-2007-bl with
// the same edge handling (p at infinity -> (qx, qy, R), or (0, 0, 0) for
// an infinite q).
__device__ __forceinline__ void madd(Jac& p, const uint32_t qx[8],
                                     const uint32_t qy[8], bool q_inf) {
  if (fq::is_zero8(p.z)) {
    const uint32_t one[8] = FQ_R_WORDS;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      p.x[l] = qx[l];
      p.y[l] = qy[l];
      p.z[l] = q_inf ? 0u : one[l];
    }
    return;
  }
  if (q_inf) return;
  uint32_t z1z1[8], u2[8], s2[8], h[8], rr[8];
  fq::mont_mul8(p.z, p.z, z1z1);
  fq::mont_mul8(qx, z1z1, u2);
  fq::mont_mul8(qy, p.z, s2);
  fq::mont_mul8(s2, z1z1, s2);
  fq::sub8(u2, p.x, h);
  fq::sub8(s2, p.y, rr);
  fq::add8(rr, rr, rr);
  if (fq::is_zero8(h)) {
    if (fq::is_zero8(rr))
      dbl(p);
    else
      set_infinity(p);
    return;
  }
  uint32_t hh[8], i4[8], j[8], v[8], t[8];
  fq::mont_mul8(h, h, hh);
  fq::add8(hh, hh, i4);
  fq::add8(i4, i4, i4);                    // I = 4 HH
  fq::mont_mul8(h, i4, j);                 // J = H I
  fq::mont_mul8(p.x, i4, v);               // V = X1 I
  fq::add8(p.z, h, t);
  fq::mont_mul8(t, t, t);
  fq::sub8(t, z1z1, t);
  fq::sub8(t, hh, p.z);                    // Z3 = (Z1 + H)^2 - Z1Z1 - HH
  fq::mont_mul8(rr, rr, t);
  fq::sub8(t, j, t);
  fq::sub8(t, v, t);
  fq::sub8(t, v, t);                       // X3 = rr^2 - J - 2V
  fq::sub8(v, t, v);
  fq::mont_mul8(rr, v, v);
  fq::mont_mul8(p.y, j, j);
  fq::add8(j, j, j);
  fq::sub8(v, j, p.y);                     // Y3 = rr (V - X3) - 2 Y1 J
  copy8(t, p.x);
}

#define GRID_STRIDE(i, n)                                                  \
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + \
                              threadIdx.x;                                 \
       i < (n); i += (unsigned long long)gridDim.x * blockDim.x)

__global__ void __launch_bounds__(kThreads)
    k3_add(__grid_constant__ const G1Launch L) {
  GRID_STRIDE(i, L.n) {
    Jac p, q;
    load_pt(L.a, i, p);
    load_pt(L.b, i, q);
    add(p, q);
    store_soa((uint32_t*)L.ox, (uint32_t*)L.oy, (uint32_t*)L.oz, L.n, i, p);
  }
}

__global__ void __launch_bounds__(kThreads)
    k3_double(__grid_constant__ const G1Launch L) {
  GRID_STRIDE(i, L.n) {
    Jac p;
    load_pt(L.a, i, p);
    dbl(p);
    store_soa((uint32_t*)L.ox, (uint32_t*)L.oy, (uint32_t*)L.oz, L.n, i, p);
  }
}

// The JAX package's body: acc = double(acc); acc = acc + (bit ? P : P with
// Z = 0) -- the masked point keeps its X and Y, which the add returns when
// acc is at infinity.
__global__ void __launch_bounds__(kThreads)
    k3_scalar_mul(__grid_constant__ const G1Launch L) {
  const uint32_t* W = (const uint32_t*)L.words;
  GRID_STRIDE(i, L.n) {
    Jac p, m, acc;
    load_pt(L.a, i, p);
    set_infinity(acc);
    copy8(p.x, m.x);
    copy8(p.y, m.y);
    for (int k = L.bits - 1; k >= 0; --k) {
      dbl(acc);
      const uint32_t w = __ldg(W + ((long long)(k >> 5) * L.ws + (long long)i));
      const bool bit = (w >> (k & 31)) & 1u;
#pragma unroll
      for (int l = 0; l < 8; ++l) m.z[l] = bit ? p.z[l] : 0u;
      add(acc, m);
    }
    store_soa((uint32_t*)L.ox, (uint32_t*)L.oy, (uint32_t*)L.oz, L.n, i, acc);
  }
}

// Z^-1 in Montgomery form: Z^(q - 2) from the top bit down, acc = acc^2,
// then acc = acc Z where the exponent's bit is set (from acc = Z at the
// top bit).
__global__ void __launch_bounds__(kThreads)
    k3_normalize(__grid_constant__ const G1Launch L) {
  GRID_STRIDE(i, L.n) {
    Jac p;
    load_pt(L.a, i, p);
    if (fq::is_zero8(p.z)) {
      set_infinity(p);
    } else {
      const uint32_t e[8] = {0xd87cfd45u, 0x3c208c16u, 0x6871ca8du,
                             0x97816a91u, 0x8181585du, 0xb85045b6u,
                             0xe131a029u, 0x30644e72u};   // q - 2
      uint32_t inv[8], t[8];
      copy8(p.z, inv);
      // the exponent's words are constants after unrolling the word loop,
      // so no array is indexed at run time (no stack frame)
#pragma unroll
      for (int wi = 7; wi >= 0; --wi) {
        const uint32_t word = e[wi];
#pragma unroll 1
        for (int b = wi == 7 ? 28 : 31; b >= 0; --b) {
          fq::mont_mul8(inv, inv, inv);
          if ((word >> b) & 1u) fq::mont_mul8(inv, p.z, inv);
        }
      }
      fq::mont_mul8(inv, inv, t);          // Z^-2
      fq::mont_mul8(p.x, t, p.x);
      fq::mont_mul8(t, inv, t);            // Z^-3
      fq::mont_mul8(p.y, t, p.y);
      const uint32_t one[8] = FQ_R_WORDS;
      copy8(one, p.z);
    }
    store_soa((uint32_t*)L.ox, (uint32_t*)L.oy, (uint32_t*)L.oz, L.n, i, p);
  }
}

// One level of bucket sums: chunk t adds the entries [beg[t], end[t]) from
// infinity, left to right -- the affine bases at lanes[j] (point-major
// (N, 16) words) with mixed adds, or the Jacobian partials j of the level
// before (three contiguous (8, m) tensors) with generic adds.
struct BucketLaunch {
  unsigned long long bases;          // kAffine: (N, 16) uint32
  unsigned long long lanes;          // kAffine: int32 lane per entry
  unsigned long long px, py, pz;     // !kAffine: (8, m) partials
  long long m;
  unsigned long long beg, end;       // int64 per chunk
  long long n;                       // chunks
  unsigned long long ox, oy, oz;     // contiguous (8, n)
};

static_assert(sizeof(BucketLaunch) == 96, "BucketLaunch (curve/g1.py)");

template <bool kAffine>
__global__ void __launch_bounds__(kThreads)
    k3_bucket_sum(__grid_constant__ const BucketLaunch L) {
  const long long* beg = (const long long*)L.beg;
  const long long* end = (const long long*)L.end;
  GRID_STRIDE(t, (unsigned long long)L.n) {
    Jac acc;
    set_infinity(acc);
    const long long e = __ldg(end + t);
    for (long long j = __ldg(beg + t); j < e; ++j) {
      if (kAffine) {
        const int lane = __ldg((const int*)L.lanes + j);
        const uint4* row = (const uint4*)L.bases + 4ll * lane;
        uint32_t qx[8], qy[8];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const uint4 w = __ldg(row + v);
          uint32_t* dst = v < 2 ? qx + 4 * v : qy + 4 * (v - 2);
          dst[0] = w.x;
          dst[1] = w.y;
          dst[2] = w.z;
          dst[3] = w.w;
        }
        uint32_t any = 0;
#pragma unroll
        for (int l = 0; l < 8; ++l) any |= qx[l] | qy[l];
        madd(acc, qx, qy, any == 0);
      } else {
        Jac q;
        load_soa((const uint32_t*)L.px, (const uint32_t*)L.py,
                 (const uint32_t*)L.pz, (unsigned long long)L.m,
                 (unsigned long long)j, q);
        add(acc, q);
      }
    }
    store_soa((uint32_t*)L.ox, (uint32_t*)L.oy, (uint32_t*)L.oz,
              (unsigned long long)L.n, t, acc);
  }
}

// sum_w 2^(c w) sum_k k B_{w,k} (`curve/g1.py` `bucket_reduce_plain`
// spells out the same steps).  Block w, thread i of m (m a power of two,
// s = 2^c / m buckets a thread, k in [i s, i s + s)):
//   1. from the top bucket down: run += B_k, tot += run, except that the
//      bottom bucket only enters run: S_i = run = sum B_k,
//      T_i = tot = sum (k - i s) B_k;
//   2. G_i = sum_{j >= i} S_j by a Hillis-Steele suffix scan (step d:
//      G_i += G_{i+d});
//   3. U = sum_{i >= 1} G_i and V = sum_i T_i, tree sums (step h:
//      x_i += x_{i+h}, h = m/2 .. 1);
//   4. thread 0: W_w = V + 2^log2(s) U  (sum_k k B_k = V + s sum_i i S_i).
// The last block to finish (a ticket on `counter`, zeroed by the caller)
// combines: acc = W_top; acc = 2^c acc + W_w for the windows below.
struct ReduceLaunch {
  unsigned long long bx, by, bz;     // (8, n_win 2^c) contiguous
  unsigned long long wx, wy, wz;     // (8, n_win) scratch
  unsigned long long ox, oy, oz;     // (8, 1)
  unsigned long long counter;        // int32, 0
  int n_win, c, m, log_s;
};

static_assert(sizeof(ReduceLaunch) == 96, "ReduceLaunch (curve/g1.py)");

__device__ __forceinline__ void load_jac_shared(const Jac* s, Jac& o) {
  copy8(s->x, o.x);
  copy8(s->y, o.y);
  copy8(s->z, o.z);
}

__device__ __forceinline__ void store_jac_shared(Jac* s, const Jac& p) {
  copy8(p.x, s->x);
  copy8(p.y, s->y);
  copy8(p.z, s->z);
}

__global__ void __launch_bounds__(kReduceThreads)
    k3_bucket_reduce(__grid_constant__ const ReduceLaunch L) {
  __shared__ Jac sg[kReduceThreads], st[kReduceThreads];
  const int w = blockIdx.x, i = threadIdx.x, m = L.m;
  const unsigned long long nb = (unsigned long long)L.n_win << L.c;
  const uint32_t* BX = (const uint32_t*)L.bx;
  const uint32_t* BY = (const uint32_t*)L.by;
  const uint32_t* BZ = (const uint32_t*)L.bz;
  const unsigned long long a = ((unsigned long long)w << L.c) +
                               ((unsigned long long)i << L.log_s);
  const int s = 1 << L.log_s;
  Jac run, tot, b;
  set_infinity(run);
  set_infinity(tot);
  for (int k = s - 1; k >= 1; --k) {
    load_soa(BX, BY, BZ, nb, a + k, b);
    add(run, b);
    add(tot, run);
  }
  load_soa(BX, BY, BZ, nb, a, b);
  add(run, b);
  store_jac_shared(&sg[i], run);
  store_jac_shared(&st[i], tot);
  __syncthreads();
  for (int d = 1; d < m; d <<= 1) {
    Jac g, h;
    const bool live = i + d < m;
    if (live) {
      load_jac_shared(&sg[i], g);
      load_jac_shared(&sg[i + d], h);
    }
    __syncthreads();
    if (live) {
      add(g, h);
      store_jac_shared(&sg[i], g);
    }
    __syncthreads();
  }
  if (i == 0) {
    Jac inf;
    set_infinity(inf);
    store_jac_shared(&sg[0], inf);
  }
  __syncthreads();
  for (int h = m >> 1; h >= 1; h >>= 1) {
    if (i < h) {
      Jac x, y;
      load_jac_shared(&sg[i], x);
      load_jac_shared(&sg[i + h], y);
      add(x, y);
      store_jac_shared(&sg[i], x);
      load_jac_shared(&st[i], x);
      load_jac_shared(&st[i + h], y);
      add(x, y);
      store_jac_shared(&st[i], x);
    }
    __syncthreads();
  }
  if (i == 0) {
    Jac u, v;
    load_jac_shared(&sg[0], u);
    load_jac_shared(&st[0], v);
    for (int k = 0; k < L.log_s; ++k) dbl(u);
    add(v, u);
    store_soa((uint32_t*)L.wx, (uint32_t*)L.wy, (uint32_t*)L.wz,
              (unsigned long long)L.n_win, w, v);
    __threadfence();
  }
  if (i != 0 || atomicAdd((int*)L.counter, 1) != L.n_win - 1) return;
  __threadfence();
  const unsigned long long nw = (unsigned long long)L.n_win;
  Jac acc, x;
  load_soa((const uint32_t*)L.wx, (const uint32_t*)L.wy,
           (const uint32_t*)L.wz, nw, nw - 1, acc);
  for (int v = L.n_win - 2; v >= 0; --v) {
    for (int k = 0; k < L.c; ++k) dbl(acc);
    load_soa((const uint32_t*)L.wx, (const uint32_t*)L.wy,
             (const uint32_t*)L.wz, nw, v, x);
    add(acc, x);
  }
  store_soa((uint32_t*)L.ox, (uint32_t*)L.oy, (uint32_t*)L.oz, 1, 0, acc);
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

// Blocks and threads for n lanes: kThreads a block, halved down to one
// warp while that leaves SMs without a block; at most 64 blocks an SM.
bool grid_for(unsigned long long n, unsigned* blocks, int* threads) {
  const int sms = sm_count();
  if (sms == 0) return false;
  int t = kThreads;
  while (t > 32 && (n + t - 1) / t < (unsigned long long)sms) t >>= 1;
  unsigned long long b = (n + t - 1) / t;
  const unsigned long long cap = (unsigned long long)sms * 64;
  *blocks = (unsigned)(b > cap ? cap : b);
  *threads = t;
  return true;
}

}  // namespace

// sizeof(G1Launch), for the wrapper's check of its ctypes mirror.
extern "C" int jolt_k3_launch_size() { return (int)sizeof(G1Launch); }

// sizeof(BucketLaunch) * 1000 + sizeof(ReduceLaunch), likewise.
extern "C" int jolt_k3_bucket_sizes() {
  return (int)(sizeof(BucketLaunch) * 1000 + sizeof(ReduceLaunch));
}

// Launches K3's form L->form on `stream`.  The wrapper has checked the
// operands (shapes, strides, n > 0).  Returns cudaGetLastError() (0 on
// success).
extern "C" int jolt_k3(const void* launch, void* stream) {
  const G1Launch& L = *(const G1Launch*)launch;
  unsigned blocks;
  int threads;
  if (!grid_for(L.n, &blocks, &threads)) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (L.form) {
    case kAdd: k3_add<<<blocks, threads, 0, s>>>(L); break;
    case kDouble: k3_double<<<blocks, threads, 0, s>>>(L); break;
    case kScalarMul: k3_scalar_mul<<<blocks, threads, 0, s>>>(L); break;
    case kNormalize: k3_normalize<<<blocks, threads, 0, s>>>(L); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One level of bucket sums (`k3_bucket_sum`); affine != 0 for level 0.
extern "C" int jolt_k3_bucket_sum(const void* launch, int affine,
                                  void* stream) {
  const BucketLaunch& L = *(const BucketLaunch*)launch;
  unsigned blocks;
  int threads;
  if (!grid_for((unsigned long long)L.n, &blocks, &threads))
    return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (affine)
    k3_bucket_sum<true><<<blocks, threads, 0, s>>>(L);
  else
    k3_bucket_sum<false><<<blocks, threads, 0, s>>>(L);
  return (int)cudaGetLastError();
}

// The bucket reduction (`k3_bucket_reduce`): n_win blocks of m threads.
extern "C" int jolt_k3_bucket_reduce(const void* launch, void* stream) {
  const ReduceLaunch& L = *(const ReduceLaunch*)launch;
  if (L.m < 1 || L.m > kReduceThreads || (L.m & (L.m - 1)) ||
      (L.m << L.log_s) != (1 << L.c) || L.n_win < 1)
    return (int)cudaErrorInvalidValue;
  k3_bucket_reduce<<<L.n_win, L.m, 0, (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
}
