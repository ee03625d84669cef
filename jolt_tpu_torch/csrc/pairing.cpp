// BN254 pairing in C++ (host runtime component).
//
// Copied from the JAX package's native pairing library, unchanged but for
// this header; the port builds it into jolt_tpu_torch/_build/ at first use
// (curve/native_pairing.py).
//
// Exact mirror of curve/pairing.py + fq_tower.py: the same tower
// (Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - (9+u)), Fq12 = Fq6[w]/(w^2-v)),
// the same Tate Miller loop and line function, so every GT element is
// byte-identical to the Python oracle (transcripts absorb GT bytes; the two
// tiers must agree bit-for-bit).  The Python tier remains the semantic
// oracle (tests/test_torch_dory.py); this library is the production
// path for Dory tier-2 commits / reduce rounds and verifier GT algebra,
// where the reference leans on optimized arkworks pairings
// (crates/jolt-dory/src/routines.rs).
//
// Arithmetic: 4x64-bit CIOS Montgomery multiplication over Fq via
// unsigned __int128; generic big exponents arrive as little-endian byte
// strings from Python (no bignum library needed).
//
// ABI (all buffers little-endian 32-byte canonical Fq components):
//   g1 point  = 64B  (x, y)
//   g2 point  = 128B (x.a, x.b, y.a, y.b)
//   fq12      = 384B (c0.c0.a, c0.c0.b, c0.c1.a, .., c1.c2.b)

#include <cstdint>
#include <atomic>
#include <cstring>
#include <thread>
#include <vector>

typedef uint64_t u64;
typedef unsigned __int128 u128;

static const u64 QL[4] = {0x3c208c16d87cfd47ull, 0x97816a916871ca8dull,
                          0xb85045b68181585dull, 0x30644e72e131a029ull};
static const u64 R2L[4] = {0xf32cfc5b538afa89ull, 0xb5e71911d44501fbull,
                           0x47ab1eff0a417ff6ull, 0x06d89f71cab8351full};
static const u64 ONEM[4] = {0xd35d438dc58f0d9dull, 0x0a78eb28f5c70b3dull,
                            0x666ea36f7879462cull, 0x0e0a77c19a07df2full};
static const u64 N0 = 0x87d20782e4866389ull;

struct Fq { u64 l[4]; };

static inline Fq fq_zero() { Fq r; r.l[0]=r.l[1]=r.l[2]=r.l[3]=0; return r; }
static inline bool fq_is_zero(const Fq& a) {
  return !(a.l[0]|a.l[1]|a.l[2]|a.l[3]);
}
static inline bool fq_eq(const Fq& a, const Fq& b) {
  return a.l[0]==b.l[0] && a.l[1]==b.l[1] && a.l[2]==b.l[2] && a.l[3]==b.l[3];
}
static inline bool geq_q(const u64 a[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] > QL[i]) return true;
    if (a[i] < QL[i]) return false;
  }
  return true;  // equal
}
static inline void sub_q(u64 a[4]) {
  u128 bor = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - QL[i] - bor;
    a[i] = (u64)d;
    bor = (d >> 64) & 1;
  }
}
static inline Fq fq_add(const Fq& a, const Fq& b) {
  Fq r; u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.l[i] + b.l[i] + c;
    r.l[i] = (u64)s; c = s >> 64;
  }
  if (c || geq_q(r.l)) sub_q(r.l);
  return r;
}
static inline Fq fq_sub(const Fq& a, const Fq& b) {
  Fq r; u128 bor = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.l[i] - b.l[i] - bor;
    r.l[i] = (u64)d; bor = (d >> 64) & 1;
  }
  if (bor) {  // add q back
    u128 c = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)r.l[i] + QL[i] + c;
      r.l[i] = (u64)s; c = s >> 64;
    }
  }
  return r;
}
static inline Fq fq_neg(const Fq& a) {
  if (fq_is_zero(a)) return a;
  Fq q; memcpy(q.l, QL, sizeof(QL));
  return fq_sub(q, a);
}

// CIOS Montgomery multiplication
static Fq fq_mul(const Fq& a, const Fq& b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 c = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)t[j] + (u128)a.l[i] * b.l[j] + c;
      t[j] = (u64)s; c = s >> 64;
    }
    u128 s = (u128)t[4] + c;
    t[4] = (u64)s; t[5] = (u64)(s >> 64);
    u64 m = t[0] * N0;
    c = ((u128)t[0] + (u128)m * QL[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)t[j] + (u128)m * QL[j] + c;
      t[j - 1] = (u64)s2; c = s2 >> 64;
    }
    s = (u128)t[4] + c;
    t[3] = (u64)s;
    t[4] = t[5] + (u64)(s >> 64);
    t[5] = 0;
  }
  Fq r;
  memcpy(r.l, t, 32);
  if (t[4] || geq_q(r.l)) sub_q(r.l);
  return r;
}
static inline Fq fq_sqr(const Fq& a) { return fq_mul(a, a); }

static Fq fq_from_canonical(const u64 l[4]) {
  Fq a; memcpy(a.l, l, 32);
  Fq r2; memcpy(r2.l, R2L, 32);
  return fq_mul(a, r2);
}
static void fq_to_canonical(const Fq& a, u64 out[4]) {
  Fq one = fq_zero(); one.l[0] = 1;   // plain 1 (not Montgomery)
  Fq c = fq_mul(a, one);
  memcpy(out, c.l, 32);
}
static Fq fq_one() { Fq r; memcpy(r.l, ONEM, 32); return r; }

// generic pow with little-endian byte exponent
static Fq fq_pow_bytes(const Fq& a, const uint8_t* e, size_t n) {
  Fq acc = fq_one();
  // MSB-first
  int started = 0;
  for (size_t bi = n; bi-- > 0;) {
    for (int bit = 7; bit >= 0; --bit) {
      if (started) acc = fq_sqr(acc);
      if ((e[bi] >> bit) & 1) {
        if (!started) { acc = a; started = 1; }
        else acc = fq_mul(acc, a);
      }
    }
  }
  return acc;
}
// 4-limb helpers for the binary extended GCD
static inline bool limbs_is_zero(const u64 a[4]) {
  return !(a[0] | a[1] | a[2] | a[3]);
}
static inline bool limbs_is_one(const u64 a[4]) {
  return a[0] == 1 && !(a[1] | a[2] | a[3]);
}
static inline bool limbs_geq(const u64 a[4], const u64 b[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] > b[i]) return true;
    if (a[i] < b[i]) return false;
  }
  return true;
}
static inline void limbs_sub(u64 a[4], const u64 b[4]) {  // a -= b (a >= b)
  u128 bor = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - b[i] - bor;
    a[i] = (u64)d; bor = (d >> 64) & 1;
  }
}
static inline void limbs_shr1(u64 a[4]) {
  for (int i = 0; i < 3; ++i) a[i] = (a[i] >> 1) | (a[i + 1] << 63);
  a[3] >>= 1;
}
static inline void limbs_half_mod_q(u64 a[4]) {  // a = a/2 mod q
  if (a[0] & 1) {
    u128 c = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)a[i] + QL[i] + c;
      a[i] = (u64)s; c = s >> 64;
    }
    limbs_shr1(a);
    if (c) a[3] |= 1ull << 63;
  } else {
    limbs_shr1(a);
  }
}
static inline void limbs_submod(u64 a[4], const u64 b[4]) {  // a = a-b mod q
  u128 bor = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - b[i] - bor;
    a[i] = (u64)d; bor = (d >> 64) & 1;
  }
  if (bor) {
    u128 c = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)a[i] + QL[i] + c;
      a[i] = (u64)s; c = s >> 64;
    }
  }
}

static Fq fq_inv(const Fq& a) {
  // binary extended GCD on the Montgomery representative t = aR:
  // egcd gives t^{-1} (plain); two mont_muls by R^2 lift it to a^{-1}R.
  if (fq_is_zero(a)) return a;
  u64 u[4], v[4], x1[4] = {1, 0, 0, 0}, x2[4] = {0, 0, 0, 0};
  memcpy(u, a.l, 32);
  memcpy(v, QL, 32);
  while (!limbs_is_one(u) && !limbs_is_one(v)) {
    while (!(u[0] & 1)) { limbs_shr1(u); limbs_half_mod_q(x1); }
    while (!(v[0] & 1)) { limbs_shr1(v); limbs_half_mod_q(x2); }
    if (limbs_geq(u, v)) { limbs_sub(u, v); limbs_submod(x1, x2); }
    else { limbs_sub(v, u); limbs_submod(x2, x1); }
  }
  Fq s;
  memcpy(s.l, limbs_is_one(u) ? x1 : x2, 32);
  Fq r2; memcpy(r2.l, R2L, 32);
  return fq_mul(fq_mul(s, r2), r2);
}

// ---------------- Fq2 ----------------
struct Fq2 { Fq a, b; };
static inline Fq2 f2(const Fq& a, const Fq& b) { Fq2 r; r.a = a; r.b = b; return r; }
static inline Fq2 f2_zero() { return f2(fq_zero(), fq_zero()); }
static inline Fq2 f2_one() { return f2(fq_one(), fq_zero()); }
static inline Fq2 f2_add(const Fq2& x, const Fq2& y) { return f2(fq_add(x.a, y.a), fq_add(x.b, y.b)); }
static inline Fq2 f2_sub(const Fq2& x, const Fq2& y) { return f2(fq_sub(x.a, y.a), fq_sub(x.b, y.b)); }
static inline Fq2 f2_neg(const Fq2& x) { return f2(fq_neg(x.a), fq_neg(x.b)); }
static Fq2 f2_mul(const Fq2& x, const Fq2& y) {
  Fq ac = fq_mul(x.a, y.a), bd = fq_mul(x.b, y.b);
  Fq ad_bc = fq_sub(fq_sub(fq_mul(fq_add(x.a, x.b), fq_add(y.a, y.b)), ac), bd);
  return f2(fq_sub(ac, bd), ad_bc);
}
static inline Fq2 f2_sqr(const Fq2& x) { return f2_mul(x, x); }
static Fq2 f2_mul_fq(const Fq2& x, const Fq& s) { return f2(fq_mul(x.a, s), fq_mul(x.b, s)); }
static Fq2 f2_inv(const Fq2& x) {
  Fq t = fq_inv(fq_add(fq_sqr(x.a), fq_sqr(x.b)));
  return f2(fq_mul(x.a, t), fq_neg(fq_mul(x.b, t)));
}
static inline bool f2_is_zero(const Fq2& x) { return fq_is_zero(x.a) && fq_is_zero(x.b); }

// xi = 9 + u (cached Montgomery form)
static Fq2 f2_xi() {
  static Fq2 xi;
  static bool init = false;
  if (!init) {
    Fq nine = fq_zero(); nine.l[0] = 9;
    Fq r2; memcpy(r2.l, R2L, 32);
    xi = f2(fq_mul(nine, r2), fq_one());
    init = true;
  }
  return xi;
}
static Fq2 f2_mul_xi(const Fq2& x) { return f2_mul(x, f2_xi()); }

// ---------------- Fq6 = Fq2[v]/(v^3 - xi) ----------------
struct Fq6 { Fq2 c0, c1, c2; };
static inline Fq6 f6(const Fq2& a, const Fq2& b, const Fq2& c) { Fq6 r; r.c0=a; r.c1=b; r.c2=c; return r; }
static inline Fq6 f6_zero() { return f6(f2_zero(), f2_zero(), f2_zero()); }
static inline Fq6 f6_one() { return f6(f2_one(), f2_zero(), f2_zero()); }
static inline Fq6 f6_add(const Fq6& x, const Fq6& y) { return f6(f2_add(x.c0,y.c0), f2_add(x.c1,y.c1), f2_add(x.c2,y.c2)); }
static inline Fq6 f6_sub(const Fq6& x, const Fq6& y) { return f6(f2_sub(x.c0,y.c0), f2_sub(x.c1,y.c1), f2_sub(x.c2,y.c2)); }
static inline Fq6 f6_neg(const Fq6& x) { return f6(f2_neg(x.c0), f2_neg(x.c1), f2_neg(x.c2)); }
static Fq6 f6_mul(const Fq6& x, const Fq6& y) {
  // Karatsuba (same schedule as fq_tower.py)
  Fq2 t0 = f2_mul(x.c0, y.c0), t1 = f2_mul(x.c1, y.c1), t2 = f2_mul(x.c2, y.c2);
  Fq2 c0 = f2_add(f2_mul_xi(f2_sub(f2_sub(f2_mul(f2_add(x.c1,x.c2), f2_add(y.c1,y.c2)), t1), t2)), t0);
  Fq2 c1 = f2_add(f2_sub(f2_sub(f2_mul(f2_add(x.c0,x.c1), f2_add(y.c0,y.c1)), t0), t1), f2_mul_xi(t2));
  Fq2 c2 = f2_add(f2_sub(f2_sub(f2_mul(f2_add(x.c0,x.c2), f2_add(y.c0,y.c2)), t0), t2), t1);
  return f6(c0, c1, c2);
}
static inline Fq6 f6_sqr(const Fq6& x) { return f6_mul(x, x); }
static Fq6 f6_mul_v(const Fq6& x) { return f6(f2_mul_xi(x.c2), x.c0, x.c1); }
static Fq6 f6_inv(const Fq6& x) {
  Fq2 a = x.c0, b = x.c1, c = x.c2;
  Fq2 A = f2_sub(f2_sqr(a), f2_mul_xi(f2_mul(b, c)));
  Fq2 B = f2_sub(f2_mul_xi(f2_sqr(c)), f2_mul(a, b));
  Fq2 C = f2_sub(f2_sqr(b), f2_mul(a, c));
  Fq2 t = f2_inv(f2_add(f2_mul(a, A), f2_mul_xi(f2_add(f2_mul(c, B), f2_mul(b, C)))));
  return f6(f2_mul(A, t), f2_mul(B, t), f2_mul(C, t));
}

// ---------------- Fq12 = Fq6[w]/(w^2 - v) ----------------
struct Fq12 { Fq6 c0, c1; };
static inline Fq12 f12(const Fq6& a, const Fq6& b) { Fq12 r; r.c0=a; r.c1=b; return r; }
static inline Fq12 f12_one() { return f12(f6_one(), f6_zero()); }
static Fq12 f12_mul(const Fq12& x, const Fq12& y) {
  Fq6 t0 = f6_mul(x.c0, y.c0), t1 = f6_mul(x.c1, y.c1);
  Fq6 c0 = f6_add(t0, f6_mul_v(t1));
  Fq6 c1 = f6_sub(f6_sub(f6_mul(f6_add(x.c0,x.c1), f6_add(y.c0,y.c1)), t0), t1);
  return f12(c0, c1);
}
static inline Fq12 f12_sqr(const Fq12& x) { return f12_mul(x, x); }
static Fq12 f12_pow_bytes(const Fq12& a, const uint8_t* e, size_t n) {
  Fq12 acc = f12_one();
  int started = 0;
  for (size_t bi = n; bi-- > 0;) {
    for (int bit = 7; bit >= 0; --bit) {
      if (started) acc = f12_sqr(acc);
      if ((e[bi] >> bit) & 1) {
        if (!started) { acc = a; started = 1; }
        else acc = f12_mul(acc, a);
      }
    }
  }
  return acc;
}

// ---------------- serialization ----------------
static Fq fq_read(const uint8_t* p) {
  u64 l[4];
  memcpy(l, p, 32);
  return fq_from_canonical(l);
}
static void fq_write(const Fq& a, uint8_t* p) {
  u64 l[4];
  fq_to_canonical(a, l);
  memcpy(p, l, 32);
}
static Fq2 f2_read(const uint8_t* p) { return f2(fq_read(p), fq_read(p + 32)); }
static void f2_write(const Fq2& x, uint8_t* p) { fq_write(x.a, p); fq_write(x.b, p + 32); }
static Fq12 f12_read(const uint8_t* p) {
  Fq6 c0 = f6(f2_read(p), f2_read(p + 64), f2_read(p + 128));
  Fq6 c1 = f6(f2_read(p + 192), f2_read(p + 256), f2_read(p + 320));
  return f12(c0, c1);
}
static void f12_write(const Fq12& x, uint8_t* p) {
  f2_write(x.c0.c0, p); f2_write(x.c0.c1, p + 64); f2_write(x.c0.c2, p + 128);
  f2_write(x.c1.c0, p + 192); f2_write(x.c1.c1, p + 256); f2_write(x.c1.c2, p + 320);
}

// ---------------- Miller loop (Tate; mirrors pairing.py) ----------------
// psi(Q) = (x_Q w^2 = x_Q*v, y_Q w^3 = y_Q*v*w); line evaluated sparsely:
//   l = y_Q*v*w + (-lam * x_Q)*v + (lam*ax - ay)
// (an Fq12 with c0 = (c, -lam*x_Q, 0), c1 = (0, y_Q, 0))
static Fq12 line_eval(const Fq& ax, const Fq& ay, const Fq& lam,
                      const Fq2& xq, const Fq2& yq) {
  Fq c = fq_sub(fq_mul(lam, ax), ay);
  Fq2 c00 = f2(c, fq_zero());
  Fq2 c01 = f2_mul_fq(xq, fq_neg(lam));
  Fq6 c0 = f6(c00, c01, f2_zero());
  Fq6 c1 = f6(f2_zero(), yq, f2_zero());
  return f12(c0, c1);
}

// f * line, exploiting the line's sparsity (l.c0 = (a, b, 0),
// l.c1 = (0, c, 0)): same product as f12_mul, ~60% fewer Fq2 muls.
static Fq12 f12_mul_line(const Fq12& f, const Fq2& a, const Fq2& b,
                         const Fq2& c) {
  const Fq6& x0 = f.c0;
  const Fq6& x1 = f.c1;
  // t0 = x0 * (a + b v):
  Fq6 t0 = f6(f2_add(f2_mul(x0.c0, a), f2_mul_xi(f2_mul(x0.c2, b))),
              f2_add(f2_mul(x0.c1, a), f2_mul(x0.c0, b)),
              f2_add(f2_mul(x0.c2, a), f2_mul(x0.c1, b)));
  // t1 = x1 * (c v):
  Fq6 t1 = f6(f2_mul_xi(f2_mul(x1.c2, c)),
              f2_mul(x1.c0, c),
              f2_mul(x1.c1, c));
  // x1 * (a + b v):
  Fq6 t2 = f6(f2_add(f2_mul(x1.c0, a), f2_mul_xi(f2_mul(x1.c2, b))),
              f2_add(f2_mul(x1.c1, a), f2_mul(x1.c0, b)),
              f2_add(f2_mul(x1.c2, a), f2_mul(x1.c1, b)));
  // x0 * (c v):
  Fq6 t3 = f6(f2_mul_xi(f2_mul(x0.c2, c)),
              f2_mul(x0.c0, c),
              f2_mul(x0.c1, c));
  return f12(f6_add(t0, f6_mul_v(t1)), f6_add(t2, t3));
}

// ---------------- Miller loop (optimal ate; mirrors curve/ate.py) --------
// Loop over 6x+2 = 29793968203157093288 (64 bits after the leading 1,
// 36 add-steps) taken on the TWIST curve E'(Fq2); lines evaluated at the
// G1 argument.  The line through psi(T) with twist slope lam at
// P = (xp, yp) is the sparse element
//     l = yp + (-lam*xp) w + (lam*x_T - y_T) v w
// i.e. Fq12 with c0 = (yp, 0, 0), c1 = (B, C, 0); B = -xp*lam, C = lam*x_T
// - y_T.  ~4x fewer loop iterations than the previous Tate tier; values
// match curve/ate.py (the Python oracle) exactly.
static const char* ATE_BITS =
  "1001110101111001011100000011100110111110011101100011101110101000";

// Twist Frobenius constants g^2, g^3, g = xi^((q-1)/6) (see ate.py
// _TW_X/_TW_Y; canonical limbs little-endian).
static Fq2 ate_twx() {
  static Fq2 v; static bool init = false;
  if (!init) {
    u64 a[4] = {0x99e39557176f553dull, 0xb78cc310c2c3330cull,
                0x4c0bec3cf559b143ull, 0x2fb347984f7911f7ull};
    u64 b[4] = {0x1665d51c640fcba2ull, 0x32ae2a1d0b7c9dceull,
                0x4ba4cc8bd75a0794ull, 0x16c9e55061ebae20ull};
    v = f2(fq_from_canonical(a), fq_from_canonical(b)); init = true;
  }
  return v;
}
static Fq2 ate_twy() {
  static Fq2 v; static bool init = false;
  if (!init) {
    u64 a[4] = {0xdc54014671a0135aull, 0xdbaae0eda9c95998ull,
                0xdc5ec698b6e2f9b9ull, 0x063cf305489af5dcull};
    u64 b[4] = {0x82d37f632623b0e3ull, 0x21807dc98fa25bd2ull,
                0x0704b5a7ec796f2bull, 0x07c03cbcac41049aull};
    v = f2(fq_from_canonical(a), fq_from_canonical(b)); init = true;
  }
  return v;
}

static inline Fq2 f2_conj(const Fq2& x) { return f2(x.a, fq_neg(x.b)); }

// f * (a + (B + C v) w), a in Fq (the ate line's sparsity pattern).
static Fq12 f12_mul_line_ate(const Fq12& f, const Fq& a, const Fq2& B,
                             const Fq2& C) {
  const Fq6& x0 = f.c0;
  const Fq6& x1 = f.c1;
  // s = B + C v;  x * s over Fq6 (v^3 = xi)
  auto mul_s = [&](const Fq6& x) -> Fq6 {
    return f6(f2_add(f2_mul(x.c0, B), f2_mul_xi(f2_mul(x.c2, C))),
              f2_add(f2_mul(x.c0, C), f2_mul(x.c1, B)),
              f2_add(f2_mul(x.c1, C), f2_mul(x.c2, B)));
  };
  Fq6 r0 = f6_add(f6(f2_mul_fq(x0.c0, a), f2_mul_fq(x0.c1, a),
                     f2_mul_fq(x0.c2, a)),
                  f6_mul_v(mul_s(x1)));
  Fq6 r1 = f6_add(f6(f2_mul_fq(x1.c0, a), f2_mul_fq(x1.c1, a),
                     f2_mul_fq(x1.c2, a)),
                  mul_s(x0));
  return f12(r0, r1);
}

// Batched optimal-ate Miller product: all lanes advance in lockstep
// through the static ATE_BITS schedule; the per-step Fq2 slope
// denominators share ONE Fq inversion via the norm map + Montgomery
// batch-inversion trick (norm(den) inverts in Fq; den^-1 = conj(den) *
// norm^-1).  A lane whose T hits infinity (vertical line, subfield
// element killed by the final exponentiation) freezes, mirroring the
// Tate tier's break semantics.
static Fq12 miller_batch(const uint8_t* g1s, const uint8_t* g2s,
                         const uint8_t* inf, uint64_t n) {
  struct St { Fq yp, nxp; Fq2 xq, yq, tx, ty, sx, sy; Fq12 f;
              bool live, done; };
  std::vector<St> st(n);
  uint64_t live = 0;
  for (uint64_t i = 0; i < n; ++i) {
    St& s = st[i];
    s.f = f12_one();
    s.done = false;
    s.live = !inf[i];
    if (!s.live) continue;
    Fq xp = fq_read(g1s + 64 * i);
    s.yp = fq_read(g1s + 64 * i + 32);
    s.nxp = fq_neg(xp);
    s.xq = f2_read(g2s + 128 * i); s.yq = f2_read(g2s + 128 * i + 64);
    s.tx = s.xq; s.ty = s.yq;
    ++live;
  }
  if (!live) return f12_one();

  std::vector<Fq2> dens(n);
  std::vector<Fq> norms(n), prefix(n);
  std::vector<Fq2> invs(n);

  // batch-invert dens[] over active lanes (done/degenerate handled by
  // the caller); den == 0 lanes must be filtered before calling.
  auto batch_f2_inv = [&]() {
    uint64_t m = 0;
    static thread_local std::vector<uint64_t> idx;
    idx.clear();
    for (uint64_t i = 0; i < n; ++i) {
      St& s = st[i];
      if (!s.live || s.done) continue;
      norms[m] = fq_add(fq_sqr(dens[i].a), fq_sqr(dens[i].b));
      prefix[m] = m ? fq_mul(prefix[m - 1], norms[m]) : norms[m];
      idx.push_back(i);
      ++m;
    }
    if (!m) return;
    Fq run = fq_inv(prefix[m - 1]);
    for (uint64_t k = m; k-- > 0;) {
      Fq ninv = k ? fq_mul(run, prefix[k - 1]) : run;
      run = fq_mul(run, norms[k]);
      uint64_t i = idx[k];
      invs[i] = f2(fq_mul(dens[i].a, ninv),
                   fq_neg(fq_mul(dens[i].b, ninv)));
    }
  };

  auto dbl_step = [&](bool with_sqr) {
    for (uint64_t i = 0; i < n; ++i) {
      St& s = st[i];
      if (!s.live || s.done) continue;
      dens[i] = f2_add(s.ty, s.ty);
      if (f2_is_zero(dens[i])) s.done = true;   // 2-torsion: vertical
    }
    batch_f2_inv();
    for (uint64_t i = 0; i < n; ++i) {
      St& s = st[i];
      if (!s.live || s.done) continue;
      Fq2 tx2 = f2_sqr(s.tx);
      Fq2 lam = f2_mul(f2_add(f2_add(tx2, tx2), tx2), invs[i]);
      Fq2 C = f2_sub(f2_mul(lam, s.tx), s.ty);
      Fq2 B = f2_mul_fq(lam, s.nxp);
      if (with_sqr) s.f = f12_sqr(s.f);
      s.f = f12_mul_line_ate(s.f, s.yp, B, C);
      Fq2 x3 = f2_sub(f2_sqr(lam), f2_add(s.tx, s.tx));
      s.ty = f2_sub(f2_mul(lam, f2_sub(s.tx, x3)), s.ty);
      s.tx = x3;
    }
  };

  // add T += S (per-lane S in sx/sy), line anchored at T.
  auto add_step = [&]() {
    for (uint64_t i = 0; i < n; ++i) {
      St& s = st[i];
      if (!s.live || s.done) continue;
      dens[i] = f2_sub(s.tx, s.sx);
      if (f2_is_zero(dens[i])) {
        // T == +-S: vertical chord (T = -S) freezes the lane; T == S
        // cannot occur in the ate schedule for order-r points and is
        // treated the same (degenerate, probability ~2^-254 otherwise)
        s.done = true;
      }
    }
    batch_f2_inv();
    for (uint64_t i = 0; i < n; ++i) {
      St& s = st[i];
      if (!s.live || s.done) continue;
      Fq2 lam = f2_mul(f2_sub(s.ty, s.sy), invs[i]);
      Fq2 C = f2_sub(f2_mul(lam, s.tx), s.ty);
      Fq2 B = f2_mul_fq(lam, s.nxp);
      s.f = f12_mul_line_ate(s.f, s.yp, B, C);
      Fq2 x3 = f2_sub(f2_sub(f2_sqr(lam), s.tx), s.sx);
      s.ty = f2_sub(f2_mul(lam, f2_sub(s.tx, x3)), s.ty);
      s.tx = x3;
    }
  };

  bool first = true;
  for (const char* b = ATE_BITS; *b; ++b) {
    dbl_step(!first);
    first = false;
    if (*b == '1') {
      for (uint64_t i = 0; i < n; ++i) { st[i].sx = st[i].xq; st[i].sy = st[i].yq; }
      add_step();
    }
  }
  // Frobenius endpoints: Q1 = pi(Q), then -pi^2(Q).
  Fq2 twx = ate_twx(), twy = ate_twy();
  for (uint64_t i = 0; i < n; ++i) {
    St& s = st[i];
    if (!s.live || s.done) continue;
    s.sx = f2_mul(f2_conj(s.xq), twx);
    s.sy = f2_mul(f2_conj(s.yq), twy);
  }
  add_step();
  for (uint64_t i = 0; i < n; ++i) {
    St& s = st[i];
    if (!s.live || s.done) continue;
    Fq2 q1x = f2_mul(f2_conj(s.xq), twx);
    Fq2 q1y = f2_mul(f2_conj(s.yq), twy);
    s.sx = f2_mul(f2_conj(q1x), twx);
    s.sy = f2_neg(f2_mul(f2_conj(q1y), twy));
  }
  add_step();

  Fq12 acc = f12_one();
  for (uint64_t i = 0; i < n; ++i)
    if (st[i].live) acc = f12_mul(acc, st[i].f);
  return acc;
}


// ---------------- G1 Jacobian arithmetic + Pippenger MSM ----------------
// Production host-side MSM (Dory tier-1 dense rows, opening phase-B cross
// terms); mirrors bn254_host.py's zero-skip windowed buckets.

struct G1J { Fq x, y, z; };   // z == 0 -> infinity

static inline G1J g1j_inf() { G1J r; r.x = fq_zero(); r.y = fq_zero(); r.z = fq_zero(); return r; }
static inline bool g1j_is_inf(const G1J& p) { return fq_is_zero(p.z); }

static G1J g1j_double(const G1J& p) {
  if (g1j_is_inf(p)) return p;
  // dbl-2009-l
  Fq A = fq_sqr(p.x), B = fq_sqr(p.y), C = fq_sqr(B);
  Fq t = fq_sqr(fq_add(p.x, B));
  Fq D = fq_add(fq_sub(fq_sub(t, A), C), fq_sub(fq_sub(t, A), C));
  Fq E = fq_add(fq_add(A, A), A);
  Fq F = fq_sqr(E);
  G1J r;
  r.x = fq_sub(F, fq_add(D, D));
  Fq c8 = fq_add(C, C); c8 = fq_add(c8, c8); c8 = fq_add(c8, c8);
  r.y = fq_sub(fq_mul(E, fq_sub(D, r.x)), c8);
  r.z = fq_mul(fq_add(p.y, p.y), p.z);
  return r;
}

static G1J g1j_add(const G1J& p, const G1J& q) {
  if (g1j_is_inf(p)) return q;
  if (g1j_is_inf(q)) return p;
  Fq z1z1 = fq_sqr(p.z), z2z2 = fq_sqr(q.z);
  Fq u1 = fq_mul(p.x, z2z2), u2 = fq_mul(q.x, z1z1);
  Fq s1 = fq_mul(fq_mul(p.y, q.z), z2z2);
  Fq s2 = fq_mul(fq_mul(q.y, p.z), z1z1);
  if (fq_eq(u1, u2)) {
    if (fq_eq(s1, s2)) return g1j_double(p);
    return g1j_inf();
  }
  Fq h = fq_sub(u2, u1);
  Fq i = fq_sqr(fq_add(h, h));
  Fq j = fq_mul(h, i);
  Fq rr = fq_add(fq_sub(s2, s1), fq_sub(s2, s1));
  Fq v = fq_mul(u1, i);
  G1J r;
  r.x = fq_sub(fq_sub(fq_sqr(rr), j), fq_add(v, v));
  Fq s1j = fq_mul(s1, j);
  r.y = fq_sub(fq_mul(rr, fq_sub(v, r.x)), fq_add(s1j, s1j));
  Fq zz = fq_sub(fq_sub(fq_sqr(fq_add(p.z, q.z)), z1z1), z2z2);
  r.z = fq_mul(zz, h);
  return r;
}

// mixed add: q affine (z = 1 implicitly); q_inf flag
static G1J g1j_madd(const G1J& p, const Fq& qx, const Fq& qy) {
  if (g1j_is_inf(p)) {
    G1J r; r.x = qx; r.y = qy; r.z = fq_one();
    return r;
  }
  Fq z1z1 = fq_sqr(p.z);
  Fq u2 = fq_mul(qx, z1z1);
  Fq s2 = fq_mul(fq_mul(qy, p.z), z1z1);
  if (fq_eq(p.x, u2)) {
    if (fq_eq(p.y, s2)) return g1j_double(p);
    return g1j_inf();
  }
  Fq h = fq_sub(u2, p.x);
  Fq i = fq_sqr(fq_add(h, h));
  Fq j = fq_mul(h, i);
  Fq rr = fq_add(fq_sub(s2, p.y), fq_sub(s2, p.y));
  Fq v = fq_mul(p.x, i);
  G1J r;
  r.x = fq_sub(fq_sub(fq_sqr(rr), j), fq_add(v, v));
  Fq yj = fq_mul(p.y, j);
  r.y = fq_sub(fq_mul(rr, fq_sub(v, r.x)), fq_add(yj, yj));
  // z3 = (z1 + h)^2 - z1z1 - h^2
  r.z = fq_sub(fq_sub(fq_sqr(fq_add(p.z, h)), z1z1), fq_sqr(h));
  return r;
}

static void g1j_to_affine(const G1J& p, uint8_t* out64, uint8_t* inf) {
  if (g1j_is_inf(p)) {
    *inf = 1;
    memset(out64, 0, 64);
    return;
  }
  *inf = 0;
  Fq zi = fq_inv(p.z);
  Fq zi2 = fq_sqr(zi);
  fq_write(fq_mul(p.x, zi2), out64);
  fq_write(fq_mul(p.y, fq_mul(zi2, zi)), out64 + 32);
}

extern "C" {

// MSM over affine points (n*64B) with 32B LE scalars; zero-skip windowed
// buckets (c = 8), threaded across windows.  out: 64B affine + inf flag.
void jolt_g1_msm(const uint8_t* pts, const uint8_t* inf,
                 const uint8_t* scalars, uint64_t n,
                 uint8_t* out, uint8_t* out_inf) {
  constexpr int C = 8;
  constexpr int NWIN = (254 + C - 1) / C;
  std::vector<Fq> xs(n), ys(n);
  std::vector<uint8_t> live(n);
  for (uint64_t i = 0; i < n; ++i) {
    bool z = true;
    for (int b = 0; b < 32; ++b) z = z && scalars[32 * i + b] == 0;
    live[i] = !inf[i] && !z;
    if (live[i]) {
      xs[i] = fq_read(pts + 64 * i);
      ys[i] = fq_read(pts + 64 * i + 32);
    }
  }
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t nt = hw ? (hw < 8 ? hw : 8) : 1;
  if (nt > NWIN) nt = NWIN;
  std::vector<G1J> windows(NWIN, g1j_inf());
  auto do_window = [&](int w) {
    G1J buckets[1 << C];
    bool used[1 << C] = {false};
    for (int d = 0; d < (1 << C); ++d) buckets[d] = g1j_inf();
    int lo_bit = w * C;
    for (uint64_t i = 0; i < n; ++i) {
      if (!live[i]) continue;
      int byte = lo_bit / 8, off = lo_bit % 8;
      unsigned d = scalars[32 * i + byte] >> off;
      if (off + C > 8 && byte + 1 < 32)
        d |= (unsigned)scalars[32 * i + byte + 1] << (8 - off);
      d &= (1 << C) - 1;
      if (d) { buckets[d] = g1j_madd(buckets[d], xs[i], ys[i]); used[d] = true; }
    }
    G1J run = g1j_inf(), acc = g1j_inf();
    for (int d = (1 << C) - 1; d >= 1; --d) {
      if (used[d]) run = g1j_add(run, buckets[d]);
      acc = g1j_add(acc, run);
    }
    windows[w] = acc;
  };
  if (nt <= 1) {
    for (int w = 0; w < NWIN; ++w) do_window(w);
  } else {
    std::vector<std::thread> ts;
    std::atomic<int> next{0};
    for (uint64_t t = 0; t < nt; ++t)
      ts.emplace_back([&]() {
        for (int w = next.fetch_add(1); w < NWIN; w = next.fetch_add(1))
          do_window(w);
      });
    for (auto& th : ts) th.join();
  }
  G1J total = g1j_inf();
  for (int w = NWIN - 1; w >= 0; --w) {
    for (int b = 0; b < C; ++b) total = g1j_double(total);
    total = g1j_add(total, windows[w]);
  }
  g1j_to_affine(total, out, out_inf);
}

// out[i] = a_i + s * b_i with ONE shared scalar given in GLV-decomposed
// form s = sgn1*k1 + sgn2*k2*lambda (|k1|,|k2| < 2^128, 16B LE each):
// per lane a 128-bit Shamir double-and-add over (P1, P2 = phi(B)) with
// phi(x, y) = (beta*x, y) -- ~1.9x fewer point ops than the 254-bit
// double-and-add in jolt_g1_fold_batch.  The Python side computes the
// lattice decomposition (native_pairing.g1_fold_batch fast path).
void jolt_g1_fold_glv(const uint8_t* av, const uint8_t* a_inf,
                      const uint8_t* bv, const uint8_t* b_inf,
                      const uint8_t* k1le, int neg1,
                      const uint8_t* k2le, int neg2, uint64_t n,
                      uint8_t* out, uint8_t* out_inf) {
  static const u64 BETA[4] = {0x5763473177fffffeull, 0xd4f263f1acdb5c4full,
                              0x59e26bcea0d48bacull, 0ull};
  Fq beta = fq_from_canonical(BETA);
  u64 k1[2], k2[2];
  memcpy(k1, k1le, 16);
  memcpy(k2, k2le, 16);
  int top = 127;
  while (top > 0) {
    int w = top / 64, b = top % 64;
    if (((k1[w] >> b) & 1) || ((k2[w] >> b) & 1)) break;
    --top;
  }
  bool zero_s = !(k1[0] | k1[1] | k2[0] | k2[1]);
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t nt = hw ? (hw < 8 ? hw : 8) : 1;
  if (nt > n) nt = n ? n : 1;
  auto work = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      G1J acc = g1j_inf();
      if (!b_inf[i] && !zero_s) {
        Fq bx = fq_read(bv + 64 * i), by = fq_read(bv + 64 * i + 32);
        Fq p1x = bx, p1y = neg1 ? fq_neg(by) : by;
        Fq p2x = fq_mul(bx, beta), p2y = neg2 ? fq_neg(by) : by;
        // T = P1 + P2 (Jacobian; distinct x since beta != 1)
        G1J t;
        t.x = p1x; t.y = p1y; t.z = fq_one();
        t = g1j_madd(t, p2x, p2y);
        for (int bit = top; bit >= 0; --bit) {
          acc = g1j_double(acc);
          int w = bit / 64, bb = bit % 64;
          unsigned d = (unsigned)((k1[w] >> bb) & 1)
                     | ((unsigned)((k2[w] >> bb) & 1) << 1);
          if (d == 1) acc = g1j_madd(acc, p1x, p1y);
          else if (d == 2) acc = g1j_madd(acc, p2x, p2y);
          else if (d == 3) acc = g1j_add(acc, t);
        }
      }
      if (!a_inf[i])
        acc = g1j_madd(acc, fq_read(av + 64 * i), fq_read(av + 64 * i + 32));
      g1j_to_affine(acc, out + 64 * i, out_inf + i);
    }
  };
  if (nt <= 1) { work(0, n); }
  else {
    std::vector<std::thread> ts;
    uint64_t chunk = (n + nt - 1) / nt;
    for (uint64_t t = 0; t < nt; ++t) {
      uint64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
      if (lo < hi) ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
}

// Per-segment sums of base points selected by index:
//   out[s] = sum_{i in [seg_off[s], seg_off[s+1])} base[col[i]]
// base: nb 64-byte affine points (no infinities -- URS generators),
// col: uint32 indices into base, seg_off: ns+1 offsets.  The tier-1
// one-hot Dory commit (sum of column generators per matrix row,
// reference `poly/one_hot_polynomial.rs:119` commit_rows); threaded
// over segments.
void jolt_g1_segment_sums(const uint8_t* base, const uint32_t* col,
                          const uint64_t* seg_off, uint64_t ns,
                          uint8_t* out, uint8_t* out_inf) {
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t nt = hw ? (hw < 8 ? hw : 8) : 1;
  if (nt > ns) nt = ns ? ns : 1;
  auto work = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t s = lo; s < hi; ++s) {
      G1J acc = g1j_inf();
      for (uint64_t i = seg_off[s]; i < seg_off[s + 1]; ++i) {
        const uint8_t* p = base + 64 * (uint64_t)col[i];
        acc = g1j_madd(acc, fq_read(p), fq_read(p + 32));
      }
      g1j_to_affine(acc, out + 64 * s, out_inf + s);
    }
  };
  if (nt <= 1) { work(0, ns); }
  else {
    std::vector<std::thread> ts;
    uint64_t chunk = (ns + nt - 1) / nt;
    for (uint64_t t = 0; t < nt; ++t) {
      uint64_t lo = t * chunk, hi = lo + chunk > ns ? ns : lo + chunk;
      if (lo < hi) ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
}

// out[i] = a_i + s_i * b_i over G1 (per-lane scalars), threaded lanes.
void jolt_g1_fold_batch(const uint8_t* av, const uint8_t* a_inf,
                        const uint8_t* bv, const uint8_t* b_inf,
                        const uint8_t* scalars, uint64_t n,
                        uint8_t* out, uint8_t* out_inf) {
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t nt = hw ? (hw < 8 ? hw : 8) : 1;
  if (nt > n) nt = n ? n : 1;
  auto work = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      G1J acc = g1j_inf();
      u64 k[4];
      memcpy(k, scalars + 32 * i, 32);
      if (!b_inf[i] && !limbs_is_zero(k)) {
        G1J base;
        base.x = fq_read(bv + 64 * i);
        base.y = fq_read(bv + 64 * i + 32);
        base.z = fq_one();
        while (!limbs_is_zero(k)) {
          if (k[0] & 1) acc = g1j_add(acc, base);
          limbs_shr1(k);
          if (!limbs_is_zero(k)) base = g1j_double(base);
        }
      }
      if (!a_inf[i])
        acc = g1j_madd(acc, fq_read(av + 64 * i), fq_read(av + 64 * i + 32));
      g1j_to_affine(acc, out + 64 * i, out_inf + i);
    }
  };
  if (nt <= 1) { work(0, n); return; }
  std::vector<std::thread> ts;
  uint64_t chunk = (n + nt - 1) / nt;
  for (uint64_t t = 0; t < nt; ++t) {
    uint64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// ---------------- batched G2 affine scalar multiplication ----------------
// v2 builds / folds in the Dory reduce need thousands of independent G2
// muls; lanes advance bit-synchronously (LSB-first double-and-add,
// mirroring pairing.py's g2_mul) so the affine slope denominators batch
// into ONE Fq inversion per pass via the norm map (den^-1 = conj(den) *
// norm(den)^-1, norm in Fq) -- the same trick as miller_batch.  ~6x over
// the previous per-add f2_inv tier; group elements are byte-identical.

struct G2 { Fq2 x, y; bool inf; };

static G2 g2_inf() { G2 r; r.inf = true; r.x = f2_zero(); r.y = f2_zero(); return r; }

// single (non-batched) affine add, used on the accumulate side
static G2 g2_add1(const G2& p, const G2& q) {
  if (p.inf) return q;
  if (q.inf) return p;
  Fq2 lam;
  if (fq_eq(p.x.a, q.x.a) && fq_eq(p.x.b, q.x.b)) {
    Fq2 s = f2_add(p.y, q.y);
    if (f2_is_zero(s)) return g2_inf();
    lam = f2_mul(f2_mul_fq(f2_sqr(p.x), fq_add(fq_add(fq_one(), fq_one()), fq_one())),
                 f2_inv(f2_add(p.y, p.y)));
  } else {
    lam = f2_mul(f2_sub(q.y, p.y), f2_inv(f2_sub(q.x, p.x)));
  }
  Fq2 x3 = f2_sub(f2_sub(f2_sqr(lam), p.x), q.x);
  Fq2 y3 = f2_sub(f2_mul(lam, f2_sub(p.x, x3)), p.y);
  G2 r; r.x = x3; r.y = y3; r.inf = false;
  return r;
}

// batched acc[i] += add[i] over the lanes in idx; exact g2_add1 case
// analysis (copy / chord / tangent / inf), one shared Fq inversion.
// `add` may alias `acc` (the doubling pass): per-lane reads complete
// before the write-back.
static void g2_lanes_add(std::vector<G2>& acc, const std::vector<G2>& add,
                         const std::vector<uint32_t>& idx) {
  size_t m = idx.size();
  if (!m) return;
  static thread_local std::vector<Fq2> dens, invs;
  static thread_local std::vector<Fq> norms, prefix;
  static thread_local std::vector<uint8_t> kind;
  static thread_local std::vector<uint32_t> sel;
  dens.clear(); sel.clear();
  kind.assign(m, 0);   // 0 no-op, 1 copy add, 2 -> inf, 3 chord, 4 tangent
  for (size_t t = 0; t < m; ++t) {
    uint32_t i = idx[t];
    const G2& a = acc[i];
    const G2& b = add[i];
    if (b.inf) continue;
    if (a.inf) { kind[t] = 1; continue; }
    Fq2 den;
    if (fq_eq(a.x.a, b.x.a) && fq_eq(a.x.b, b.x.b)) {
      if (f2_is_zero(f2_add(a.y, b.y))) { kind[t] = 2; continue; }
      den = f2_add(a.y, a.y);
      kind[t] = 4;
    } else {
      den = f2_sub(b.x, a.x);
      kind[t] = 3;
    }
    dens.push_back(den);
    sel.push_back((uint32_t)t);
  }
  size_t q = dens.size();
  if (q) {
    norms.resize(q); prefix.resize(q); invs.resize(q);
    for (size_t j = 0; j < q; ++j) {
      norms[j] = fq_add(fq_sqr(dens[j].a), fq_sqr(dens[j].b));
      prefix[j] = j ? fq_mul(prefix[j - 1], norms[j]) : norms[j];
    }
    Fq run = fq_inv(prefix[q - 1]);
    for (size_t j = q; j-- > 0;) {
      Fq ninv = j ? fq_mul(run, prefix[j - 1]) : run;
      run = fq_mul(run, norms[j]);
      invs[j] = f2(fq_mul(dens[j].a, ninv), fq_neg(fq_mul(dens[j].b, ninv)));
    }
  }
  for (size_t j = 0; j < q; ++j) {
    size_t t = sel[j];
    uint32_t i = idx[t];
    G2& a = acc[i];
    const G2& b = add[i];
    Fq2 lam;
    if (kind[t] == 4)
      lam = f2_mul(f2_mul_fq(f2_sqr(a.x),
                             fq_add(fq_add(fq_one(), fq_one()), fq_one())),
                   invs[j]);
    else
      lam = f2_mul(f2_sub(b.y, a.y), invs[j]);
    Fq2 x3 = f2_sub(f2_sub(f2_sqr(lam), a.x), b.x);
    Fq2 y3 = f2_sub(f2_mul(lam, f2_sub(a.x, x3)), a.y);
    a.x = x3; a.y = y3; a.inf = false;
  }
  for (size_t t = 0; t < m; ++t) {
    uint32_t i = idx[t];
    if (kind[t] == 1) acc[i] = add[i];
    else if (kind[t] == 2) acc[i] = g2_inf();
  }
}

// lockstep LSB-first ladder: acc[i] += k_i * base[i]; ks (4 limbs per
// lane) and base are clobbered.
static void g2_lanes_mul_acc(std::vector<G2>& acc, std::vector<G2>& base,
                             std::vector<u64>& ks) {
  uint64_t n = acc.size();
  std::vector<uint32_t> idx;
  idx.reserve(n);
  for (;;) {
    idx.clear();
    for (uint64_t i = 0; i < n; ++i)
      if ((ks[4 * i] & 1) && !base[i].inf) idx.push_back((uint32_t)i);
    g2_lanes_add(acc, base, idx);
    idx.clear();
    for (uint64_t i = 0; i < n; ++i) {
      u64* k = &ks[4 * i];
      limbs_shr1(k);
      if ((k[0] | k[1] | k[2] | k[3]) && !base[i].inf)
        idx.push_back((uint32_t)i);
    }
    if (idx.empty()) break;
    g2_lanes_add(base, base, idx);
  }
}

static G2 g2_read(const uint8_t* p, uint8_t inf) {
  G2 r;
  r.inf = inf != 0;
  if (r.inf) { r.x = f2_zero(); r.y = f2_zero(); }
  else { r.x = f2_read(p); r.y = f2_read(p + 64); }
  return r;
}

static void g2_write(const G2& p, uint8_t* out, uint8_t* out_inf) {
  *out_inf = p.inf ? 1 : 0;
  if (p.inf) { memset(out, 0, 128); return; }
  f2_write(p.x, out);
  f2_write(p.y, out + 64);
}

extern "C" {

// out[i] = a_i + s * b_i over G2, one shared scalar s (the Dory reduce's
// per-level beta/alpha folds).  128B points + inf flags per side.
void jolt_g2_fold_batch(const uint8_t* av, const uint8_t* a_inf,
                        const uint8_t* bv, const uint8_t* b_inf,
                        const uint8_t* scalar /*32B LE*/, uint64_t n,
                        uint8_t* out, uint8_t* out_inf) {
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t nt = hw ? (hw < 8 ? hw : 8) : 1;
  if (nt > n / 64) nt = n / 64 ? n / 64 : 1;  // keep inversion batches big
  auto work = [&](uint64_t lo, uint64_t hi) {
    uint64_t m = hi - lo;
    std::vector<G2> acc(m, g2_inf()), base(m);
    std::vector<u64> ks(4 * m);
    std::vector<uint32_t> all;
    all.reserve(m);
    for (uint64_t i = 0; i < m; ++i) {
      base[i] = g2_read(bv + 128 * (lo + i), b_inf[lo + i]);
      memcpy(&ks[4 * i], scalar, 32);
      all.push_back((uint32_t)i);
    }
    g2_lanes_mul_acc(acc, base, ks);
    // acc += a (batched; G2 abelian so a + s*b == s*b + a)
    for (uint64_t i = 0; i < m; ++i)
      base[i] = g2_read(av + 128 * (lo + i), a_inf[lo + i]);
    g2_lanes_add(acc, base, all);
    for (uint64_t i = 0; i < m; ++i)
      g2_write(acc[i], out + 128 * (lo + i), out_inf + lo + i);
  };
  if (nt <= 1) { work(0, n); return; }
  std::vector<std::thread> ts;
  uint64_t chunk = (n + nt - 1) / nt;
  for (uint64_t t = 0; t < nt; ++t) {
    uint64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
    if (lo < hi) ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

// out[i] = scalar_i * Q_i.  g2s: n*128B, scalars: n*32B LE (mod r already),
// out: n*128B with an n-byte inf flag array.
void jolt_g2_mul_batch(const uint8_t* g2s, const uint8_t* scalars,
                       const uint8_t* in_inf, uint64_t n,
                       uint8_t* out, uint8_t* out_inf) {
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t nt = hw ? (hw < 8 ? hw : 8) : 1;
  if (nt > n / 64) nt = n / 64 ? n / 64 : 1;
  auto work = [&](uint64_t lo, uint64_t hi) {
    uint64_t m = hi - lo;
    std::vector<G2> acc(m, g2_inf()), base(m);
    std::vector<u64> ks(4 * m);
    for (uint64_t i = 0; i < m; ++i) {
      base[i] = g2_read(g2s + 128 * (lo + i), in_inf[lo + i]);
      memcpy(&ks[4 * i], scalars + 32 * (lo + i), 32);
    }
    g2_lanes_mul_acc(acc, base, ks);
    for (uint64_t i = 0; i < m; ++i)
      g2_write(acc[i], out + 128 * (lo + i), out_inf + lo + i);
  };
  if (nt <= 1) { work(0, n); }
  else {
    std::vector<std::thread> ts;
    uint64_t chunk = (n + nt - 1) / nt;
    for (uint64_t t = 0; t < nt; ++t) {
      uint64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
      if (lo < hi) ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
}

}  // extern "C"


extern "C" {

// prod of Miller loops (no final exp).  g1s: n*64B, g2s: n*128B,
// inf: n bytes (1 = skip).  out: 384B Fq12.
void jolt_miller_product(const uint8_t* g1s, const uint8_t* g2s,
                         const uint8_t* inf, uint64_t n, uint8_t* out) {
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t nt = hw ? (hw < 8 ? hw : 8) : 1;
  if (nt > n / 8) nt = n / 8 ? n / 8 : 1;  // keep batches big
  if (nt <= 1) {
    f12_write(miller_batch(g1s, g2s, inf, n), out);
    return;
  }
  // Miller loops are independent; the product is order-free (GT abelian).
  std::vector<Fq12> parts(nt, f12_one());
  std::vector<std::thread> ts;
  uint64_t chunk = (n + nt - 1) / nt;
  for (uint64_t t = 0; t < nt; ++t) {
    ts.emplace_back([&, t]() {
      uint64_t lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
      if (lo < hi)
        parts[t] = miller_batch(g1s + 64 * lo, g2s + 128 * lo, inf + lo,
                                hi - lo);
    });
  }
  for (auto& th : ts) th.join();
  Fq12 acc = f12_one();
  for (auto& p : parts) acc = f12_mul(acc, p);
  f12_write(acc, out);
}

void jolt_fq12_pow(const uint8_t* base, const uint8_t* exp_le,
                   uint64_t exp_len, uint8_t* out) {
  f12_write(f12_pow_bytes(f12_read(base), exp_le, exp_len), out);
}

void jolt_fq12_mul(const uint8_t* a, const uint8_t* b, uint8_t* out) {
  f12_write(f12_mul(f12_read(a), f12_read(b)), out);
}

}  // extern "C"

// ---------------- Fr (BN254 scalar field) vector kernels ----------------
// The Dory opening's phase-B folds / inner products and the combined-row
// build were Python big-int loops (tens of seconds per opening at 2^18);
// these kernels do the same mod-r arithmetic on 4x u64 limbs.
// I/O convention: CANONICAL little-endian 32-byte scalars.  Internally a
// single Montgomery factor rides the constant operand, so per-element
// cost is one CIOS multiply: mont_mul(x_canonical, c*R) = x*c canonical.

static const u64 FRL[4] = {0x43e1f593f0000001ull, 0x2833e84879b97091ull,
                           0xb85045b68181585dull, 0x30644e72e131a029ull};
static const u64 FR_R2[4] = {0x1bb8e645ae216da7ull, 0x53fe3ab1e35c59e3ull,
                             0x8c49833d53bb8085ull, 0x0216d0b17f4e44a5ull};
static const u64 FR_N0 = 0xc2e1f593efffffffull;

struct Fr { u64 l[4]; };

static inline bool fr_geq_r(const u64 a[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] > FRL[i]) return true;
    if (a[i] < FRL[i]) return false;
  }
  return true;
}
static inline void fr_sub_r(u64 a[4]) {
  u128 bor = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - FRL[i] - bor;
    a[i] = (u64)d; bor = (d >> 64) & 1;
  }
}
static inline Fr fr_add(const Fr& a, const Fr& b) {
  Fr r; u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.l[i] + b.l[i] + c;
    r.l[i] = (u64)s; c = s >> 64;
  }
  if (c || fr_geq_r(r.l)) fr_sub_r(r.l);
  return r;
}
static Fr fr_mul(const Fr& a, const Fr& b) {   // CIOS, mirrors fq_mul
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 c = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)t[j] + (u128)a.l[i] * b.l[j] + c;
      t[j] = (u64)s; c = s >> 64;
    }
    u128 s = (u128)t[4] + c;
    t[4] = (u64)s; t[5] = (u64)(s >> 64);
    u64 m = t[0] * FR_N0;
    c = ((u128)t[0] + (u128)m * FRL[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)t[j] + (u128)m * FRL[j] + c;
      t[j - 1] = (u64)s2; c = s2 >> 64;
    }
    s = (u128)t[4] + c;
    t[3] = (u64)s;
    t[4] = t[5] + (u64)(s >> 64);
    t[5] = 0;
  }
  Fr r;
  memcpy(r.l, t, 32);
  if (t[4] || fr_geq_r(r.l)) fr_sub_r(r.l);
  return r;
}
static inline Fr fr_read(const uint8_t* p) { Fr a; memcpy(a.l, p, 32); return a; }
static inline void fr_write(const Fr& a, uint8_t* p) { memcpy(p, a.l, 32); }
static inline Fr fr_to_mont(const Fr& a) {
  Fr r2; memcpy(r2.l, FR_R2, 32);
  return fr_mul(a, r2);
}

extern "C" {

// out[i] = alpha * a[i] + b[i]  (canonical 32B LE lanes; threaded)
void jolt_fr_fold(const uint8_t* a, const uint8_t* b, const uint8_t* alpha,
                  u64 n, uint8_t* out) {
  Fr am = fr_to_mont(fr_read(alpha));
  unsigned hw = std::thread::hardware_concurrency();
  u64 nt = hw ? (hw < 8 ? hw : 8) : 1;
  if (nt > n / 4096) nt = n / 4096 ? n / 4096 : 1;
  auto run = [&](u64 lo, u64 hi) {
    for (u64 i = lo; i < hi; ++i)
      fr_write(fr_add(fr_mul(fr_read(a + 32 * i), am), fr_read(b + 32 * i)),
               out + 32 * i);
  };
  if (nt <= 1) { run(0, n); return; }
  std::vector<std::thread> ts;
  u64 chunk = (n + nt - 1) / nt;
  for (u64 t = 0; t < nt; ++t) {
    u64 lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
    if (lo < hi) ts.emplace_back(run, lo, hi);
  }
  for (auto& th : ts) th.join();
}

// out32 = sum_i a[i] * b[i]  (canonical)
void jolt_fr_dot(const uint8_t* a, const uint8_t* b, u64 n, uint8_t* out) {
  unsigned hw = std::thread::hardware_concurrency();
  u64 nt = hw ? (hw < 8 ? hw : 8) : 1;
  if (nt > n / 4096) nt = n / 4096 ? n / 4096 : 1;
  std::vector<Fr> parts(nt);
  auto run = [&](u64 t, u64 lo, u64 hi) {
    Fr acc; memset(acc.l, 0, 32);
    for (u64 i = lo; i < hi; ++i)
      acc = fr_add(acc, fr_mul(fr_read(a + 32 * i), fr_read(b + 32 * i)));
    parts[t] = acc;
  };
  if (nt <= 1) run(0, 0, n);
  else {
    std::vector<std::thread> ts;
    u64 chunk = (n + nt - 1) / nt;
    for (u64 t = 0; t < nt; ++t) {
      u64 lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
      ts.emplace_back(run, t, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
  Fr acc; memset(acc.l, 0, 32);
  for (u64 t = 0; t < nt; ++t) acc = fr_add(acc, parts[t]);
  // lanes multiplied as mont_mul(a, b) = a*b*R^-1; fix with one *R^2*R^-1
  fr_write(fr_to_mont(acc), out);
}

// Combined-row accumulation for one sparse RLC part:
//   acc[cols[i]] += w * L[rows[i]] * (vals ? vals[i] : 1)
// (vals may be NULL -- the one-hot fast path).  Canonical I/O; the
// Montgomery factors ride the scalar w.  ncols > 0 enables threading:
// entry ranges split across threads into private length-ncols
// accumulators, merged into acc at the end (mod-r addition commutes, so
// the result is bit-identical to the sequential order).
void jolt_fr_rlc_rows_nc(const uint32_t* rows, const uint32_t* cols,
                         const uint8_t* vals, const uint8_t* w, u64 n,
                         const uint8_t* L, uint8_t* acc, u64 ncols) {
  Fr wm = fr_to_mont(fr_read(w));
  if (vals) wm = fr_to_mont(wm);   // two pending R^-1 factors
  auto run = [&](u64 lo, u64 hi, uint8_t* out) {
    for (u64 i = lo; i < hi; ++i) {
      Fr term = fr_mul(fr_read(L + 32ull * rows[i]), wm);
      if (vals) term = fr_mul(term, fr_read(vals + 32 * i));
      Fr s = fr_add(fr_read(out + 32ull * cols[i]), term);
      fr_write(s, out + 32ull * cols[i]);
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  u64 nt = hw ? (hw < 8 ? hw : 8) : 1;
  if (!ncols || n < 4 * ncols || nt <= 1) { run(0, n, acc); return; }
  std::vector<std::vector<uint8_t>> priv(nt);
  std::vector<std::thread> ts;
  u64 chunk = (n + nt - 1) / nt;
  for (u64 t = 0; t < nt; ++t) {
    u64 lo = t * chunk, hi = lo + chunk > n ? n : lo + chunk;
    if (lo >= hi) continue;
    priv[t].assign(32 * ncols, 0);
    ts.emplace_back([&, t, lo, hi]() { run(lo, hi, priv[t].data()); });
  }
  for (auto& th : ts) th.join();
  for (u64 t = 0; t < nt; ++t) {
    if (priv[t].empty()) continue;
    for (u64 c = 0; c < ncols; ++c) {
      Fr s = fr_add(fr_read(acc + 32 * c), fr_read(priv[t].data() + 32 * c));
      fr_write(s, acc + 32 * c);
    }
  }
}

// back-compat single-threaded entry (no column count known)
void jolt_fr_rlc_rows(const uint32_t* rows, const uint32_t* cols,
                      const uint8_t* vals, const uint8_t* w, u64 n,
                      const uint8_t* L, uint8_t* acc) {
  jolt_fr_rlc_rows_nc(rows, cols, vals, w, n, L, acc, 0);
}

}  // extern "C"
