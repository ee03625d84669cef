"""Host-side BN254 arithmetic over Python ints (ground truth + cold paths).

Copied from the JAX package's `curve/bn254_host.py`, logic unchanged
except `g1_msm_pippenger`, which keeps only its Python tier: the JAX
package also routes it to a native C++ MSM, which the port gains with
Dory (ROADMAP A11); both give the same group element.  The original
notes follow.

G1: y^2 = x^3 + 3 over Fq.  G2: y^2 = x^3 + 3/(9+u) over Fq2.
The host tier serves as the test oracle for the device kernels and will
carry the pairing (Dory tier-2) -- pairings are few and host-side per
SURVEY.md §7 hard-part 5.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..field.params import FQ_MODULUS, FR_MODULUS

Q = FQ_MODULUS
R = FR_MODULUS

# Generator of G1 (ark_bn254: (1, 2))
G1_GEN = (1, 2)

Point = Optional[Tuple[int, int]]  # None = infinity


def g1_is_on_curve(p: Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - 3) % Q == 0


def g1_neg(p: Point) -> Point:
    if p is None:
        return None
    return (p[0], (-p[1]) % Q)


def g1_add(p: Point, q: Point) -> Point:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def g1_double(p: Point) -> Point:
    return g1_add(p, p)


def g1_mul(p: Point, k: int) -> Point:
    k %= R
    acc: Point = None
    add = p
    while k:
        if k & 1:
            acc = g1_add(acc, add)
        add = g1_double(add)
        k >>= 1
    return acc


def g1_random(rng) -> Point:
    """Random G1 point: random scalar times the generator."""
    return g1_mul(G1_GEN, rng.randrange(1, R))


def g1_msm(points, scalars) -> Point:
    acc: Point = None
    for p, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(p, s))
    return acc


# ---------------------------------------------------------------------------
# Jacobian arithmetic + Pippenger MSM (host reference tier)
#
# Python-int Jacobian formulas (no modular inversions in the hot loop) --
# this is the CPU-test-tier MSM: XLA:CPU compiles of the wide device MSM
# graphs cost minutes per shape, while ~mu-s/add host Pippenger handles the
# test sizes in seconds with zero compile.  The TPU path (curve/g1.py) is
# unaffected.  Mirrors the arkworks dispatch the reference links
# (`crates/jolt-prover-legacy/src/msm/mod.rs:16-80`): zero scalars are
# skipped entirely ("pay-per-bit").
# ---------------------------------------------------------------------------

JPoint = Optional[Tuple[int, int, int]]  # Jacobian; None = infinity


def _jac_double(p: JPoint) -> JPoint:
    if p is None:
        return None
    X, Y, Z = p
    if Y == 0:
        return None
    A = X * X % Q
    B = Y * Y % Q
    C = B * B % Q
    D = 2 * ((X + B) * (X + B) - A - C) % Q
    E = 3 * A % Q
    F = E * E % Q
    X3 = (F - 2 * D) % Q
    Y3 = (E * (D - X3) - 8 * C) % Q
    Z3 = 2 * Y * Z % Q
    return (X3, Y3, Z3)


def _jac_add(p: JPoint, q: JPoint) -> JPoint:
    if p is None:
        return q
    if q is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    if U1 == U2:
        if S1 != S2:
            return None
        return _jac_double(p)
    H = (U2 - U1) % Q
    I = 4 * H * H % Q
    J = H * I % Q
    rr = 2 * (S2 - S1) % Q
    V = U1 * I % Q
    X3 = (rr * rr - J - 2 * V) % Q
    Y3 = (rr * (V - X3) - 2 * S1 * J) % Q
    Z3 = 2 * H * Z1 * Z2 % Q
    return (X3, Y3, Z3)


def _jac_mixed_add(p: JPoint, q: Point) -> JPoint:
    """p (Jacobian) + q (affine, Z=1): saves ~4 muls vs full add."""
    if q is None:
        return p
    if p is None:
        return (q[0], q[1], 1)
    X1, Y1, Z1 = p
    X2, Y2 = q
    Z1Z1 = Z1 * Z1 % Q
    U2 = X2 * Z1Z1 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    if X1 == U2:
        if Y1 != S2:
            return None
        return _jac_double(p)
    H = (U2 - X1) % Q
    HH = H * H % Q
    I = 4 * HH % Q
    J = H * I % Q
    rr = 2 * (S2 - Y1) % Q
    V = X1 * I % Q
    X3 = (rr * rr - J - 2 * V) % Q
    Y3 = (rr * (V - X3) - 2 * Y1 * J) % Q
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % Q
    return (X3, Y3, Z3)


def jac_to_affine(p: JPoint) -> Point:
    if p is None:
        return None
    X, Y, Z = p
    zi = pow(Z, -1, Q)
    zi2 = zi * zi % Q
    return (X * zi2 % Q, Y * zi2 * zi % Q)


def g1_msm_pippenger(points, scalars, c: int = 8) -> Point:
    """Windowed-bucket MSM over affine base points with zero-skip.

    Cost ~ n_windows * (nnz mixed-adds + 2^(c+1) adds); one-hot/binary
    vectors (nnz << N) cost almost nothing."""
    nz = [(p, s % R) for p, s in zip(points, scalars)
          if s % R != 0 and p is not None]
    if not nz:
        return None
    bits = max(s.bit_length() for _, s in nz)
    n_win = (bits + c - 1) // c
    total: JPoint = None
    for w in range(n_win - 1, -1, -1):
        if total is not None:
            for _ in range(c):
                total = _jac_double(total)
        buckets: dict = {}
        shift = w * c
        mask = (1 << c) - 1
        for pt, s in nz:
            d = (s >> shift) & mask
            if d:
                buckets[d] = _jac_mixed_add(buckets.get(d), pt)
        if not buckets:
            continue
        run: JPoint = None
        acc: JPoint = None
        for d in range(max(buckets), 0, -1):
            b = buckets.get(d)
            if b is not None:
                run = _jac_add(run, b)
            acc = _jac_add(acc, run)
        total = _jac_add(total, acc)
    return jac_to_affine(total)
