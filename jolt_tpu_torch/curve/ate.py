"""BN254 optimal ate pairing with prepared G2 line coefficients.

Copied from the JAX package's `curve/ate.py`, logic unchanged (the
Python tier of `pairing.pairing_product`).  The original notes follow.

Replaces the Tate pairing (pairing.py) on every hot path.  Two wins over
Tate and the plain (q^12-1)/r final exponentiation:

  * Miller loop over 6x+2 (~65 bits) instead of r (254 bits), with the
    loop taken on the G2 argument -- so for a FIXED Q every line
    coefficient is precomputable (`g2_prepare`, the arkworks G2Prepared
    pattern).  At eval time each line costs 2 Fq scalings + one sparse
    Fq12 mul; no modular inversions.
  * Final exponentiation split into the easy part (q^6-1)(q^2+1) -- one
    inverse, two Frobenius, two muls -- and the hard part
    (q^4 - q^2 + 1)/r by a 762-bit pow, ~4x less work than the full pow.

Matches the reference verifier's arkworks `Bn254::multi_pairing`
(`ark-bn254` optimal ate) in loop structure, which is the wire-parity
target for Dory tier-2 GT commitments.

The prepared-coefficient layout (one (lambda, d) Fq2 pair per step, a
static doubling/addition schedule shared by all Q) is consumed unchanged
by the device-batched Miller kernel (pairing_device.py): lines depend on
the G1 argument only through the two scalings by x_P, y_P.

Derivation (D-type twist, xi = 9+u, psi(x,y) = (x w^2, y w^3)): the line
through psi(T) with twist-slope lambda evaluated at P = (xp, yp) is
    l = yp - (lambda xp) w + (lambda x_T - y_T) v w,
a sparse element A + (B + C v) w with A in Fq, B, C in Fq2; C is
P-independent, hence preparable.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..field.params import FQ_MODULUS as Q
from ..field.params import FR_MODULUS as R
from .bn254_host import Point
from .fq_tower import XI, Fq2, Fq6, Fq12
from .pairing import G2Point, g2_add, g2_neg

BN_X = 4965661367192848881          # BN254 curve parameter (positive)
ATE_LOOP = 6 * BN_X + 2
# MSB-first bits after the leading 1: the doubling/addition schedule,
# identical for every Q (device kernel relies on this being static).
ATE_BITS: Tuple[int, ...] = tuple(int(b) for b in bin(ATE_LOOP)[3:])

# Frobenius constants: g = xi^((q-1)/6); coefficient of v^i w^j picks up
# conj() and a factor g^(2i+j) under x -> x^q.
_G = XI.pow((Q - 1) // 6)
_FROB_G = [Fq2.ONE] + [_G.pow(k) for k in range(1, 6)]
# Twist Frobenius: pi(x, y) = (conj(x) g^2, conj(y) g^3) on E'(Fq2).
_TW_X, _TW_Y = _FROB_G[2], _FROB_G[3]
_HARD_EXP = (Q ** 4 - Q ** 2 + 1) // R


def fq12_frob(f: Fq12, power: int = 1) -> Fq12:
    """f^(q^power) via coefficient conjugation + gamma scaling."""
    for _ in range(power):
        cs = []
        for j, c6 in enumerate((f.c0, f.c1)):
            cs.append(Fq6(*(c6i.conj() * _FROB_G[(2 * i + j) % 6]
                            for i, c6i in enumerate((c6.c0, c6.c1, c6.c2)))))
        f = Fq12(cs[0], cs[1])
    return f


# ---------------------------------------------------------------------------
# preparation (host, once per G2 point; affine -- inversions are fine here)
# ---------------------------------------------------------------------------

def _affine_step(t: G2Point, s: G2Point) -> Tuple[G2Point, Fq2, Fq2]:
    """One affine double (s is t) or add (s != t); returns
    (t', lambda, d = lambda*x_t - y_t)."""
    xt, yt = t
    if s is t:
        lam = (xt.sqr() * 3) * (yt * 2).inv()
    else:
        xs, ys = s
        assert xt != xs, "degenerate addition in ate preparation"
        lam = (yt - ys) * (xt - xs).inv()
        xt, yt = xt, yt  # line anchored at t
    d = lam * t[0] - t[1]
    x3 = lam.sqr() - t[0] - (s[0] if s is not t else t[0])
    y3 = lam * (t[0] - x3) - t[1]
    return (x3, y3), lam, d


class G2Prepared:
    """Static line-coefficient table for a fixed Q: coeffs[k] = (lam, d),
    in schedule order (one doubling per ATE_BITS entry, one addition per
    1-bit, then the two Frobenius additions)."""

    __slots__ = ("coeffs",)

    def __init__(self, coeffs: List[Tuple[Fq2, Fq2]]):
        self.coeffs = coeffs


def g2_prepare(q: G2Point) -> Optional[G2Prepared]:
    if q is None:
        return None
    coeffs: List[Tuple[Fq2, Fq2]] = []
    t = q
    for b in ATE_BITS:
        t, lam, d = _affine_step(t, t)
        coeffs.append((lam, d))
        if b:
            t, lam, d = _affine_step(t, q)
            coeffs.append((lam, d))
    xq, yq = q
    q1 = (xq.conj() * _TW_X, yq.conj() * _TW_Y)
    q2 = g2_neg((q1[0].conj() * _TW_X, q1[1].conj() * _TW_Y))
    t, lam, d = _affine_step(t, q1)
    coeffs.append((lam, d))
    t, lam, d = _affine_step(t, q2)
    coeffs.append((lam, d))
    return G2Prepared(coeffs)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _sparse_line_mul(f: Fq12, a: int, b: Fq2, c: Fq2) -> Fq12:
    """f * (a + (b + c v) w), a in Fq."""
    f0, f1 = f.c0, f.c1
    # s = b + c v:  f6 * s  (v^3 = xi)
    def mul_s(x: Fq6) -> Fq6:
        return Fq6(x.c0 * b + (x.c2 * c) * XI,
                   x.c0 * c + x.c1 * b,
                   x.c1 * c + x.c2 * b)
    r0 = Fq6(f0.c0 * a, f0.c1 * a, f0.c2 * a) + mul_s(f1).mul_by_v()
    r1 = Fq6(f1.c0 * a, f1.c1 * a, f1.c2 * a) + mul_s(f0)
    return Fq12(r0, r1)


def ate_miller(p: Point, prep: Optional[G2Prepared]) -> Fq12:
    """Miller value f_{6x+2,Q}(P) * (frobenius lines); final exp separate."""
    if p is None or prep is None:
        return Fq12.one()
    xp, yp = p
    nxp = (-xp) % Q
    it = iter(prep.coeffs)

    def line(f: Fq12) -> Fq12:
        lam, d = next(it)
        return _sparse_line_mul(f, yp, lam * nxp, d)

    f = Fq12.one()
    first = True
    for bbit in ATE_BITS:
        if not first:
            f = f.sqr()
        first = False
        f = line(f)
        if bbit:
            f = line(f)
    f = line(f)
    f = line(f)
    return f


def final_exp_fast(f: Fq12) -> Fq12:
    """(q^12-1)/r in two parts; after the easy part f is in the cyclotomic
    subgroup (where inverse = conjugate, used by GT-inverse callers)."""
    f1 = f.conj() * f.inv()                 # f^(q^6 - 1)
    f2 = fq12_frob(f1, 2) * f1              # ^(q^2 + 1)
    return f2.pow(_HARD_EXP)                # ^(q^4 - q^2 + 1)/r


def ate_pairing(p: Point, q: G2Point) -> Fq12:
    return final_exp_fast(ate_miller(p, g2_prepare(q)))


def multi_pairing(pairs: Sequence[Tuple[Point, G2Point]]) -> Fq12:
    """prod e(P_i, Q_i), one shared final exponentiation."""
    acc = Fq12.one()
    for p, q in pairs:
        acc = acc * ate_miller(p, g2_prepare(q))
    return final_exp_fast(acc)


def multi_pairing_prepared(
        pairs: Sequence[Tuple[Point, Optional[G2Prepared]]]) -> Fq12:
    acc = Fq12.one()
    for p, prep in pairs:
        acc = acc * ate_miller(p, prep)
    return final_exp_fast(acc)
