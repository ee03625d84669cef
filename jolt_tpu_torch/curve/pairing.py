"""BN254 pairing (host-side entry points) + G2 affine arithmetic.

Copied from the JAX package's `curve/pairing.py`, logic unchanged except
`final_exp` and `pairing_product`, which keep only their Python tier
(`ate.py`): the JAX package also routes them to a native C++ library,
which the port gains with Dory (ROADMAP A11); both give the same values.
The original notes follow.

Production pairing: the OPTIMAL ATE (Miller loop over 6x+2, ~65 bits --
curve/ate.py is the Python oracle, the JAX package's native pairing the
batched C++ production tier; values agree exactly).  `pairing_product` is the
workhorse for Dory tier-2 commits / reduce rounds and KZG verification;
switching from the original Tate tier (254-bit loop) was a ~10x
throughput win on the commit path.

`miller` below retains the legacy Tate Miller loop SOLELY as an
independent cross-check oracle for bilinearity tests -- its values are a
fixed-exponent power of the ate pairing's and must NOT be mixed with
`pairing_product` results.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..field.params import FQ_MODULUS as Q
from ..field.params import FR_MODULUS as R
from .bn254_host import Point
from .fq_tower import Fq2, Fq6, Fq12

# G2 generator (ark_bn254)
G2_GEN = (
    Fq2(10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634),
    Fq2(8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

G2Point = Optional[Tuple[Fq2, Fq2]]

_FINAL_EXP = (Q ** 12 - 1) // R


# ---------------------------------------------------------------------------
# G2 affine arithmetic (for SRS generation)
# ---------------------------------------------------------------------------

def g2_add(p: G2Point, q: G2Point) -> G2Point:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        lam = (x1.sqr() * 3) * (y1 * 2).inv()
    else:
        lam = (y2 - y1) * (x2 - x1).inv()
    x3 = lam.sqr() - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def g2_neg(p: G2Point) -> G2Point:
    return None if p is None else (p[0], -p[1])


def g2_mul(p: G2Point, k: int) -> G2Point:
    """[k mod r] P -- correct ONLY for points in the r-torsion subgroup.
    Cofactor clearing must use `g2_mul_unreduced` (the reduction here
    silently turned the G2 cofactor into `c2 mod r`, leaving hash-to-curve
    outputs OUTSIDE the r-torsion -- harmless under the old Tate tier,
    fatal for the optimal-ate pairing's eigenspace requirement)."""
    return g2_mul_unreduced(p, k % R)


def g2_mul_unreduced(p: G2Point, k: int) -> G2Point:
    """[k] P without reducing k mod r (cofactor clearing, subgroup checks)."""
    acc: G2Point = None
    add = p
    while k:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_add(add, add)
        k >>= 1
    return acc


def g2_in_subgroup(p: G2Point) -> bool:
    """p in the order-r subgroup of E'(Fq2): on-curve and [r] p == O.
    Required before feeding adversarial G2 elements to the ate pairing."""
    if p is None:
        return True
    return g2_is_on_curve(p) and g2_mul_unreduced(p, R) is None


def g2_is_on_curve(p: G2Point) -> bool:
    if p is None:
        return True
    x, y = p
    b = Fq2(3) * Fq2(9, 1).inv()  # 3/xi
    return y.sqr() == x.sqr() * x + b


# ---------------------------------------------------------------------------
# Miller loop (Tate)
# ---------------------------------------------------------------------------

def _psi_coords(q: G2Point):
    """(x_Q w^2, y_Q w^3) as sparse Fq12 elements."""
    xq, yq = q
    x12 = Fq12(Fq6(Fq2.ZERO, xq, Fq2.ZERO), Fq6.zero())        # x_Q * v
    y12 = Fq12(Fq6.zero(), Fq6(Fq2.ZERO, yq, Fq2.ZERO))        # y_Q * v * w
    return x12, y12


def _line(ax: int, ay: int, lam: int, xq12: Fq12, yq12: Fq12) -> Fq12:
    """l(psiQ) = (y - ay) - lam*(x - ax) with a, lam in Fq."""
    c = (lam * ax - ay) % Q
    const = Fq12(Fq6(Fq2(c), Fq2.ZERO, Fq2.ZERO), Fq6.zero())
    lam12_x = Fq12(Fq6(Fq2.ZERO, Fq2((-lam) % Q) * xq12.c0.c1, Fq2.ZERO), Fq6.zero())
    return yq12 + lam12_x + const


def miller(p: Point, q: G2Point) -> Fq12:
    """Miller loop of the Tate pairing (NO final exponentiation).

    The final exp costs ~6x the Miller loop; products of pairings share ONE
    final exp via `final_exp(prod miller_i)` -- the workhorse of Dory's
    tier-2 commits and reduce rounds."""
    if p is None or q is None:
        return Fq12.one()
    xq12, yq12 = _psi_coords(q)
    xp, yp = p
    f = Fq12.one()
    tx, ty = xp, yp
    bits = bin(R)[3:]  # skip leading 1 (start from T = P)
    for b in bits:
        # tangent at T
        lam = (3 * tx * tx) * pow(2 * ty, -1, Q) % Q
        f = f.sqr() * _line(tx, ty, lam, xq12, yq12)
        # T = 2T
        x3 = (lam * lam - 2 * tx) % Q
        ty = (lam * (tx - x3) - ty) % Q
        tx = x3
        if b == "1":
            if tx == xp and (ty + yp) % Q == 0:
                # T == -P: the chord is the vertical line (subfield, killed
                # by final exp) and T+P = infinity.  Only happens at the
                # final addition (k = r-1); the loop ends here.
                break
            # chord through T and P
            lam = (ty - yp) * pow(tx - xp, -1, Q) % Q
            f = f * _line(tx, ty, lam, xq12, yq12)
            x3 = (lam * lam - tx - xp) % Q
            ty = (lam * (tx - x3) - ty) % Q
            tx = x3
    return f


def final_exp(f: Fq12) -> Fq12:
    return f.pow(_FINAL_EXP)


def tate_pairing(p: Point, q: G2Point) -> Fq12:
    """e(P, Q) for P in G1 (affine ints), Q in G2 (affine Fq2).

    NB the name is historical: this is the production (optimal-ate)
    pairing; every caller in the scheme uses it consistently."""
    return pairing_product([(p, q)])


def pairing_product(pairs: List[Tuple[Point, G2Point]]) -> Fq12:
    """prod e(P_i, Q_i) with ONE shared final exponentiation (the optimal-
    ate Miller loops of curve/ate.py)."""
    from .ate import ate_miller, g2_prepare
    acc = Fq12.one()
    for p, q in pairs:
        acc = acc * ate_miller(p, g2_prepare(q))
    return final_exp(acc)


def pairing_product_is_one(pairs: List[Tuple[Point, G2Point]]) -> bool:
    """prod e(P_i, Q_i) == 1 -- the KZG / Dory verification predicate."""
    return pairing_product(pairs).is_one()
