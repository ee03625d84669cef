"""BN254 pairing (host-side entry points) + G2 affine arithmetic.

Copied from the JAX package's `curve/pairing.py`, logic unchanged
(`final_exp` and `pairing_product` route to the native library built
from `csrc/pairing.cpp`).  The original notes follow.

Production pairing: the OPTIMAL ATE (Miller loop over 6x+2, ~65 bits --
curve/ate.py is the Python oracle, csrc/pairing.cpp the batched C++
production tier; values agree exactly).  `pairing_product` is the
workhorse for Dory tier-2 commits / reduce rounds and KZG verification;
switching from the original Tate tier (254-bit loop) was a ~10x
throughput win on the commit path.

`miller` below retains the legacy Tate Miller loop SOLELY as an
independent cross-check oracle for bilinearity tests -- its values are a
fixed-exponent power of the ate pairing's and must NOT be mixed with
`pairing_product` results.
"""

from __future__ import annotations

from typing import List, Tuple


from ..field.params import FQ_MODULUS as Q
from ..field.params import FR_MODULUS as R
from .fq_tower import Fq2, Fq12


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


def final_exp(f: Fq12) -> Fq12:
    return f.pow(_FINAL_EXP)


def tate_pairing(p: Point, q: G2Point) -> Fq12:
    """e(P, Q) for P in G1 (affine ints), Q in G2 (affine Fq2).

    NB the name is historical: this is the production (optimal-ate)
    pairing; every caller in the scheme uses it consistently."""
    return pairing_product([(p, q)])


def pairing_product(pairs: List[Tuple[Point, G2Point]]) -> Fq12:
    """prod e(P_i, Q_i) with ONE shared final exponentiation.

    The benchmark's copy computes it on Python ints alone (curve/ate.py),
    with no native library."""
    from .ate import ate_miller, g2_prepare
    acc = Fq12.one()
    for p, q in pairs:
        acc = acc * ate_miller(p, g2_prepare(q))
    return final_exp(acc)
