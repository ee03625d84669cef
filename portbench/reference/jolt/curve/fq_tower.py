"""BN254 extension-field tower: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - xi),
Fq12 = Fq6[w]/(w^2 - v), xi = 9 + u.

Copied from the JAX package's `curve/fq_tower.py`, logic unchanged.

Host-side Python ints -- used only for pairings (Dory tier-2 / KZG verify),
which are few; SURVEY.md §7 hard-part 5 keeps them off-device.
"""

from __future__ import annotations


from ..field.params import FQ_MODULUS as Q


class Fq2:
    __slots__ = ("a", "b")  # a + b*u

    def __init__(self, a: int, b: int = 0):
        self.a = a % Q
        self.b = b % Q

    ZERO: "Fq2"
    ONE: "Fq2"

    def __add__(s, o):
        return Fq2(s.a + o.a, s.b + o.b)

    def __sub__(s, o):
        return Fq2(s.a - o.a, s.b - o.b)

    def __neg__(s):
        return Fq2(-s.a, -s.b)

    def __mul__(s, o):
        if isinstance(o, int):
            return Fq2(s.a * o, s.b * o)
        # (a+bu)(c+du) = (ac - bd) + (ad + bc)u
        ac, bd = s.a * o.a, s.b * o.b
        return Fq2(ac - bd, (s.a + s.b) * (o.a + o.b) - ac - bd)

    __rmul__ = __mul__

    def sqr(s):
        # (a+bu)^2 = (a+b)(a-b) + 2ab u
        return Fq2((s.a + s.b) * (s.a - s.b), 2 * s.a * s.b)

    def inv(s):
        d = pow(s.a * s.a + s.b * s.b, -1, Q)
        return Fq2(s.a * d, -s.b * d)

    def conj(s):
        return Fq2(s.a, -s.b)

    def pow(s, e: int):
        out = Fq2.ONE
        base = s
        while e:
            if e & 1:
                out = out * base
            base = base.sqr()
            e >>= 1
        return out

    def __eq__(s, o):
        return s.a == o.a and s.b == o.b

    def __hash__(s):
        return hash((s.a, s.b))

    def is_zero(s):
        return s.a == 0 and s.b == 0

    def __repr__(s):
        return f"Fq2({s.a},{s.b})"


Fq2.ZERO = Fq2(0)
Fq2.ONE = Fq2(1)
XI = Fq2(9, 1)  # the sextic-twist non-residue


class Fq6:
    __slots__ = ("c0", "c1", "c2")  # c0 + c1 v + c2 v^2

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero():
        return Fq6(Fq2.ZERO, Fq2.ZERO, Fq2.ZERO)

    @staticmethod
    def one():
        return Fq6(Fq2.ONE, Fq2.ZERO, Fq2.ZERO)

    def __add__(s, o):
        return Fq6(s.c0 + o.c0, s.c1 + o.c1, s.c2 + o.c2)

    def __sub__(s, o):
        return Fq6(s.c0 - o.c0, s.c1 - o.c1, s.c2 - o.c2)

    def __neg__(s):
        return Fq6(-s.c0, -s.c1, -s.c2)

    def __mul__(s, o):
        if isinstance(o, Fq2):
            return Fq6(s.c0 * o, s.c1 * o, s.c2 * o)
        a0, a1, a2 = s.c0, s.c1, s.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2) * XI + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def sqr(s):
        return s * s

    def mul_by_v(s):
        # v * (c0 + c1 v + c2 v^2) = c2 xi + c0 v + c1 v^2
        return Fq6(s.c2 * XI, s.c0, s.c1)

    def inv(s):
        a, b, c = s.c0, s.c1, s.c2
        A = a.sqr() - (b * c) * XI
        B = c.sqr() * XI - a * b
        C = b.sqr() - a * c
        t = (a * A + (c * B + b * C) * XI).inv()
        return Fq6(A * t, B * t, C * t)

    def __eq__(s, o):
        return s.c0 == o.c0 and s.c1 == o.c1 and s.c2 == o.c2

    def is_zero(s):
        return s.c0.is_zero() and s.c1.is_zero() and s.c2.is_zero()


class Fq12:
    __slots__ = ("c0", "c1")  # c0 + c1 w

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one():
        return Fq12(Fq6.one(), Fq6.zero())

    def __add__(s, o):
        return Fq12(s.c0 + o.c0, s.c1 + o.c1)

    def __sub__(s, o):
        return Fq12(s.c0 - o.c0, s.c1 - o.c1)

    def __mul__(s, o):
        a0, a1 = s.c0, s.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def sqr(s):
        return s * s

    def conj(s):
        return Fq12(s.c0, -s.c1)

    def inv(s):
        t = (s.c0.sqr() - s.c1.sqr().mul_by_v()).inv()
        return Fq12(s.c0 * t, -(s.c1 * t))

    def pow(s, e: int):
        out = Fq12.one()
        base = s
        while e:
            if e & 1:
                out = out * base
            base = base.sqr()
            e >>= 1
        return out

    def __eq__(s, o):
        return s.c0 == o.c0 and s.c1 == o.c1

    def is_one(s):
        return s == Fq12.one()
