"""Symbolic sumcheck summands: the `Expr` protocol-algebra layer.

Copied from the JAX package's `claims/expr.py` (host code, logic
unchanged).

Analog of the reference's `jolt-claims` Expr type
(`crates/jolt-claims/src/claims.rs`; design in
`specs/clean-slate-prover.md:30-34`): a relation's sumcheck summand is a
small expression tree over four leaf kinds --

  * `Poly(name)`      -- a multilinear polynomial opening (witness column,
                         eq table, public table MLE, ...)
  * `Challenge(name)` -- a verifier challenge (gamma powers, batching
                         coefficients) known before the sumcheck starts
  * `Const(value)`    -- a field constant
  * products / sums / differences of the above

The Expr *is* the relation: the naive interpreter (claims/naive.py) can
prove any relation directly from its Expr + leaf polynomials, giving every
optimized device kernel a free reference prover to be equivalence-tested
against (the reference's `NaiveSumcheckProver` pattern,
`crates/jolt-kernels` reference tier, SURVEY.md §4.2).

Exprs are host-side objects over Python ints mod p -- they never touch the
device; they exist for specification, degree accounting, and the naive
tier.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence

from ..field.params import FR

P = FR.modulus


class Expr:
    """Base class; nodes overload + - * for construction."""

    def __add__(self, other) -> "Expr":
        return Add(self, _lift(other))

    def __radd__(self, other) -> "Expr":
        return Add(_lift(other), self)

    def __sub__(self, other) -> "Expr":
        return Add(self, Neg(_lift(other)))

    def __rsub__(self, other) -> "Expr":
        return Add(_lift(other), Neg(self))

    def __mul__(self, other) -> "Expr":
        return Mul(self, _lift(other))

    def __rmul__(self, other) -> "Expr":
        return Mul(_lift(other), self)

    def __neg__(self) -> "Expr":
        return Neg(self)

    # ---- analysis --------------------------------------------------------

    def degree(self) -> int:
        """Total degree in the polynomial leaves (each Poly leaf is
        multilinear, so per-variable degree of the summand <= degree())."""
        raise NotImplementedError

    def poly_leaves(self) -> FrozenSet[str]:
        raise NotImplementedError

    def challenge_leaves(self) -> FrozenSet[str]:
        raise NotImplementedError

    def evaluate(self, polys: Dict[str, int],
                 challenges: Dict[str, int]) -> int:
        """Pointwise evaluation: every Poly leaf mapped to a field value."""
        raise NotImplementedError


def _lift(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, int):
        return Const(v)
    raise TypeError(f"cannot lift {type(v).__name__} into Expr")


class Const(Expr):
    def __init__(self, value: int):
        self.value = value % P

    def degree(self) -> int:
        return 0

    def poly_leaves(self):
        return frozenset()

    def challenge_leaves(self):
        return frozenset()

    def evaluate(self, polys, challenges) -> int:
        return self.value

    def __repr__(self):
        return f"{self.value}"


class Poly(Expr):
    """A multilinear polynomial leaf, referenced by name (resolved to a
    coefficient vector by the naive prover / to an opening claim by the
    verifier side)."""

    def __init__(self, name: str):
        self.name = name

    def degree(self) -> int:
        return 1

    def poly_leaves(self):
        return frozenset((self.name,))

    def challenge_leaves(self):
        return frozenset()

    def evaluate(self, polys, challenges) -> int:
        return polys[self.name] % P

    def __repr__(self):
        return self.name


class Challenge(Expr):
    def __init__(self, name: str):
        self.name = name

    def degree(self) -> int:
        return 0

    def poly_leaves(self):
        return frozenset()

    def challenge_leaves(self):
        return frozenset((self.name,))

    def evaluate(self, polys, challenges) -> int:
        return challenges[self.name] % P

    def __repr__(self):
        return f"${self.name}"


class Add(Expr):
    def __init__(self, a: Expr, b: Expr):
        self.a, self.b = a, b

    def degree(self) -> int:
        return max(self.a.degree(), self.b.degree())

    def poly_leaves(self):
        return self.a.poly_leaves() | self.b.poly_leaves()

    def challenge_leaves(self):
        return self.a.challenge_leaves() | self.b.challenge_leaves()

    def evaluate(self, polys, challenges) -> int:
        return (self.a.evaluate(polys, challenges)
                + self.b.evaluate(polys, challenges)) % P

    def __repr__(self):
        return f"({self.a} + {self.b})"


class Neg(Expr):
    def __init__(self, a: Expr):
        self.a = a

    def degree(self) -> int:
        return self.a.degree()

    def poly_leaves(self):
        return self.a.poly_leaves()

    def challenge_leaves(self):
        return self.a.challenge_leaves()

    def evaluate(self, polys, challenges) -> int:
        return (-self.a.evaluate(polys, challenges)) % P

    def __repr__(self):
        return f"(-{self.a})"


class Mul(Expr):
    def __init__(self, a: Expr, b: Expr):
        self.a, self.b = a, b

    def degree(self) -> int:
        return self.a.degree() + self.b.degree()

    def poly_leaves(self):
        return self.a.poly_leaves() | self.b.poly_leaves()

    def challenge_leaves(self):
        return self.a.challenge_leaves() | self.b.challenge_leaves()

    def evaluate(self, polys, challenges) -> int:
        return (self.a.evaluate(polys, challenges)
                * self.b.evaluate(polys, challenges)) % P

    def __repr__(self):
        return f"({self.a} * {self.b})"


def product(terms: Sequence[Expr]) -> Expr:
    acc = _lift(terms[0])
    for t in terms[1:]:
        acc = acc * t
    return acc


def linear_combination(coeff_names: Sequence[str],
                       terms: Sequence[Expr]) -> Expr:
    """sum_i Challenge(coeff_i) * term_i -- the standard gamma-RLC shape."""
    acc: Expr = Const(0)
    for c, t in zip(coeff_names, terms):
        acc = acc + Challenge(c) * t
    return acc
