"""The naive Expr-interpreter sumcheck prover/verifier (reference tier).

Analog of the reference's `NaiveSumcheckProver`
(`crates/jolt-kernels`, spec in `specs/clean-slate-prover.md:110-140`):
interprets a relation's symbolic `Expr` with dense polynomial leaves held
as Python-int coefficient vectors, O((deg+1) * 2^rounds * |Expr|) per
sumcheck.  Slow but *obviously correct* -- the semantic oracle every
optimized device kernel is equivalence-tested against
(`kernel_naive_equivalence`, spec :196-200; SURVEY.md §4.2).

Copied from the JAX package's `claims/naive.py` (host code, logic
unchanged); the port's engine asks an instance for its device message
first, so both halves answer `message_evals_dev` with None: every round
of the naive tier is host work (`compute_message`).

Conventions (matching the engine + relation kernels):
  * round messages are evaluated at X in {0, 2, ..., degree}; the X=1
    value is recovered from the running-claim hint
    (`UniPoly.from_evals_and_hint`)
  * variables bind MSB-first: round j pairs coefficient i with i + half
    (`poly/dense.py bind_high`)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from ..field.params import FR
from ..poly.univariate import UniPoly
from ..sumcheck.engine import OpeningAccumulator, SumcheckInstance
from .expr import Expr

P = FR.modulus


def sum_over_hypercube(expr: Expr, polys: Dict[str, Sequence[int]],
                       challenges: Dict[str, int]) -> int:
    """The relation's input claim: sum of the summand over the cube."""
    n = _common_len(expr, polys)
    total = 0
    for i in range(n):
        env = {name: polys[name][i] for name in expr.poly_leaves()}
        total += expr.evaluate(env, challenges)
    return total % P


def _common_len(expr: Expr, polys) -> int:
    lens = {len(polys[name]) for name in expr.poly_leaves()}
    if len(lens) != 1:
        raise ValueError(f"leaf length mismatch: {lens}")
    (n,) = lens
    if n & (n - 1):
        raise ValueError(f"leaf length {n} not a power of two")
    return n


class NaiveExprProver(SumcheckInstance):
    """Prove `claim = sum_x expr(polys(x))` by direct interpretation."""

    def __init__(self, expr: Expr, polys: Dict[str, Sequence[int]],
                 challenges: Optional[Dict[str, int]] = None,
                 opening_prefix: str = "naive"):
        self.expr = expr
        self.challenges = dict(challenges or {})
        missing = expr.challenge_leaves() - set(self.challenges)
        if missing:
            raise ValueError(f"unbound challenges: {sorted(missing)}")
        self.names = sorted(expr.poly_leaves())
        self.polys: Dict[str, List[int]] = {
            name: [v % P for v in polys[name]] for name in self.names}
        n = _common_len(expr, self.polys)
        self._rounds = n.bit_length() - 1
        self.degree = max(1, expr.degree())
        self.opening_prefix = opening_prefix
        self._claim = sum_over_hypercube(expr, self.polys, self.challenges)

    # ---- SumcheckInstance (prover half) ---------------------------------

    @property
    def num_rounds(self) -> int:
        return self._rounds

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._claim

    def message_evals_dev(self, round: int) -> None:
        return None

    def compute_message(self, round: int, previous_claim: int) -> UniPoly:
        half = len(self.polys[self.names[0]]) // 2 if self.names else 0
        xs = [0] + list(range(2, self.degree + 1))
        evals = []
        for x in xs:
            total = 0
            for i in range(half):
                env = {}
                for name in self.names:
                    col = self.polys[name]
                    lo, hi = col[i], col[i + half]
                    env[name] = (lo + x * (hi - lo)) % P
                total += self.expr.evaluate(env, self.challenges)
            evals.append(total % P)
        return UniPoly.from_evals_and_hint(previous_claim, evals, P)

    def ingest_challenge(self, r: int, round: int) -> None:
        for name in self.names:
            col = self.polys[name]
            half = len(col) // 2
            self.polys[name] = [
                (col[i] + r * (col[i + half] - col[i])) % P
                for i in range(half)]

    def cache_openings(self, accumulator: OpeningAccumulator,
                       r_slice: Sequence[int]) -> None:
        for name in self.names:
            accumulator.insert((self.opening_prefix, name), list(r_slice),
                               self.polys[name][0])

    def expected_output_claim(self, accumulator, r):  # pragma: no cover
        raise NotImplementedError("prover half")


class NaiveExprVerifier(SumcheckInstance):
    """Verifier twin: the final bound claim must equal the Expr evaluated
    on the cached opening claims (or publicly-evaluable leaves)."""

    def __init__(self, expr: Expr, input_claim: int,
                 num_rounds: int,
                 challenges: Optional[Dict[str, int]] = None,
                 opening_prefix: str = "naive",
                 public_evals: Optional[
                     Dict[str, Callable[[Sequence[int]], int]]] = None,
                 claimed: Optional[Dict[str, int]] = None):
        self.expr = expr
        self._claim = input_claim % P
        self._rounds = num_rounds
        self.challenges = dict(challenges or {})
        self.degree = max(1, expr.degree())
        self.opening_prefix = opening_prefix
        self.public_evals = dict(public_evals or {})
        # proof-supplied opening claims for leaves proven by THIS sumcheck
        # (the pipeline's verifier twins take these from the proof object)
        self.claimed = dict(claimed or {})

    @property
    def num_rounds(self) -> int:
        return self._rounds

    def input_claim(self, accumulator: OpeningAccumulator) -> int:
        return self._claim

    def message_evals_dev(self, round):  # pragma: no cover
        raise NotImplementedError("verifier half")

    def compute_message(self, round, previous_claim):  # pragma: no cover
        raise NotImplementedError("verifier half")

    def ingest_challenge(self, r: int, round: int) -> None:  # pragma: no cover
        pass

    def expected_output_claim(self, accumulator: OpeningAccumulator,
                              r: Sequence[int]) -> int:
        env = {}
        for name in sorted(self.expr.poly_leaves()):
            fn = self.public_evals.get(name)
            if fn is not None:
                env[name] = fn(r) % P
            elif name in self.claimed:
                env[name] = self.claimed[name] % P
            else:
                env[name] = accumulator.get_claim((self.opening_prefix, name))
        return self.expr.evaluate(env, self.challenges)
