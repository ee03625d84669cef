"""Split-eq (Dao-Thaler) + Gruen round-message factorization, and EqPlusOne.

Torch counterpart of the JAX package's `poly/split_eq.py` (analog of
`GruenSplitEqPolynomial` / `TensorEqTable`, `crates/jolt-poly/src/
split_eq.rs`, `crates/jolt-prover-legacy/src/poly/split_eq_poly.rs`; the
optimization is eprint 2024/1210), logic unchanged.  Two independent
savings:

  * **sqrt memory**: eq(w, x) over n vars factors as
    eq(w_out, x_out) * eq(w_in, x_in) for any split point m, so two tables
    of size 2^m and 2^(n-m) replace one of size 2^n.  `outer()` rebuilds
    any prefix of the full table on demand as an outer product: one K1
    "mul" launch on the card over the broadcast (8, a, 1) x (8, 1, b),
    each operand read in place (stride 0 along the other axis).

  * **Gruen round messages**: in round j of a HighToLow sumcheck of
    sum_x eq(w, x) g(x), every term shares the factor
    c_j = prod_{i<j} eq(w_i, r_i), and the current variable contributes the
    LINEAR factor eq(w_j, X).  So the degree-(d+1) message satisfies
      s(X) = c_j * eq(w_j, X) * t(X),
    where t is the degree-d "inner" message computed WITHOUT the eq table's
    current variable.  The prover evaluates one fewer product factor per
    point and never binds the eq table: it slides to the next prefix table
    and updates the host scalar c_j.

Host-side state machine (Python ints) + device tables on `device` (the
card unless the caller asks for the CPU); equivalence with the JAX
package's is pinned in tests/test_torch_split_eq.py.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..field import ops
from ..field.params import FR
from . import eq as eq_mod

P = FR.modulus


class GruenSplitEq:
    """eq(w, .) in split form with Gruen per-round scalars, HighToLow.

    Tables:
      E_out = eq(w[:m], .)   over x_out  (2^m entries)
      E_in  = eq(w[m:], .)   over x_in   (2^(n-m) entries)

    Round j (binding w_0 first): the remaining-variable weight table is
      outer(j) = [eq(w[j+1:], x)]  (implicitly c_j-scaled via `scalar`).
    """

    def __init__(self, w: Sequence[int], split: Optional[int] = None,
                 device="cuda"):
        self.w = [x % P for x in w]
        self.n = len(self.w)
        self.device = ops.resolve_device(device)
        self.m = self.n // 2 if split is None else split
        self.E_out = eq_mod.evals(self.w[:self.m], self.device)  # (L, 2^m)
        self.E_in = eq_mod.evals(self.w[self.m:], self.device)   # (L, 2^(n-m))
        self.round = 0
        self.scalar = 1        # c_j = prod_{i<round} eq(w_i, r_i)

    # ---- full/partial table reconstruction -------------------------------

    def outer(self, j: Optional[int] = None) -> torch.Tensor:
        """Device table [eq(w[j:], x)] over the UNBOUND suffix vars
        (default: current round).  One broadcast multiply when the split
        point has not been crossed; eq(w[j:]) alone afterwards."""
        j = self.round if j is None else j
        if j >= self.m:
            # remaining vars all live in E_in; marginalize bound prefix
            return eq_mod.evals(self.w[j:], self.device)
        E_out_sub = eq_mod.evals(self.w[j:self.m], self.device)
        L, a = E_out_sub.shape
        b = self.E_in.shape[1]
        prod = ops.mont_mul(E_out_sub[:, :, None], self.E_in[:, None, :])
        return prod.reshape(L, a * b)

    def full_table(self) -> torch.Tensor:
        """The dense eq table over all n vars (test oracle / fallback)."""
        return self.outer(0)

    # ---- Gruen round algebra ---------------------------------------------

    def current_w(self) -> int:
        return self.w[self.round]

    def gruen_evals(self, t_evals: Sequence[int],
                    degree: int) -> List[int]:
        """Lift inner-message evals t(X) at X in {0, 2, .., degree} to
        s(X) = scalar * eq(w_j, X) * t(X) at the same points.
        eq(w_j, X) = (1 - w_j) + (2 w_j - 1) X  (linear in X)."""
        wj = self.w[self.round]
        out = []
        xs = [0] + list(range(2, degree + 2))
        for x, t in zip(xs, t_evals):
            eq_x = ((1 - wj) + (2 * wj - 1) * x) % P
            out.append(self.scalar * eq_x % P * t % P)
        return out[:len(t_evals)]

    def bind(self, r: int) -> None:
        """Consume challenge r for the current variable: update c_j."""
        wj = self.w[self.round]
        r = r % P
        self.scalar = self.scalar * ((wj * r + (1 - wj) * (1 - r)) % P) % P
        self.round += 1


def eq_plus_one_int(w: Sequence[int], x: Sequence[int]) -> int:
    """MLE of eq(w, x+1) -- 1 iff x = w - 1 on booleans; the shift
    relation's weight (`crates/jolt-poly/src/eq_plus_one.rs`,
    `zkvm/spartan/shift.rs`).  Big-endian points, host ints.

    Closed form: sum over the position i of the lowest 0-bit of x:
      x = p||0||1..1,  x+1 = p||1||0..0
      eq+1(w, x) = sum_i [prod_{j<i} eq(w_j,x_j)] * (1-x_i) w_i *
                   prod_{j>i} x_j (1-w_j)
    """
    p = FR.modulus
    n = len(w)
    assert len(x) == n
    total = 0
    # suffix products: x_j * (1 - w_j) for j > i
    suf = [1] * (n + 1)
    for j in range(n - 1, -1, -1):
        suf[j] = suf[j + 1] * (x[j] * (1 - w[j]) % p) % p
    pre = 1
    for i in range(n):
        term = pre * ((1 - x[i]) % p) % p * w[i] % p * suf[i + 1] % p
        total = (total + term) % p
        pre = pre * ((w[i] * x[i] + (1 - w[i]) * (1 - x[i])) % p) % p
    return total


def eq_plus_one_evals(w: Sequence[int], device="cuda") -> torch.Tensor:
    """Device table [eq(w, x+1)]_{x in [2^n]}: the eq table shifted down by
    one slot (entry x holds eq(w, x+1); the last entry is 0 -- there is no
    x+1 = 2^n row, matching EqPlusOnePolynomial::evals)."""
    E = eq_mod.evals(w, ops.resolve_device(device))
    return torch.cat([E[:, 1:], torch.zeros_like(E[:, :1])], dim=1)
