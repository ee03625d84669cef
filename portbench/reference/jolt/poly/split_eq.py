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

from typing import Sequence


from ..field.params import FR


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
