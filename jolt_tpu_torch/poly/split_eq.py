"""Split-eq helpers: the closed-form EqPlusOne MLE.

Copy of `eq_plus_one_int` from the JAX package's `poly/split_eq.py` (host
ints); the split-eq tables themselves are not on the port's path yet.
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
