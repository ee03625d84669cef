"""Lagrange machinery for univariate-skip rounds (host-side exact math).

The uni-skip first round replaces the constraint-axis boolean rounds with a
single univariate over a symmetric integer window (reference:
`subprotocols/univariate_skip.rs:29-131`, `poly/lagrange_poly.rs`):

  * base window  = {-(D-1)/2 .. +(D-1)/2 + (D even)}  of size D,
  * extended targets = the DEGREE points just outside the window,
    interleaved [left-1, right+1, left-2, right+2, ...],
  * the first-round polynomial  s1(Y) = L(tau_high, Y) * t1(Y)  where L is
    the Lagrange kernel over the base window (the univariate analog of eq)
    and t1 vanishes on the base window for a satisfied instance.

All functions work over Z_p with Python ints; sizes are tiny (<= ~40
points), so O(n^2) interpolation is free compared to the device sumcheck.
"""

from __future__ import annotations

from typing import List, Sequence


from ..field.params import FR

P = FR.modulus


def symmetric_domain(size: int) -> List[int]:
    """The canonical base window: start = -((size-1)//2), `size` points."""
    start = -((size - 1) // 2)
    return [start + i for i in range(size)]


def lagrange_basis_at(domain: Sequence[int], x: int) -> List[int]:
    """[l_i(x)] for the Lagrange basis over `domain`, all mod p.
    `x` may be any field element (including a challenge)."""
    x = x % P
    n = len(domain)
    # prefix/suffix products of (x - d_j)
    diffs = [(x - d) % P for d in domain]
    pre = [1] * (n + 1)
    for i in range(n):
        pre[i + 1] = pre[i] * diffs[i] % P
    suf = [1] * (n + 1)
    for i in range(n - 1, -1, -1):
        suf[i] = suf[i + 1] * diffs[i] % P
    out = []
    for i in range(n):
        num = pre[i] * suf[i + 1] % P
        den = 1
        for j in range(n):
            if j != i:
                den = den * ((domain[i] - domain[j]) % P) % P
        out.append(num * pow(den, -1, P) % P)
    return out


def interpolate_coeffs(xs: Sequence[int], ys: Sequence[int]) -> List[int]:
    """Monomial coefficients (low-to-high) of the unique polynomial of
    degree < len(xs) through (xs[i], ys[i]), over Z_p."""
    n = len(xs)
    assert len(ys) == n
    coeffs = [0] * n
    for i in range(n):
        # basis poly l_i as coefficients, scaled by ys[i]
        li = [1]
        den = 1
        for j in range(n):
            if j == i:
                continue
            # li *= (X - xs[j])
            nxt = [0] * (len(li) + 1)
            for k, c in enumerate(li):
                nxt[k] = (nxt[k] - c * xs[j]) % P
                nxt[k + 1] = (nxt[k + 1] + c) % P
            li = nxt
            den = den * ((xs[i] - xs[j]) % P) % P
        scale = ys[i] % P * pow(den, -1, P) % P
        for k, c in enumerate(li):
            coeffs[k] = (coeffs[k] + c * scale) % P
    return coeffs


def eval_poly(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def domain_sum(coeffs: Sequence[int], domain_size: int) -> int:
    """sum of the polynomial over the base window (the uni-skip verifier's
    input-claim check, `check_sum_evals`)."""
    return sum(eval_poly(coeffs, z % P) for z in symmetric_domain(domain_size)) % P


def lagrange_kernel_coeffs(tau: int, domain_size: int) -> List[int]:
    """Coefficients of L(tau, Y): the unique degree-(D-1) polynomial with
    L(tau, z_i) = l_i(tau) on the base window -- the univariate eq kernel
    (univariate_skip.rs:118-122)."""
    base = symmetric_domain(domain_size)
    vals = lagrange_basis_at(base, tau)
    return interpolate_coeffs([z % P for z in base], vals)
