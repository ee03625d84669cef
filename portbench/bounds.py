"""The least time a K1 launch could take on one H100, frozen from the
port's `workload.py` (`bound_ms`, `k1_bound_ms` and their constants) so
that a later change to the port does not move the yardstick.

A launch's least time is the larger of its bytes over the card's HBM
bandwidth and its 32-bit multiply-adds over the CUDA cores' rate (NVIDIA's
H100 SXM data sheet, 700 W).  Each operand is read once and the output
written once; a Montgomery product is 272 multiply-adds.
"""

from __future__ import annotations

import math
from typing import Tuple

# H100 SXM published peaks: HBM3 3.35 TB/s; 32-bit integer multiply-adds
# on the CUDA cores: 132 SMs x 64 per clock x 1.98 GHz = 16.7 T/s
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 132 * 64 * 1.98e9
# one Fr Montgomery product: 136 32x32->64 multiplies = 272 multiply-adds
MADS_PER_PRODUCT = 272
# exact limb sums S = lo + h 2^256 to S mod p: h (2^256 mod p) and a
# one-word quotient of lo times p: 16 32x32->64 multiplies
MADS_PER_FOLD = 32


def bound_ms(n_bytes: int, products: int, mads: int = 0
             ) -> Tuple[float, str]:
    """The least time in ms for `n_bytes` moved and `products` Montgomery
    products plus `mads` multiply-adds, and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (products * MADS_PER_PRODUCT + mads) / INT32_MAD_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _numel(shape) -> int:
    """Field elements of an (8, *batch) limb shape; an int operand (passed
    by value) is 0."""
    return 0 if shape == "int" or shape is None else math.prod(shape[1:])


def _broadcast(*shapes) -> Tuple[int, ...]:
    """numpy's broadcast of batch shapes, without numpy."""
    n = max(len(s) for s in shapes)
    out = []
    for dims in zip(*[(1,) * (n - len(s)) + tuple(s) for s in shapes]):
        sizes = {d for d in dims if d != 1}
        if len(sizes) > 1:
            raise ValueError(f"shapes {shapes} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return tuple(out)


def k1_bound_ms(form: str, key) -> Tuple[float, str]:
    """One K1 launch of `form` with its launch record `key` (the port's
    `kernels.record` entries): "mul", "add", "sub" read both operands and
    write the broadcast output, one product an output for "mul"; "bind"
    reads lo, hi and r and writes lo's size, one product an output;
    "evals" reads lo and hi and writes `degree` outputs an entry; "reduce"
    reads int64 limb sums (64 B an element) and an optional scale, writes
    the reduced elements, and folds each sum (one product with a scale)."""
    if form in ("mul", "add", "sub"):
        a, b = key
        n = math.prod(_broadcast(*[s[1:] for s in key if s != "int"]))
        return bound_ms(32 * (_numel(a) + _numel(b) + n),
                        n if form == "mul" else 0)
    if form == "bind":
        lo, _, r = key
        n = _numel(lo)
        return bound_ms(32 * (3 * n + (_numel(r) if r != "int" else 0)), n)
    if form == "evals":
        lo, degree, _ = key
        n = _numel(lo)
        return bound_ms(32 * (2 + degree) * n, 0)
    if form == "reduce":
        cols, scale = key
        n = _numel(cols)
        return bound_ms(64 * n + 32 * (n + _numel(scale)),
                        0 if scale is None else n, MADS_PER_FOLD * n)
    raise ValueError(f"K1 has no form {form!r}")
