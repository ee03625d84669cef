"""Instruction lookup tables as multilinear extensions, with a uniform
prefix-suffix decomposition framework.

Foundation of the instruction-execution Shout argument (L9; reference:
`crates/jolt-lookup-tables/src/tables/`, `interleave.rs`,
`crates/jolt-prover-legacy/src/poly/prefix_suffix.rs`).

A table is a function over the 2*XLEN-bit lookup index; its MLE has a
structured closed form the verifier evaluates in O(XLEN) field ops -- no
2^128 table is ever materialized.  Conventions (matching the reference):

  * interleaved indexes are `interleave_bits(x, y)`: bit 2i+1 is x_i,
    bit 2i is y_i (x occupies the HIGH position of each bit pair --
    `interleave.rs:15-37`); non-interleaved indexes are the raw u128
    (left_operand << 64 | right_operand, with left always 0 in RV64).
  * MLE variables are big-endian over the 128 index bits: var 0 is index
    bit 127 (= x_63), var 1 is bit 126 (= y_63), ..., i.e. vars alternate
    (x_t, y_t) for pair positions t = 63 down to 0.

Prefix-suffix decomposition (the engine of the first LOG_K=128 sumcheck
rounds): for any pair-aligned cut, every table satisfies

    Val(k_pre || k_suf) = sum_terms coef * P_family(k_pre) * S_family(k_suf)

where each prefix family folds one bit-PAIR at a time (an incremental
"checkpoint" update, `prefix_suffix.rs:21-40`) and each suffix family is an
integer-valued function of the suffix bits (vectorizable on the trace).
Evaluating a prefix at a mixed point (bound challenges ++ X ++ boolean
bits) = folding the extra pairs into the checkpoint -- one generic rule per
family instead of the reference's 41 specialised prefix MLEs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence


from ..field.params import FR

P = FR.modulus
XLEN = 64
LOG_K = 2 * XLEN
M64 = (1 << 64) - 1


def uninterleave_bits(idx: int, xlen: int = XLEN):
    x = y = 0
    for i in range(xlen):
        y |= ((idx >> (2 * i)) & 1) << i
        x |= ((idx >> (2 * i + 1)) & 1) << i
    return x, y


# ---------------------------------------------------------------------------
# prefix families
#
# State is a small tuple of field ints; `update(state, a, b, t)` folds bit
# pair t (a = x_t value, b = y_t value; field elements or 0/1 ints), pairs
# are always folded from t=63 downward.  `value(state)` extracts the
# prefix evaluation.  All weights use GLOBAL bit positions so that
# P_pre + S_suf compositions need no 2^suffix_len rescaling.
# ---------------------------------------------------------------------------

def _eq2(a: int, b: int) -> int:
    return (a * b + (1 - a) * (1 - b)) % P


class PrefixFamily:
    name: str = ""

    def init(self):  # -> state
        return 0

    def update(self, state, a, b, t):
        raise NotImplementedError

    def value(self, state) -> int:
        return state % P


class _One(PrefixFamily):
    name = "one"

    def init(self):
        return 1

    def update(self, state, a, b, t):
        return 1


class _Bitwise(PrefixFamily):
    """sum_t 2^t * op(x_t, y_t) for op in {and, or, xor}."""

    def __init__(self, name, op):
        self.name = name
        self._op = op

    def update(self, state, a, b, t):
        return (state + (1 << t) * self._op(a, b)) % P


class _Eq(PrefixFamily):
    name = "eq"

    def init(self):
        return 1

    def update(self, state, a, b, t):
        return state * _eq2(a, b) % P


class _Ltu(PrefixFamily):
    """(lt_acc, eq_acc): unsigned less-than chain MSB-first."""

    name = "ltu"
    signed = False

    def init(self):
        return (0, 1)

    def update(self, state, a, b, t):
        lt, eqa = state
        if self.signed and t == XLEN - 1:
            # sign pair: x negative & y non-negative -> x < y
            lt = (lt + eqa * a % P * ((1 - b) % P)) % P
        else:
            lt = (lt + eqa * ((1 - a) % P) % P * b) % P
        return (lt, eqa * _eq2(a, b) % P)

    def value(self, state) -> int:
        return state[0] % P


class _Lts(_Ltu):
    name = "lts"
    signed = True


class _RightShift(PrefixFamily):
    """MSB-first fold of entry = entry*(1+y_i) + x_i*y_i -- packs the x bits
    selected by the y bitmask (tables/virtual_srl.rs materialize_entry)."""

    name = "rshift"

    def update(self, state, a, b, t):
        return (state * (1 + b) + a * b) % P


class _WeightedBitwise(PrefixFamily):
    """sum_t w(t) * op(x_t, y_t) with an arbitrary per-pair weight (0 to
    skip a pair); the engine of the xor-rotate tables
    (tables/virtual_xor_rot.rs, virtual_xor_rotw.rs)."""

    def __init__(self, name, op, weight: Callable[[int], int]):
        self.name = name
        self._op = op
        self._w = weight

    def update(self, state, a, b, t):
        w = self._w(t)
        if w == 0:
            return state
        return (state + w * self._op(a, b)) % P


class _RightShiftW(PrefixFamily):
    """rshift fold restricted to the low 32 bit pairs
    (tables/virtual_rotrw.rs first_sum: pairs >= 32 are ignored)."""

    name = "rshiftw"

    def update(self, state, a, b, t):
        if t >= 32:
            return state
        return (state * (1 + b) + a * b) % P


class _LeftShift(PrefixFamily):
    """MSB-first fold of the rotate-right wrap mass
    (tables/virtual_rotr.rs second_sum): at pair t,
    acc += x_t*(1-y_t)*prod*2^t, then prod *= (1+y_t), where prod covers
    the already-folded (more significant) pairs.  word=True restricts to
    the low 32 pairs (virtual_rotrw.rs)."""

    def __init__(self, name, word: bool = False):
        self.name = name
        self._word = word

    def init(self):
        return (0, 1)  # (acc, prod)

    def update(self, state, a, b, t):
        if self._word and t >= 32:
            return state
        acc, prod = state
        acc = (acc + a * ((1 - b) % P) % P * prod % P * (1 << t)) % P
        return (acc, prod * (1 + b) % P)

    def value(self, state) -> int:
        return state[0] % P


def _xor_rot_w(rot: int, xlen: int) -> Callable[[int], int]:
    """Weight of pair t for xor-then-rotate-right-by-rot over xlen bits:
    bit t of (x^y) lands at bit (t-rot) mod xlen; pairs >= xlen ignored."""
    def w(t: int) -> int:
        if t >= xlen:
            return 0
        return 1 << ((t - rot) % xlen)
    return w


def _rev8w_target(g: int) -> int:
    """Byte-reverse-within-words bit permutation: global bit g (< 64) of
    the operand lands at this output bit (tracer virtual_rev8w.rs rev8w:
    each 32-bit half's bytes are reversed in place)."""
    k, j = g >> 3, g & 7
    kp = 3 - k if k < 4 else 11 - k
    return 8 * kp + j


class _MsbX(PrefixFamily):
    """x_63 (the sign bit of the left operand)."""

    name = "msbx"

    def update(self, state, a, b, t):
        return a % P if t == XLEN - 1 else state


class _SraSign(PrefixFamily):
    """x_63 * sum_{t<63} 2^(63-t) * (1 - y_t): the sign-extension mass of
    the prefix pairs (tables/virtual_sra.rs)."""

    name = "sra_sign"

    def init(self):
        return (0, 0)  # (msb_x, acc)

    def update(self, state, a, b, t):
        msb, acc = state
        if t == XLEN - 1:
            return (a % P, acc)
        return (msb, (acc + (1 << (XLEN - 1 - t)) * ((1 - b) % P)) % P)

    def value(self, state) -> int:
        return state[0] * state[1] % P


class _PositionWeighted(PrefixFamily):
    """sum over bit positions in [lo, hi) of 2^(pos-shift) * bit; covers
    range_check / aligned / upper_word / identity / operand extraction."""

    def __init__(self, name, x_weight: Callable[[int], int],
                 y_weight: Callable[[int], int]):
        self.name = name
        self._xw = x_weight  # pair index t -> weight of x_t (0 to skip)
        self._yw = y_weight

    def update(self, state, a, b, t):
        return (state + self._xw(t) * a + self._yw(t) * b) % P


class _PairProduct(PrefixFamily):
    """prod over pairs t of factor(x_t, y_t, t) -- the multiplicative
    family class behind Pow2, the division/alignment validity tables and
    the change-divisor triggers.  factor must be multilinear in (a, b) and
    equal 1 on pairs it ignores, so the product decomposes across any
    pair-aligned prefix/suffix cut."""

    def __init__(self, name, factor: Callable[[int, int, int], int]):
        self.name = name
        self.factor = factor

    def init(self):
        return 1

    def update(self, state, a, b, t):
        return state * self.factor(a % P, b % P, t) % P


class _BitAt(PrefixFamily):
    """The value of one index bit (global bit position `pos`); 0 until the
    owning pair is folded, so the suffix twin covers the early cuts."""

    def __init__(self, name, pos: int):
        self.name = name
        self._t = pos // 2
        self._is_x = bool(pos & 1)

    def update(self, state, a, b, t):
        if t == self._t:
            return (a if self._is_x else b) % P
        return state


def _w_if(cond, shift):
    return (1 << shift) if cond else 0


# multiplicative pair factors ------------------------------------------------

def _f_pow2(a, b, t):
    """Pairs t<3 (index bits 0..5): 2^(idx & 63) as a product of per-bit
    multipliers (tables/pow2.rs)."""
    if t >= 3:
        return 1
    fy = (1 + b * ((1 << (1 << (2 * t))) - 1)) % P
    fx = (1 + a * ((1 << (1 << (2 * t + 1))) - 1)) % P
    return fy * fx % P


def _f_pow2w(a, b, t):
    """Bits 0..4 only: 2^(idx & 31) (tables/pow2_w.rs)."""
    if t > 2:
        return 1
    fy = (1 + b * ((1 << (1 << (2 * t))) - 1)) % P
    fx = 1 if t == 2 else (1 + a * ((1 << (1 << (2 * t + 1))) - 1)) % P
    return fy * fx % P


def _f_zerox_onesy(a, b, t):
    return (1 - a) * b % P


def _f_zerox(a, b, t):
    return (1 - a) % P


def _f_zeroy(a, b, t):
    return (1 - b) % P


def _f_chdiv(a, b, t):
    """x == 2^63 (signed MIN) and y == all-ones (tables/virtual_change_divisor.rs)."""
    return a * b % P if t == 63 else (1 - a) * b % P


def _f_chdivw(a, b, t):
    """x == sext32(2^31) = 0xFFFF_FFFF_8000_0000 and y == all-ones."""
    return a * b % P if t >= 31 else (1 - a) * b % P


def _f_hizero(a, b, t):
    """index bits 64..127 all zero (tables/mulu_no_overflow.rs)."""
    return (1 - a) * (1 - b) % P if t >= 32 else 1


def _f_nbit0(a, b, t):
    """1 - index bit 0 (tables/halfword_alignment.rs)."""
    return (1 - b) % P if t == 0 else 1


def _f_align4(a, b, t):
    """(1 - bit0)(1 - bit1) (tables/word_alignment.rs)."""
    return (1 - a) * (1 - b) % P if t == 0 else 1


PREFIXES: Dict[str, PrefixFamily] = {}
for fam in [
    _One(),
    _Bitwise("and", lambda a, b: a * b % P),
    _Bitwise("or", lambda a, b: (a + b - a * b) % P),
    _Bitwise("xor", lambda a, b: (a + b - 2 * a * b) % P),
    _Bitwise("andn", lambda a, b: a * ((1 - b) % P) % P),
    _RightShiftW(),
    _LeftShift("lsh"),
    _LeftShift("lshw", word=True),
    _PairProduct("lsh_helper", lambda a, b, t: (1 + b) % P),
    _PairProduct("lshw_helper",
                 lambda a, b, t: (1 + b) % P if t < 32 else 1),
    _Eq(),
    _Ltu(),
    _Lts(),
    _RightShift(),
    _MsbX(),
    _SraSign(),
    # x_t sits at index bit 2t+1, y_t at bit 2t
    _PositionWeighted("rc", lambda t: _w_if(2 * t + 1 < 64, 2 * t + 1),
                      lambda t: _w_if(2 * t < 64, 2 * t)),
    _PositionWeighted("rca", lambda t: _w_if(2 * t + 1 < 64, 2 * t + 1),
                      lambda t: _w_if(0 < 2 * t < 64, 2 * t)),
    _PositionWeighted("uw", lambda t: _w_if(2 * t + 1 >= 64, 2 * t + 1 - 64),
                      lambda t: _w_if(2 * t >= 64, 2 * t - 64)),
    _PositionWeighted("left", lambda t: 1 << t, lambda t: 0),
    _PositionWeighted("right", lambda t: 0, lambda t: 1 << t),
    _PositionWeighted("id", lambda t: (1 << (2 * t + 1)) % P,
                      lambda t: (1 << (2 * t)) % P),
    # low 32 index bits (pairs 0..15), for the word extend tables
    _PositionWeighted("low32", lambda t: _w_if(2 * t + 1 < 32, 2 * t + 1),
                      lambda t: _w_if(2 * t < 32, 2 * t)),
    _BitAt("bit31", 31),
    _PairProduct("pow2", _f_pow2),
    _PairProduct("pow2w", _f_pow2w),
    _PairProduct("zerox", _f_zerox),
    _PairProduct("zeroy", _f_zeroy),
    _PairProduct("zerox_onesy", _f_zerox_onesy),
    _PairProduct("chdiv", _f_chdiv),
    _PairProduct("chdivw", _f_chdivw),
    _PairProduct("hizero", _f_hizero),
    _PairProduct("nbit0", _f_nbit0),
    _PairProduct("align4", _f_align4),
    # sum_g bit_g * 2^rev8w_target(g): x_t at global bit 2t+1, y_t at 2t
    _PositionWeighted(
        "rev8w",
        lambda t: (1 << _rev8w_target(2 * t + 1)) if 2 * t + 1 < 64 else 0,
        lambda t: (1 << _rev8w_target(2 * t)) if 2 * t < 64 else 0),
]:
    PREFIXES[fam.name] = fam

_XOR2 = lambda a, b: (a + b - 2 * a * b) % P
for _rot in (16, 24, 32, 63):
    _f = _WeightedBitwise(f"xor_rot{_rot}", _XOR2, _xor_rot_w(_rot, 64))
    PREFIXES[_f.name] = _f
for _rot in (7, 8, 12, 16):
    _f = _WeightedBitwise(f"xor_rotw{_rot}", _XOR2, _xor_rot_w(_rot, 32))
    PREFIXES[_f.name] = _f


# ---------------------------------------------------------------------------
# suffix families: integer functions of the suffix bits.  `s` is the raw
# suffix integer (big-endian value of the last L index bits, L pair-aligned),
# (xs, ys) its deinterleaved halves.  Values are exact Python ints.
# ---------------------------------------------------------------------------

SUFFIXES: Dict[str, Callable[[int, int, int, int], int]] = {
    "one": lambda xs, ys, s, L: 1,
    "and": lambda xs, ys, s, L: xs & ys,
    "or": lambda xs, ys, s, L: xs | ys,
    "xor": lambda xs, ys, s, L: xs ^ ys,
    "eq": lambda xs, ys, s, L: int(xs == ys),
    "ltu": lambda xs, ys, s, L: int(xs < ys),
    "low64": lambda xs, ys, s, L: s & M64,
    "alow64": lambda xs, ys, s, L: s & M64 & ~1,
    "hi64": lambda xs, ys, s, L: s >> 64,
    "left": lambda xs, ys, s, L: xs,
    "right": lambda xs, ys, s, L: ys,
    "id": lambda xs, ys, s, L: s,
    "rsh": lambda xs, ys, s, L: _rsh_fold(xs, ys, L // 2),
    "rsh_helper": lambda xs, ys, s, L: 1 << bin(ys).count("1"),
    "sign_ext": lambda xs, ys, s, L: sum(
        (1 << (XLEN - 1 - p)) for p in range(L // 2) if not (ys >> p) & 1),
    # suffix twins of the multiplicative / word-extract prefix families
    "pow2": lambda xs, ys, s, L: 1 << (s & 63),
    "pow2w": lambda xs, ys, s, L: 1 << (s & 31),
    "zerox": lambda xs, ys, s, L: int(xs == 0),
    "zeroy": lambda xs, ys, s, L: int(ys == 0),
    "zerox_onesy": lambda xs, ys, s, L: int(
        xs == 0 and ys == (1 << (L // 2)) - 1),
    "chdiv": lambda xs, ys, s, L: int(
        xs == 0 and ys == (1 << (L // 2)) - 1),
    "chdivw": lambda xs, ys, s, L: int(
        ys == (1 << (L // 2)) - 1
        and xs == (((1 << (L // 2)) - 1) >> 31 << 31)),
    "hizero": lambda xs, ys, s, L: int(s >> 64 == 0),
    "nbit0": lambda xs, ys, s, L: int(L == 0 or (s & 1) == 0),
    "align4": lambda xs, ys, s, L: int(L == 0 or (s & 3) == 0),
    "low32": lambda xs, ys, s, L: s & 0xFFFFFFFF,
    "bit31": lambda xs, ys, s, L: (s >> 31) & 1,
    "andn": lambda xs, ys, s, L: xs & ((1 << (L // 2)) - 1 - ys),
    "lsh": lambda xs, ys, s, L: _lsh_fold(xs, ys, L // 2),
    "lshw": lambda xs, ys, s, L: _lsh_fold(xs, ys, min(L // 2, 32)),
    "rshw": lambda xs, ys, s, L: _rsh_fold(xs, ys, min(L // 2, 32)),
    "rshw_helper": lambda xs, ys, s, L: 1 << bin(
        ys & 0xFFFFFFFF).count("1"),
    "rev8w": lambda xs, ys, s, L: sum(
        ((s >> g) & 1) << _rev8w_target(g) for g in range(min(L, 64))),
}
for _rot in (16, 24, 32, 63):
    SUFFIXES[f"xor_rot{_rot}"] = (
        lambda xs, ys, s, L, R=_rot: sum(
            (((xs ^ ys) >> p) & 1) << ((p - R) % 64) for p in range(L // 2)))
for _rot in (7, 8, 12, 16):
    SUFFIXES[f"xor_rotw{_rot}"] = (
        lambda xs, ys, s, L, R=_rot: sum(
            (((xs ^ ys) >> p) & 1) << ((p - R) % 32)
            for p in range(min(L // 2, 32))))


def _rsh_fold(xs: int, ys: int, pairs: int) -> int:
    """MSB-first entry fold over `pairs` bit pairs (virtual_srl.rs)."""
    e = 0
    for p in range(pairs - 1, -1, -1):
        y = (ys >> p) & 1
        e = e * (1 + y) + ((xs >> p) & 1) * y
    return e


def _lsh_fold(xs: int, ys: int, pairs: int) -> int:
    """Rotate-right wrap mass over `pairs` bit pairs
    (virtual_rotr.rs second_sum): sum_p x_p*(1-y_p)*2^p*prod_{q>p}(1+y_q).
    On boolean inputs every term hits a distinct power of two <= 2^63,
    so the value fits u64."""
    acc, prod = 0, 1
    for p in range(pairs - 1, -1, -1):
        y = (ys >> p) & 1
        acc += ((xs >> p) & 1) * (1 - y) * prod * (1 << p)
        prod *= 1 + y
    return acc


# ---------------------------------------------------------------------------
# tables: terms = [(coef, prefix_name, suffix_name)];
# Val(k) = sum coef * P(k_pre) * S(k_suf) for every pair-aligned cut.
# entry(idx) is the u64 oracle on the full 128-bit index.
# ---------------------------------------------------------------------------

def _entry_split(f):
    def g(idx):
        x, y = uninterleave_bits(idx)
        return f(x, y)
    return g


def _s64(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


TABLES: Dict[str, dict] = {
    # reference file in crates/jolt-lookup-tables/src/tables/ in comments
    "RangeCheck": {  # range_check.rs
        "terms": [(1, "rc", "one"), (1, "one", "low64")],
        "entry": lambda idx: idx & M64,
    },
    "RangeCheckAligned": {  # range_check_aligned.rs (jalr target & ~1)
        "terms": [(1, "rca", "one"), (1, "one", "alow64")],
        "entry": lambda idx: idx & M64 & ~1,
    },
    "UpperWord": {  # upper_word.rs (mulhu)
        "terms": [(1, "uw", "one"), (1, "one", "hi64")],
        "entry": lambda idx: (idx >> 64) & M64,
    },
    "And": {  # and.rs
        "terms": [(1, "and", "one"), (1, "one", "and")],
        "entry": _entry_split(lambda x, y: x & y),
    },
    "Or": {  # or.rs
        "terms": [(1, "or", "one"), (1, "one", "or")],
        "entry": _entry_split(lambda x, y: x | y),
    },
    "Xor": {  # xor.rs
        "terms": [(1, "xor", "one"), (1, "one", "xor")],
        "entry": _entry_split(lambda x, y: x ^ y),
    },
    "Equal": {  # equal.rs
        "terms": [(1, "eq", "eq")],
        "entry": _entry_split(lambda x, y: int(x == y)),
    },
    "NotEqual": {  # not_equal.rs
        "terms": [(1, "one", "one"), (-1, "eq", "eq")],
        "entry": _entry_split(lambda x, y: int(x != y)),
    },
    "UnsignedLessThan": {  # unsigned_less_than.rs
        "terms": [(1, "ltu", "one"), (1, "eq", "ltu")],
        "entry": _entry_split(lambda x, y: int(x < y)),
    },
    "SignedLessThan": {  # signed_less_than.rs
        "terms": [(1, "lts", "one"), (1, "eq", "ltu")],
        "entry": _entry_split(lambda x, y: int(_s64(x) < _s64(y))),
    },
    "UnsignedGreaterThanEqual": {  # unsigned_greater_than_equal.rs
        "terms": [(1, "one", "one"), (-1, "ltu", "one"), (-1, "eq", "ltu")],
        "entry": _entry_split(lambda x, y: int(x >= y)),
    },
    "SignedGreaterThanEqual": {  # signed_greater_than_equal.rs
        "terms": [(1, "one", "one"), (-1, "lts", "one"), (-1, "eq", "ltu")],
        "entry": _entry_split(lambda x, y: int(_s64(x) >= _s64(y))),
    },
    "VirtualSRL": {  # virtual_srl.rs: x packed through the y bitmask
        "terms": [(1, "rshift", "rsh_helper"), (1, "one", "rsh")],
        "entry": _entry_split(lambda x, y: _rsh_fold(x, y, XLEN)),
    },
    "VirtualSRA": {  # virtual_sra.rs: SRL + sign-bit extension mass
        "terms": [(1, "rshift", "rsh_helper"), (1, "one", "rsh"),
                  (1, "sra_sign", "one"), (1, "msbx", "sign_ext")],
        "entry": _entry_split(lambda x, y: (
            _rsh_fold(x, y, XLEN)
            + ((x >> 63) & 1) * sum((1 << (XLEN - 1 - p))
                                    for p in range(XLEN - 1)
                                    if not (y >> p) & 1))),
    },
    # ---- virtual-sequence support tables (jolt-program expand/) ---------
    "Pow2": {  # pow2.rs: 2^(operand & 63), non-interleaved operand
        "terms": [(1, "pow2", "pow2")],
        "entry": lambda idx: 1 << (idx & 63),
    },
    "Pow2W": {  # pow2_w.rs: 2^(operand & 31)
        "terms": [(1, "pow2w", "pow2w")],
        "entry": lambda idx: 1 << (idx & 31),
    },
    "ShiftRightBitmask": {  # shift_right_bitmask.rs: 2^64 - 2^(operand & 63)
        "terms": [(1 << 64, "one", "one"), (-1, "pow2", "pow2")],
        "entry": lambda idx: (1 << 64) - (1 << (idx & 63)),
    },
    "SignMask": {  # sign_mask.rs (movsign): all-ones iff x is negative
        "terms": [(M64, "msbx", "one")],
        "entry": _entry_split(lambda x, y: M64 if x >> 63 else 0),
    },
    "SignExtendHalfWord": {  # sign_extend_half_word.rs: sext32 of low word
        "terms": [(1, "low32", "one"), (1, "one", "low32"),
                  ((1 << 64) - (1 << 32), "bit31", "one"),
                  ((1 << 64) - (1 << 32), "one", "bit31")],
        "entry": lambda idx: (idx & 0xFFFFFFFF) | (
            0xFFFFFFFF00000000 if (idx >> 31) & 1 else 0),
    },
    "LowerHalfWord": {  # lower_half_word.rs: zext32 of low word
        "terms": [(1, "low32", "one"), (1, "one", "low32")],
        "entry": lambda idx: idx & 0xFFFFFFFF,
    },
    "ValidDiv0": {  # valid_div0.rs: x=divisor, y=quotient
        "terms": [(1, "one", "one"), (-1, "zerox", "zerox"),
                  (1, "zerox_onesy", "zerox_onesy")],
        "entry": _entry_split(lambda x, y: 1 if x else int(y == M64)),
    },
    "ValidUnsignedRemainder": {  # valid_unsigned_remainder.rs: x=rem, y=div
        "terms": [(1, "zeroy", "zeroy"), (1, "ltu", "one"), (1, "eq", "ltu")],
        "entry": _entry_split(lambda x, y: int(y == 0 or x < y)),
    },
    "VirtualChangeDivisor": {  # virtual_change_divisor.rs: x=dividend, y=divisor
        "terms": [(1, "right", "one"), (1, "one", "right"),
                  (2 - (1 << 64), "chdiv", "chdiv")],
        "entry": _entry_split(
            lambda x, y: 1 if (x == 1 << 63 and y == M64) else y),
    },
    "VirtualChangeDivisorW": {  # virtual_change_divisor_w.rs (word MIN)
        "terms": [(1, "right", "one"), (1, "one", "right"),
                  (2 - (1 << 64), "chdivw", "chdivw")],
        "entry": _entry_split(
            lambda x, y: 1 if (x == 0xFFFFFFFF80000000 and y == M64) else y),
    },
    "UnsignedLessThanEqual": {  # unsigned_less_than_equal.rs
        "terms": [(1, "ltu", "one"), (1, "eq", "ltu"), (1, "eq", "eq")],
        "entry": _entry_split(lambda x, y: int(x <= y)),
    },
    "MulUNoOverflow": {  # mulu_no_overflow.rs: product fits 64 bits
        "terms": [(1, "hizero", "hizero")],
        "entry": lambda idx: int(idx >> 64 == 0),
    },
    "HalfwordAlignment": {  # halfword_alignment.rs: (rs1+imm) 2-byte aligned
        "terms": [(1, "nbit0", "nbit0")],
        "entry": lambda idx: int(idx & 1 == 0),
    },
    "WordAlignment": {  # word_alignment.rs: (rs1+imm) 4-byte aligned
        "terms": [(1, "align4", "align4")],
        "entry": lambda idx: int(idx & 3 == 0),
    },
    # ---- inline-extension tables (jolt-inlines/{sha2,keccak256,...}) ----
    "Andn": {  # andn.rs: rd = x & ~y (Zbb ANDN)
        "terms": [(1, "andn", "one"), (1, "one", "andn")],
        "entry": _entry_split(lambda x, y: x & (M64 ^ y)),
    },
    "VirtualROTR": {  # virtual_rotr.rs: rotate-right by the y bitmask
        "terms": [(1, "rshift", "rsh_helper"), (1, "one", "rsh"),
                  (1, "lsh_helper", "lsh"), (1, "lsh", "one")],
        "entry": _entry_split(
            lambda x, y: _rsh_fold(x, y, 64) + _lsh_fold(x, y, 64)),
    },
    "VirtualROTRW": {  # virtual_rotrw.rs: word rotate (high pairs ignored)
        "terms": [(1, "rshiftw", "rshw_helper"), (1, "one", "rshw"),
                  (1, "lshw_helper", "lshw"), (1, "lshw", "one")],
        "entry": _entry_split(
            lambda x, y: _rsh_fold(x, y, 32) + _lsh_fold(x, y, 32)),
    },
    "VirtualRev8W": {  # virtual_rev8w.rs: byte-reverse each 32-bit half
        "terms": [(1, "rev8w", "one"), (1, "one", "rev8w")],
        "entry": lambda idx: sum(
            ((idx >> g) & 1) << _rev8w_target(g) for g in range(64)),
    },
}
for _rot in (16, 24, 32, 63):
    TABLES[f"VirtualXORROT{_rot}"] = {  # virtual_xor_rot.rs
        "terms": [(1, f"xor_rot{_rot}", "one"),
                  (1, "one", f"xor_rot{_rot}")],
        "entry": _entry_split(lambda x, y, R=_rot: (
            (((x ^ y) >> R) | ((x ^ y) << (64 - R))) & M64)),
    }
for _rot in (7, 8, 12, 16):
    TABLES[f"VirtualXORROTW{_rot}"] = {  # virtual_xor_rotw.rs
        "terms": [(1, f"xor_rotw{_rot}", "one"),
                  (1, "one", f"xor_rotw{_rot}")],
        "entry": _entry_split(lambda x, y, R=_rot: (
            ((((x ^ y) & 0xFFFFFFFF) >> R)
             | (((x ^ y) & 0xFFFFFFFF) << (32 - R))) & 0xFFFFFFFF)),
    }


def right_shift_bitmask(shift: int, xlen: int = XLEN) -> int:
    """The y operand for VirtualSRL/SRA: top (xlen-shift) bits set
    (jolt-program expand/shifts/shared right_shift_bitmask)."""
    return (((1 << xlen) - 1) >> shift) << shift

TABLE_NAMES: List[str] = list(TABLES)          # canonical order


# ---------------------------------------------------------------------------
# generic evaluation by prefix folding (verifier closed forms + test oracle)
# ---------------------------------------------------------------------------

def fold_prefixes(point: Sequence[int], names: Sequence[str],
                  states: Optional[Dict[str, object]] = None,
                  t_start: int = XLEN - 1) -> Dict[str, object]:
    """Fold an even-length big-endian point (pairs (x_t, y_t) from t_start
    downward) into per-family states.  Returns the updated states."""
    assert len(point) % 2 == 0
    out = {}
    for name in names:
        fam = PREFIXES[name]
        st = states[name] if states is not None else fam.init()
        t = t_start
        for i in range(0, len(point), 2):
            st = fam.update(st, point[i] % P, point[i + 1] % P, t)
            t -= 1
        out[name] = st
    return out


def table_value_from_parts(name: str, prefix_vals: Dict[str, int],
                           suffix_vals: Dict[str, int]) -> int:
    acc = 0
    for coef, pre, suf in TABLES[name]["terms"]:
        acc += coef * prefix_vals[pre] * suffix_vals[suf]
    return acc % P


def suffix_values(s: int, L: int) -> Dict[str, int]:
    """All suffix-family values on a suffix integer of bit length L."""
    xs, ys = uninterleave_bits(s, L // 2)
    return {name: fn(xs, ys, s, L) for name, fn in SUFFIXES.items()}


# ---------------------------------------------------------------------------
# per-instruction lookup query (reference:
# crates/jolt-lookup-tables/src/instructions/riscv/*.rs)
# ---------------------------------------------------------------------------

# kind -> table name (None = no lookup; output constrained 0 by convention)
KIND_TABLE: Dict[str, Optional[str]] = {
    "ADD": "RangeCheck", "ADDI": "RangeCheck", "SUB": "RangeCheck",
    "LUI": "RangeCheck", "AUIPC": "RangeCheck", "JAL": "RangeCheck",
    "JALR": "RangeCheckAligned",
    "MUL": "RangeCheck", "MULHU": "UpperWord",
    "AND": "And", "ANDI": "And", "OR": "Or", "ORI": "Or",
    "XOR": "Xor", "XORI": "Xor",
    "BEQ": "Equal", "BNE": "NotEqual",
    "BLT": "SignedLessThan", "SLT": "SignedLessThan",
    "SLTI": "SignedLessThan",
    "BGE": "SignedGreaterThanEqual",
    "BLTU": "UnsignedLessThan", "SLTU": "UnsignedLessThan",
    "SLTIU": "UnsignedLessThan",
    "BGEU": "UnsignedGreaterThanEqual",
    # 1:1 virtual rewrites (jolt-program expand/shifts/): SLLI becomes a
    # multiply by 2^shift (VirtualMULI), SRLI/SRAI become bitmask-operand
    # shift-table lookups; the transformed immediate is effective_imm().
    "SLLI": "RangeCheck", "SRLI": "VirtualSRL", "SRAI": "VirtualSRA",
    "LD": None, "SD": None, "FENCE": None, "ECALL": None, "EBREAK": None,
    "HOSTIO": None,
    "NOOP": None,
    # virtual (final) instructions -> their dedicated tables
    # (crates/jolt-lookup-tables/src/instructions/virt/*.rs)
    "VirtualAdvice": "RangeCheck",
    "VirtualMovsign": "SignMask",
    "VirtualPow2": "Pow2",
    "VirtualPow2W": "Pow2W",
    "VirtualShiftRightBitmask": "ShiftRightBitmask",
    "VirtualSignExtendWord": "SignExtendHalfWord",
    "VirtualZeroExtendWord": "LowerHalfWord",
    "VirtualChangeDivisor": "VirtualChangeDivisor",
    "VirtualChangeDivisorW": "VirtualChangeDivisorW",
    "VirtualSRL": "VirtualSRL",
    "VirtualSRA": "VirtualSRA",
    "VirtualMULI": "RangeCheck",
    "VirtualAssertEQ": "Equal",
    "VirtualAssertLTE": "UnsignedLessThanEqual",
    "VirtualAssertValidDiv0": "ValidDiv0",
    "VirtualAssertValidUnsignedRemainder": "ValidUnsignedRemainder",
    "VirtualAssertMulUNoOverflow": "MulUNoOverflow",
    "VirtualAssertHalfwordAlignment": "HalfwordAlignment",
    "VirtualAssertWordAlignment": "WordAlignment",
    # inline-extension kinds (jolt-inlines): Zbb ANDN + virtual rotates
    "ANDN": "Andn",
    "VirtualROTRI": "VirtualROTR",
    "VirtualROTRIW": "VirtualROTRW",
    "VirtualRev8W": "VirtualRev8W",
    "VirtualXORROT16": "VirtualXORROT16",
    "VirtualXORROT24": "VirtualXORROT24",
    "VirtualXORROT32": "VirtualXORROT32",
    "VirtualXORROT63": "VirtualXORROT63",
    "VirtualXORROTW7": "VirtualXORROTW7",
    "VirtualXORROTW8": "VirtualXORROTW8",
    "VirtualXORROTW12": "VirtualXORROTW12",
    "VirtualXORROTW16": "VirtualXORROTW16",
}


def effective_imm(kind: str, imm: int) -> Optional[int]:
    """The proving-circuit immediate for 1:1 virtual-rewrite instructions
    (None = keep the decoded immediate).  Pure function of (kind, word) so
    trace-side witness extraction and the public bytecode decode agree."""
    if kind == "SLLI":
        return 1 << (imm & 63)
    if kind in ("SRLI", "SRAI"):
        return right_shift_bitmask(imm & 63)
    return None
