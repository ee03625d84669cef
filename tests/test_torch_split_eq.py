"""The JAX package's last poly and host surface, ported, against the JAX
package on the CPU (seeded, byte-exact as canonical ints).

  * `poly/split_eq.py`: `GruenSplitEq` (the split tables at every round
    boundary, the Gruen-lifted message over all rounds of a HighToLow
    sumcheck against the dense one, the final scalar) and
    `eq_plus_one_evals` against the shifted eq table and
    `eq_plus_one_int`, at n = 5 and 6 (tests/test_split_eq.py's cases);
  * `poly/dense.py`: `bind` (both orders), `sumcheck_eval_points_low`
    (degrees 1-3), `from_u64_column`; `field/ops.py`: `mont_sqr`;
  * host copies: `blindfold/pedersen.py`'s `commit_add`, `commit_scale`,
    `commit_fold`, `blindfold/fold.py:grid_dims`,
    `relations/instruction_read_raf.py:host_eq_evals` and the list forms
    of `curve/native_pairing.py` (over the library the port builds from
    its `csrc/pairing.cpp`).

The card's K1 launches of the same functions are in tests/test_torch_cuda.py
(`cuda` marker) and `chip_smoke.py`'s `[surface]` phase; K1's launch record
of `GruenSplitEq.outer`'s broadcast is emulated in tests/test_torch_field.py.
"""

import random

import numpy as np
import pytest
import torch

from jolt_tpu.blindfold import fold as jfold
from jolt_tpu.blindfold import pedersen as jped
from jolt_tpu.curve import native_pairing as jnp_
from jolt_tpu.curve import pairing as jpairing
from jolt_tpu.field import ops as jops
from jolt_tpu.poly import dense as jdense
from jolt_tpu.poly import eq as jeq
from jolt_tpu.poly import split_eq as jse
from jolt_tpu.relations import instruction_read_raf as jir

from jolt_tpu_torch.blindfold import fold, pedersen
from jolt_tpu_torch.curve import native_pairing
from jolt_tpu_torch.curve import pairing
from jolt_tpu_torch.field import ops
from jolt_tpu_torch.field.params import FR
from jolt_tpu_torch.poly import dense, eq
from jolt_tpu_torch.poly import split_eq as se
from jolt_tpu_torch.relations import instruction_read_raf as ir

torch.set_num_threads(1)

P = FR.modulus
CPU = "cpu"


def _point(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def _mine(t):
    return ops.unpack_ints(t)


def _theirs(t):
    return jops.unpack_ints(t)


@pytest.mark.parametrize("n, split", [(5, None), (6, None), (6, 2), (6, 6)])
def test_split_outer_matches_jax_at_every_round_boundary(n, split):
    w = _point(n, n)
    mine = se.GruenSplitEq(w, split=split, device=CPU)
    theirs = jse.GruenSplitEq(w, split=split)
    assert _mine(mine.full_table()) == _theirs(theirs.full_table()) \
        == _mine(eq.evals(w, CPU))
    for j in range(1, n + 1):
        assert _mine(mine.outer(j)) == _theirs(theirs.outer(j)) \
            == _mine(eq.evals(w[j:], CPU)), f"outer({j})"


def _at(X, col):
    """The column's values with its MSB variable at X (a HighToLow pass)."""
    half = len(col) // 2
    return [(lo + X * (hi - lo)) % P for lo, hi in zip(col[:half],
                                                       col[half:])]


@pytest.mark.parametrize("n", [5, 6])
def test_gruen_message_matches_dense_and_jax_every_round(n):
    """sum_x eq(w, x) g(x) HighToLow: each round's Gruen-lifted message
    equals the dense message (scaled by c_j) at X in {0, 2}, the JAX
    package's lift of the same inner message, and the final scalar is
    eq(w, r)."""
    w = _point(n, 10 + n)
    rng = random.Random(20 + n)
    g = [rng.randrange(P) for _ in range(1 << n)]
    mine = se.GruenSplitEq(w, device=CPU)
    theirs = jse.GruenSplitEq(w)
    rs = []
    for rnd in range(n):
        assert mine.current_w() == theirs.current_w() == w[rnd]
        E = _mine(eq.evals(w[rnd:], CPU))
        dense_msg = [sum(e * v % P for e, v in zip(_at(X, E), _at(X, g)))
                     % P for X in (0, 2)]
        tail = _mine(mine.outer(rnd + 1)) if rnd + 1 < n else [1]
        t = [sum(e * v % P for e, v in zip(tail, _at(X, g))) % P
             for X in (0, 2)]
        got = mine.gruen_evals(t, 1)
        assert got == theirs.gruen_evals(t, 1), f"round {rnd}"
        assert got == [mine.scalar * v % P for v in dense_msg], f"round {rnd}"
        r = rng.randrange(P)
        rs.append(r)
        mine.bind(r)
        theirs.bind(r)
        assert mine.scalar == theirs.scalar
        g = _at(r, g)
    assert mine.scalar == eq.eq_int(w, rs)


@pytest.mark.parametrize("n", [4, 5])
def test_eq_plus_one_matches_jax(n):
    w = _point(n, 30 + n)
    tab = _mine(se.eq_plus_one_evals(w, device=CPU))
    assert tab == _theirs(jse.eq_plus_one_evals(w))
    E = _mine(eq.evals(w, CPU))
    for x in range(1 << n):
        want = E[x + 1] if x + 1 < (1 << n) else 0
        bits = [(x >> (n - 1 - i)) & 1 for i in range(n)]
        assert tab[x] == want == se.eq_plus_one_int(w, bits) \
            == jse.eq_plus_one_int(w, bits)


def _poly(n, seed):
    vals = _point(1 << n, seed)
    vals[:3] = [P - 1, 0, 1]
    return vals, ops.pack_ints(vals, CPU), jops.pack_ints(vals)


@pytest.mark.parametrize("order", ["high", "low"])
def test_dense_bind_matches_jax(order):
    vals, mine, theirs = _poly(5, 40)
    r = _point(1, 41)[0]
    got = _mine(dense.bind(mine, r, order))
    assert got == _theirs(jdense.bind(theirs, jops.pack_ints([r]), order))
    assert got == _mine(dense.bind(mine, ops.pack_ints([r], CPU), order))
    half = len(vals) // 2
    pairs = (zip(vals[:half], vals[half:]) if order == "high"
             else zip(vals[0::2], vals[1::2]))
    assert got == [(lo + r * (hi - lo)) % P for lo, hi in pairs]


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_sumcheck_eval_points_low_matches_jax(degree):
    _, mine, theirs = _poly(5, 50 + degree)
    got = dense.sumcheck_eval_points_low(mine, degree)
    want = jdense.sumcheck_eval_points_low(theirs, degree)
    assert tuple(got.shape[1:]) == tuple(want.shape[1:]) == (degree, 16)
    assert _mine(got.reshape(8, -1)) == _theirs(want.reshape(
        want.shape[0], -1))


def test_from_u64_column_and_mont_sqr_match_jax():
    rng = np.random.default_rng(60)
    v = rng.integers(0, 1 << 64, size=29, dtype=np.uint64)
    v[:5] = [0, 1, (1 << 32) - 1, 1 << 63, (1 << 64) - 1]
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    got = dense.from_u64_column(lo, hi, device=CPU)
    assert _mine(got) == _theirs(jdense.from_u64_column(lo, hi)) \
        == [int(x) % P for x in v]
    # torch words, and wider integer types holding the same bits
    assert torch.equal(dense.from_u64_column(
        torch.from_numpy(lo.astype(np.int64)), hi.astype(np.int64),
        device=CPU), got)
    sq = _mine(ops.mont_sqr(got))
    assert sq == _theirs(jops.mont_sqr(jdense.from_u64_column(lo, hi))) \
        == [int(x) ** 2 % P for x in v]


def test_new_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default and runs")
    words = np.zeros(4, np.uint32)
    for call in (lambda: se.GruenSplitEq([1, 2]),
                 lambda: se.eq_plus_one_evals([1, 2]),
                 lambda: dense.from_u64_column(words, words)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---- host copies -----------------------------------------------------------

def test_pedersen_folds_match_jax():
    mine = pedersen.PedersenBasis.create(3)
    theirs = jped.PedersenBasis.create(3)
    assert mine.G == theirs.G and mine.H == theirs.H
    a, b = mine.G[0], pedersen.pedersen_commit(mine, [5, 6, 7], 11)
    k = P + 12345                      # reduced mod r by both
    assert pedersen.commit_add(a, b) == jped.commit_add(a, b)
    assert pedersen.commit_add(a, None) == a
    assert pedersen.commit_scale(b, k) == jped.commit_scale(b, k)
    assert pedersen.commit_fold(a, b, k) == jped.commit_fold(a, b, k) \
        == pedersen.commit_add(a, pedersen.commit_scale(b, k))


@pytest.mark.parametrize("m, cols", [(1, 4), (4, 4), (5, 4), (33, 8),
                                     (100, 16)])
def test_grid_dims_matches_jax(m, cols):
    assert fold.grid_dims(m, cols) == jfold.grid_dims(m, cols)


def test_host_eq_evals_matches_jax():
    r = _point(4, 70)
    assert ir.host_eq_evals(r) == jir.host_eq_evals(r) \
        == _mine(eq.evals(r, CPU))


def _g2(q):
    return None if q is None else (q[0].a, q[0].b, q[1].a, q[1].b)


def test_native_list_forms_match_jax():
    rng = random.Random(80)
    a, b = _point(9, 81), _point(9, 82)
    alpha = rng.randrange(P)
    assert native_pairing.fr_fold(a, b, alpha) == jnp_.fr_fold(a, b, alpha) \
        == [(alpha * x + y) % P for x, y in zip(a, b)]
    assert native_pairing.fr_dot(a, b) == jnp_.fr_dot(a, b) \
        == sum(x * y for x, y in zip(a, b)) % P
    parts = [(np.array([0, 5, 9, 5, 15]), 7, None),
             (np.array([1, 2, 12]), 3, [4, 5, 6])]
    L = _point(4, 83)
    assert (native_pairing.fr_combined_row(parts, L, 4, 2)
            == jnp_.fr_combined_row(parts, L, 4, 2))
    # G1 folds: a shared scalar (the GLV path) and per-lane scalars
    g1a = pedersen.PedersenBasis.create(4).G
    g1b = [None] + g1a[1:]
    for scalars in ([alpha] * 4, _point(4, 84)):
        got = native_pairing.g1_fold_batch(g1a, g1b, scalars)
        assert got == jnp_.g1_fold_batch(g1a, g1b, scalars)
        assert got[0] == g1a[0]
    # G2 (each package's own Fq2 class: compared as coordinates)
    ks = [3, 5, 7]
    mine = [pairing.g2_mul(pairing.G2_GEN, k) for k in ks] + [None]
    theirs = [jpairing.g2_mul(jpairing.G2_GEN, k) for k in ks] + [None]
    assert list(map(_g2, mine)) == list(map(_g2, theirs))
    sc = _point(4, 85)
    assert (list(map(_g2, native_pairing.g2_mul_batch(mine, sc)))
            == list(map(_g2, jnp_.g2_mul_batch(theirs, sc))))
    assert (list(map(_g2, native_pairing.g2_fold_batch(mine, mine[::-1],
                                                       alpha)))
            == list(map(_g2, jnp_.g2_fold_batch(theirs, theirs[::-1],
                                                alpha))))
    buf, inf = native_pairing.g2_enc_many(mine)
    assert (list(map(_g2, native_pairing.g2_dec_many(buf, inf)))
            == list(map(_g2, jnp_.g2_dec_many(buf, inf))) == list(map(
                _g2, mine)))
