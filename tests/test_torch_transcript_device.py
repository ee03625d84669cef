"""The port's device transcript (`transcript/device.py`): the plain
version of K4's round tail against hashlib, the host transcript and the JAX
package's device transcript, on the CPU.

  * one Blake2b-256 compression == `hashlib.blake2b` and == the JAX
    package's `transcript.device.compress`, on numpy-seeded blocks of every
    length a transcript step can have;
  * `canonical_words_be` and `challenge125_to_mont` == the JAX package's
    (values 0, 1, p - 1; digests with the top three bits of the challenge
    set);
  * seeded stages of plain round tails (`k4_case` of
    `tests/test_torch_cuda.py`: 1-4 instances of degrees 1-3, inactive
    rounds, claims 0 and p - 1, starting states from a real transcript) ==
    the host engine's round algebra on the host `Blake2bTranscript`: each
    round's compressed polynomial, challenge, state, n_rounds and claims,
    one stage among them with a squeeze whose top three bits are set; and
    the wide stages the card test holds K4 to (`K4_WIDE`: 33-64
    instances, 1-3 compressed coefficients, inactive instances of every
    degree), in three rounds;
  * K4's forms of the batching coefficients (`k4_weights`): a Montgomery
    product by each gives the canonical product.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jolt_tpu.field import ops as jops
from jolt_tpu.transcript import device as jdt

from jolt_tpu_torch.field import kernels
from jolt_tpu_torch.field import ops as tops
from jolt_tpu_torch.poly.univariate import UniPoly
from jolt_tpu_torch.transcript import Blake2bTranscript
from jolt_tpu_torch.transcript import device as dt
from test_torch_cuda import K4_WIDE, k4_case, run_k4_case

torch.set_num_threads(1)

P = jops.FR.modulus
CPU = "cpu"
MASK125 = (1 << 125) - 1


def _block(data: bytes) -> np.ndarray:
    """<= 128 bytes -> the zero-padded block as (16, 2) (lo, hi) uint32."""
    padded = data + b"\x00" * (128 - len(data))
    return np.frombuffer(padded, dtype="<u4").reshape(16, 2).astype(np.uint32)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 63, 64, 96, 127, 128])
def test_compress_matches_hashlib_and_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    m = _block(data)
    got = dt.compress(dt._words64(dt.H_INIT, CPU),
                      torch.from_numpy(m.astype(np.int64)), n)
    assert (dt.words_to_state(got[:4].numpy())
            == hashlib.blake2b(data, digest_size=32).digest())
    want = np.asarray(jdt.compress(jnp.asarray(jdt.H_INIT), jnp.asarray(m),
                                   n))
    assert got.numpy().tolist() == want.astype(np.int64).tolist()


def test_canonical_words_be_matches_jax():
    rng = np.random.default_rng(7)
    vals = [0, 1, P - 1] + [int(v) % P for v in
                            rng.integers(0, 1 << 62, 5, dtype=np.int64)]
    vals.append(sum(1 << (60 * i) for i in range(4)) % P)
    for v in vals:
        got = dt.canonical_words_be(tops.pack_ints([v], CPU))
        want = np.asarray(jdt.canonical_words_be(jops.pack_ints([v])))
        assert got.numpy().tolist() == want.astype(np.int64).tolist()
        assert dt.words_to_state(got.numpy()) == v.to_bytes(32, "big")


def test_challenge125_to_mont_matches_jax():
    rng = np.random.default_rng(8)
    digests = rng.integers(0, 1 << 32, (6, 4, 2), dtype=np.uint64)
    digests[0, 1, 1] |= 0xE0000000        # the top 3 bits of the 128 set
    digests[1] = 0xFFFFFFFF
    digests[2] = 0
    for d in digests.astype(np.uint32):
        want_int = int.from_bytes(dt.words_to_state(d)[:16],
                                  "little") & MASK125
        got = tops.unpack_ints(dt.challenge125_to_mont(
            torch.from_numpy(d.astype(np.int64))))
        want = jops.unpack_ints(jdt.challenge125_to_mont(jnp.asarray(d)))
        assert got == want == [want_int]


def _host_rounds(case: dict):
    """The host engine's round algebra (`engine.BatchedSumcheck.prove`'s
    loop body) on the host transcript: per round (compressed, challenge,
    state, n_rounds, claims, the squeeze's top three bits all set)."""
    tr = Blake2bTranscript(b"Jolt")
    tr.state, tr.n_rounds = case["state"], case["n_rounds"]
    claims = list(case["claims"])
    out = []
    for row in case["evals"]:
        polys = [UniPoly([c * pow(2, -1, P) % P]) if v is None
                 else UniPoly.from_evals_and_hint(c, v, P)
                 for v, c in zip(row, claims)]
        batched = UniPoly([0])
        for poly, w in zip(polys, case["coeffs"]):
            batched = batched.add(poly.scale(w))
        compressed = batched.compress()
        tr.append_scalars(b"sumcheck_poly", compressed)
        u128 = tr.challenge_u128()
        r = u128 & MASK125
        claims = [poly.evaluate(r) for poly in polys]
        out.append((compressed, r, tr.state, tr.n_rounds, claims,
                    u128 >> 125 == 7))
    return out


def _decode(flat: torch.Tensor, case: dict, rnd: int, n_c: int):
    """A round's (compressed, challenge, state, n_rounds, claims) from the
    stage buffers' host copy."""
    n, rounds = len(case["degrees"]), len(case["evals"])
    width = max(case["degrees"])
    w = flat.numpy().view(np.uint32)
    comp = w[9 + 16 * n:9 + 16 * n + 8 * rounds * width].reshape(
        rounds, width, 8)
    r = w[9 + 16 * n + 8 * rounds * width:].reshape(rounds, 8)
    claims = w[9:9 + 8 * n].reshape(n, 8)
    return (tops.np_unpack_ints(comp[rnd, :n_c].T),
            tops.np_unpack_ints(r[rnd][:, None])[0],
            dt.words_to_state(w[:8]), int(w[8]),
            tops.np_unpack_ints(claims.T))


@pytest.mark.parametrize("seed", range(6))
def test_plain_round_tails_match_host_transcript(seed):
    case = k4_case(seed)
    host = _host_rounds(case)
    got = run_k4_case(case, CPU)
    for rnd, (want, flat) in enumerate(zip(host, got)):
        assert _decode(flat, case, rnd, len(want[0])) == want[:5], rnd


def test_seeded_stages_have_a_squeeze_with_top_bits_set():
    """Seed 5 of `k4_case`, among the seeds the card test holds K4 to its
    plain version with, has a squeeze whose top three bits of the 128 are
    set (the bits `challenge_scalar_optimized` clears); the test above
    holds its plain round tails to the host."""
    assert any(h[5] for h in _host_rounds(k4_case(5)))


@pytest.mark.parametrize("seed,n_inst", K4_WIDE)
def test_plain_round_tails_match_host_transcript_wide(seed, n_inst):
    """The plain version at K4's widths (33-64 instances) == the host
    engine's algebra, after each of the stage's three rounds, whose
    compressed lengths are 1, 2 and 3."""
    case = k4_case(seed, n_inst)
    host = _host_rounds(case)
    assert [len(h[0]) for h in host] == [1, 2, 3]
    got = run_k4_case(case, CPU)
    for rnd, (want, flat) in enumerate(zip(host, got)):
        assert _decode(flat, case, rnd, len(want[0])) == want[:5], rnd


def _words(vals) -> torch.Tensor:
    """Canonical ints -> their raw words (8, n) int32 (no conversion)."""
    return torch.from_numpy(np.ascontiguousarray(
        tops.words_of_ints(vals)).view(np.int32))


def _ints(words: torch.Tensor):
    """Raw words (8, n) -> ints (no conversion)."""
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    return [sum(int(w[k, i]) << (32 * k) for k in range(8))
            for i in range(w.shape[1])]


def test_k4_weights_give_canonical_products():
    """For each batching coefficient w, `k4_weights` gives w, w/2 and w/6
    such that a Montgomery product (`mont_mul_plain`) of x R by each is the
    canonical x w (x w/2, x w/6): K4 takes each term of the batched
    polynomial as the canonical value that the transcript absorbs, in one
    product."""
    rng = np.random.default_rng(11)
    ws = [0, 1, P - 1] + [int(v) % P for v in
                          rng.integers(0, 1 << 62, 3, dtype=np.int64)]
    xs = [0, 1, P - 1, 12345678901234567890 % P]
    forms = dt.k4_weights(ws)
    assert len(forms) == kernels.K4_WEIGHTS * len(ws)
    x_mont = _words([x * kernels.R % P for x in xs])
    for i, w in enumerate(ws):
        for k, mult in zip(forms[3 * i:3 * i + 3],
                           (w, w * dt.INV2, w * dt.INV6)):
            got = kernels.mont_mul_plain(x_mont, _words([k] * len(xs)))
            assert _ints(got) == [x * mult % P for x in xs]
