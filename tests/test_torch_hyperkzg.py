"""The port's HyperKZG (`jolt_tpu_torch/pcs/hyperkzg.py`) against the JAX
package's (`jolt_tpu/pcs/hyperkzg.py`), on the CPU, at a 2^5 SRS with the
JAX package's tau.

The setup's powers, a seeded commit and open on `Blake2bTranscript(
b"hkzg_test")` (commitment, every `HyperKZGProof` field, the transcript's
state), the port's `verify` (accepting, and rejecting a wrong value,
commitment and witness, as tests/test_hyperkzg.py does), and the JAX
package's `verify` of the port's proof.  On the CPU the port's commits run
`bn254_host.g1_msm_pippenger` over the host powers; the card's MSM is held
against it in tests/test_torch_cuda.py and `chip_smoke.py`.
"""

import copy
import random

import pytest
import torch

from jolt_tpu.pcs import hyperkzg as jhkzg
from jolt_tpu.poly import dense as jdense
from jolt_tpu.transcript import Blake2bTranscript as JTranscript

from jolt_tpu_torch.curve import bn254_host as host
from jolt_tpu_torch.field.params import FR_MODULUS as P
from jolt_tpu_torch.pcs import hyperkzg as thkzg
from jolt_tpu_torch.pcs.scheme import HyperKZGScheme, make_scheme
from jolt_tpu_torch.transcript import Blake2bTranscript as TTranscript

torch.set_num_threads(1)

ELL = 5
N = 1 << ELL


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    """The JAX package's setup (in a directory of its own, so no other
    test's cache file is read or written) and the port's on the CPU."""
    jset = jhkzg.KZGSetup.generate(
        N, cache_dir=str(tmp_path_factory.mktemp("jax_srs")))
    tset = thkzg.KZGSetup.generate(
        N, device="cpu", cache_dir=str(tmp_path_factory.mktemp("port_srs")))
    return jset, tset


@pytest.fixture(scope="module")
def opened(setups):
    jset, tset = setups
    rng = random.Random(99)
    coeffs = [rng.randrange(P) for _ in range(N)]
    point = [rng.randrange(P) for _ in range(ELL)]
    value = jdense.evaluate(jdense.from_ints(coeffs), point)
    out = {}
    for name, mod, setup, transcript in (
            ("jax", jhkzg, jset, JTranscript),
            ("port", thkzg, tset, TTranscript)):
        scheme = mod.HyperKZG(setup)
        tp = transcript(b"hkzg_test")
        commitment = scheme.commit_ints(coeffs)
        proof = scheme.open(coeffs, point, value, tp)
        out[name] = (commitment, proof, tp.state)
    return coeffs, point, value, out


def _g2(p):
    return tuple(int(c) for f in p for c in (f.a, f.b))


def test_setup_powers_match_jax(setups, tmp_path):
    jset, tset = setups
    assert tset.size == jset.size == N
    assert tset.host_powers() == jset.host_powers()
    assert _g2(tset.tau_g2) == _g2(jset.tau_g2)
    # the cache gives the same setup back
    again = thkzg.KZGSetup.generate(N, device="cpu",
                                    cache_dir=str(tmp_path))
    cached = thkzg.KZGSetup.generate(N, device="cpu",
                                     cache_dir=str(tmp_path))
    assert cached.host_powers() == again.host_powers() == jset.host_powers()
    assert cached.device == torch.device("cpu")


def test_commit_open_match_jax(opened):
    _, _, _, out = opened
    (jc, jp, js), (tc, tp, ts) = out["jax"], out["port"]
    assert tc == jc
    assert tp.fold_commitments == jp.fold_commitments
    assert tp.evals == jp.evals
    assert tp.witnesses == jp.witnesses
    assert ts == js


def test_port_verify_accepts_and_rejects(setups, opened):
    _, tset = setups
    _, point, value, out = opened
    commitment, proof, _ = out["port"]
    scheme = thkzg.HyperKZG(tset)

    def ok(c, v, pf):
        return scheme.verify(c, point, v, pf, TTranscript(b"hkzg_test"))
    assert ok(commitment, value, proof)
    assert not ok(commitment, (value + 1) % P, proof)
    assert not ok(host.g1_add(commitment, host.G1_GEN), value, proof)
    bad = copy.deepcopy(proof)
    bad.witnesses[0] = host.g1_add(bad.witnesses[0], host.G1_GEN)
    assert not ok(commitment, value, bad)


def test_jax_verify_accepts_the_ports_proof(setups, opened):
    jset, _ = setups
    _, point, value, out = opened
    commitment, proof, _ = out["port"]
    jproof = jhkzg.HyperKZGProof(list(proof.fold_commitments),
                                 [list(e) for e in proof.evals],
                                 list(proof.witnesses))
    assert jhkzg.HyperKZG(jset).verify(commitment, point, value, jproof,
                                       JTranscript(b"hkzg_test"))


def test_scheme_commits_one_hots_as_the_dense_vector(setups):
    """`HyperKZGScheme.commit_sparse` (the sum of the powers at the ones)
    equals the JAX scheme's dense 1-bit commit of the same vector, and
    `make_scheme` wraps a KZG setup."""
    jset, tset = setups
    from jolt_tpu.pcs.scheme import HyperKZGScheme as JScheme
    import numpy as np
    positions = np.array([0, 3, 17, 31], dtype=np.int64)
    got = HyperKZGScheme(tset, "cpu").commit_sparse("a", positions, N)
    assert got == JScheme(jset).commit_sparse("a", positions, N)
    assert isinstance(make_scheme(tset, "cpu"), HyperKZGScheme)
    assert make_scheme(tset).setup_digest() == JScheme(jset).setup_digest()
