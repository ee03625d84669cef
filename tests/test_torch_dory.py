"""The torch port's Dory (`jolt_tpu_torch/pcs/dory.py`, `pcs/scheme.py`,
`curve/native_pairing.py` with the library built from
`jolt_tpu_torch/csrc/pairing.cpp`) against the JAX package's, on the CPU.

  * `DorySetup.generate(6)` (nu = 3, sigma = 3) gives the JAX package's
    setup value for value, and the port's cache loads back equal.
  * `Dory.commit` on seeded dense coefficients and `commit_onehot_many` on
    seeded positions over several matrices give the JAX package's GT bytes.
  * `DoryScheme.open_rlc` on seeded weighted parts (one-hot and dense)
    gives the JAX package's proof fields and transcript state; the port's
    `combine` + `verify_rlc` accept that proof and reject a changed `e1`,
    a changed `b_final_s` and a wrong value.
  * The port's native and Python tiers of `open` (JOLT_TPU_NO_NATIVE_PAIRING)
    give identical proofs and transcript states, and the one-hot commit's
    K3 route (here on the CPU: K3's plain versions) gives the native
    tier's row hints and commitments.
  * The K3 route (`Dory(..., _k3=True)`, the route of a CUDA Dory, here
    on CPU tensors) gives the native route's and the JAX package's row
    hints and GT bytes for `commit_onehot_many`, `commit_sparse` and a
    dense `commit` with an all-zero row and a short tail row, and
    `open_rlc`'s proof fields and transcript state.
"""

import copy

import numpy as np
import pytest
import torch

from jolt_tpu.pcs import dory as jdory
from jolt_tpu.pcs import scheme as jscheme
from jolt_tpu.transcript import Blake2bTranscript as JTranscript

from jolt_tpu_torch.curve import native_pairing
from jolt_tpu_torch.pcs import dory as tdory
from jolt_tpu_torch.pcs import scheme as tscheme
from jolt_tpu_torch.transcript import Blake2bTranscript as TTranscript
from test_torch_stage1 import _rand_vals

torch.set_num_threads(1)

P = tdory.P
NUM_VARS = 6                       # nu = 3, sigma = 3: 8 x 8 matrices
N = 1 << NUM_VARS
ONEHOT_K = 8                       # one-hot matrices: K = 8 rows of T = 8
ONEHOT_T = N // ONEHOT_K


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    port = tdory.DorySetup.generate(
        NUM_VARS, cache_dir=str(tmp_path_factory.mktemp("port_srs")))
    jax = jdory.DorySetup.generate(
        NUM_VARS, cache_dir=str(tmp_path_factory.mktemp("jax_srs")))
    return port, jax


def _gt(pkg, f):
    return (tdory if pkg == "port" else jdory).gt_to_bytes(f)


def _setup_values(pkg, s):
    mod = tdory if pkg == "port" else jdory
    levels = [(lv.g1, [mod._g2_bytes(q) for q in lv.g2],
               [_gt(pkg, getattr(lv, k))
                for k in ("chi", "d1l", "d1r", "d2l", "d2r")])
              for lv in s.levels]
    return s.nu, s.sigma, s.gamma1, mod._g2_bytes(s.g2star), levels


def test_setup_matches_jax(setups, tmp_path):
    port, jax = setups
    assert (port.nu, port.sigma) == (3, 3)
    assert _setup_values("port", port) == _setup_values("jax", jax)
    # the port's cache: written atomically under its own name, loaded back
    again = tdory.DorySetup.generate(NUM_VARS, cache_dir=str(tmp_path))
    assert [p.name for p in tmp_path.iterdir()] == ["dory_torch_ate_3_3.pkl"]
    loaded = tdory.DorySetup.generate(NUM_VARS, cache_dir=str(tmp_path))
    assert type(loaded) is tdory.DorySetup
    assert _setup_values("port", loaded) == _setup_values("port", again)


def test_setup_cache_refuses_a_foreign_class(setups, tmp_path):
    """A cache file naming the JAX package's classes is refused, not
    loaded (loading it would import JAX)."""
    import pickle
    (tmp_path / "dory_torch_ate_3_3.pkl").write_bytes(
        pickle.dumps(setups[1]))
    with pytest.raises(pickle.UnpicklingError, match="jolt_tpu.pcs.dory"):
        tdory.DorySetup.generate(NUM_VARS, cache_dir=str(tmp_path))


def _onehot_positions(seed, n_mats):
    """Address-major positions k*T + j of seeded one-hot matrices."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, ONEHOT_K, ONEHOT_T).astype(np.int64) * ONEHOT_T
            + np.arange(ONEHOT_T, dtype=np.int64) for _ in range(n_mats)]


@pytest.mark.parametrize("length", [N, N - 11, 20])
def test_commit_matches_jax(setups, length):
    coeffs = _rand_vals(length, 300 + length)
    port, jax = setups
    tc, th = tdory.Dory(port, "cpu").commit(coeffs)
    jc, jh = jdory.Dory(jax).commit(coeffs)
    assert _gt("port", tc.c) == _gt("jax", jc.c)
    assert th.rows == jh.rows


def test_commit_onehot_many_matches_jax(setups):
    positions = _onehot_positions(310, 4)
    port, jax = setups
    got = tdory.Dory(port, "cpu").commit_onehot_many(positions)
    want = jdory.Dory(jax).commit_onehot_many(positions)
    assert len(got) == len(want) == 4
    for (tc, th), (jc, jh) in zip(got, want):
        assert _gt("port", tc.c) == _gt("jax", jc.c)
        assert th.rows == jh.rows


def _eq_table(point):
    tab = [1]
    for r in point:
        tab = [w * v % P for w in tab for v in ((1 - r) % P, r)]
    return tab


def _rlc_case(seed):
    """Named committed polynomials (three one-hot, one dense), their RLC
    weights and parts, a point and the RLC's value there."""
    onehot = dict(zip(("a", "b", "c"), _onehot_positions(seed, 3)))
    dense = _rand_vals(N - 5, seed + 1)
    weights = dict(zip(("a", "b", "c", "d"), _rand_vals(4, seed + 2)))
    point = _rand_vals(NUM_VARS, seed + 3)
    parts = [(onehot[n], weights[n], None) for n in ("a", "b", "c")]
    parts.append((np.arange(len(dense), dtype=np.int64), weights["d"], dense))
    eqt = _eq_table(point)
    value = 0
    for positions, w, vals in parts:
        for i, pos in enumerate(positions.tolist()):
            value += w * (1 if vals is None else vals[i]) * eqt[pos]
    return onehot, dense, weights, parts, point, value % P


def _open(pkg, setup, case, label=b"dory", k3=False):
    """Commit the case's polynomials through the package's DoryScheme (the
    port's on the CPU, on its K3 route with `k3`) and open their RLC;
    returns the commitments, the proof and the transcript."""
    onehot, dense, weights, parts, point, value = case
    scheme = (tscheme.DoryScheme(setup, "cpu", _k3=k3) if pkg == "port"
              else jscheme.DoryScheme(setup))
    comms = scheme.commit_sparse_many(list(onehot.items()))
    comms["d"] = scheme.commit("d", dense)
    tr = (TTranscript if pkg == "port" else JTranscript)(label)
    tr.append_scalar(b"prior", 4242)
    proof = scheme.open_rlc(weights, parts, point, value, tr)
    return scheme, comms, proof, tr


def _proof_values(pkg, proof):
    mod = tdory if pkg == "port" else jdory
    gts = {k: [_gt(pkg, f) for f in getattr(proof, k)]
           for k in ("a_d1l", "a_d1r", "a_d2l", "a_d2r", "a_cplus",
                     "a_cminus")}
    return (proof.e1, gts, proof.a_final_v1, mod._g2_bytes(proof.a_final_v2),
            proof.b_xl, proof.b_xr, proof.b_yl, proof.b_yr, proof.b_final_s)


@pytest.fixture(scope="module")
def opened(setups):
    case = _rlc_case(400)
    return case, _open("port", setups[0], case), _open("jax", setups[1], case)


def test_open_rlc_matches_jax(opened):
    _, (_, tcomms, tproof, ttr), (_, jcomms, jproof, jtr) = opened
    assert {n: _gt("port", c.c) for n, c in tcomms.items()} == \
        {n: _gt("jax", c.c) for n, c in jcomms.items()}
    assert _proof_values("port", tproof) == _proof_values("jax", jproof)
    assert (len(tproof.a_d1l), len(tproof.b_xl)) == (3, 3)
    assert ttr.state == jtr.state and ttr.n_rounds == jtr.n_rounds


def _verify(scheme, comms, case, proof, value=None):
    _, _, weights, _, point, true_value = case
    tr = TTranscript(b"dory")
    tr.append_scalar(b"prior", 4242)
    joint = scheme.combine(comms, weights)
    return scheme.verify_rlc(joint, point,
                             true_value if value is None else value, proof,
                             tr)


@pytest.mark.parametrize("change", [None, "e1", "b_final_s", "value"])
def test_verify_accepts_the_proof_and_rejects_a_change(opened, change):
    case, (scheme, comms, proof, _), _ = opened
    bad = copy.deepcopy(proof)
    value = None
    if change == "e1":
        from jolt_tpu_torch.curve import bn254_host as host
        bad.e1 = host.g1_add(bad.e1, host.G1_GEN)
    elif change == "b_final_s":
        bad.b_final_s = (bad.b_final_s + 1) % P
    elif change == "value":
        value = (case[-1] + 1) % P
    assert _verify(scheme, comms, case, bad, value) is (change is None)


def test_native_and_python_tiers_agree(setups, opened, monkeypatch):
    """Dory.open and DoryScheme.open_rlc on the Python tier give the native
    tier's proof and transcript; so does the dense commit."""
    case, (_, comms, native_proof, native_tr), _ = opened
    assert native_pairing.available()
    onehot, dense, weights, parts, point, value = case
    scheme = tscheme.DoryScheme(setups[0], "cpu")
    scheme.commit_sparse_many(list(onehot.items()))     # native hints
    scheme.commit("d", dense)
    monkeypatch.setenv("JOLT_TPU_NO_NATIVE_PAIRING", "1")
    assert not native_pairing.available()
    tr = TTranscript(b"dory")
    tr.append_scalar(b"prior", 4242)
    proof = scheme.open_rlc(weights, parts, point, value, tr)
    assert _proof_values("port", proof) == _proof_values("port",
                                                         native_proof)
    assert tr.state == native_tr.state
    # the dense commit's Python tier gives the native tier's commitment
    assert _gt("port", scheme.commit("d", dense).c) == _gt("port",
                                                           comms["d"].c)
    # the one-hot commit's K3 route (K3's plain versions on the CPU): the
    # native tier's row hints (tier 1) and commitments
    device_tier = tdory.Dory(setups[0], "cpu", _k3=True).commit_onehot_many(
        list(onehot.values()))
    for name, (com, hint) in zip(onehot, device_tier):
        assert hint.rows == scheme._hints[name].rows
        assert _gt("port", com.c) == _gt("port", comms[name].c)


def test_scheme_refuses_what_is_not_ported(setups):
    """`DoryScheme.commit_sparse` (`Dory.commit_onehot`) on the K3 route
    (it raised before the device G1 was ported) equals the native route's
    `commit_sparse_many` for one matrix, hint included; `make_scheme`
    passes schemes through and refuses a setup it does not know (the JAX
    package's)."""
    positions = _onehot_positions(1, 1)[0]
    scheme = tscheme.DoryScheme(setups[0], "cpu")
    one = tscheme.DoryScheme(setups[0], "cpu", _k3=True)
    com = one.commit_sparse("a", positions, N)
    many = scheme.commit_sparse_many([("b", positions)])["b"]
    assert _gt("port", com.c) == _gt("port", many.c)
    assert one._hints["a"].rows == scheme._hints["b"].rows
    assert tscheme.make_scheme(None) is None
    assert tscheme.make_scheme(scheme) is scheme
    with pytest.raises(TypeError):
        tscheme.make_scheme(setups[1])          # the JAX package's setup


def test_route_follows_the_device(setups):
    """A CUDA Dory takes the K3 route and a CPU Dory the native one; the
    route argument overrides either; Gamma1's device copy is made once a
    device and kept with the setup, out of its pickle."""
    import pickle
    port = setups[0]
    assert tscheme.DoryScheme(port, "cuda").dory.k3
    assert not tscheme.DoryScheme(port, "cpu").dory.k3
    assert tdory.Dory(port, "cpu", _k3=True).k3
    assert not tdory.Dory(port, "cuda", _k3=False).k3
    gam = port.gamma1_on("cpu")
    assert port.gamma1_on(torch.device("cpu")) is gam
    assert tdory.Dory(port, "cpu", _k3=True).setup.gamma1_on("cpu") is gam
    again = pickle.loads(pickle.dumps(port))
    assert "_gamma1_dev" not in again.__dict__
    assert _setup_values("port", again) == _setup_values("port", port)


@pytest.mark.parametrize("length", [N - 11, 20])
def test_k3_route_dense_commit_matches_jax(setups, length):
    """A dense commit on the K3 route (one MSM a row over Gamma1, here K3's
    plain versions): an all-zero row (a None hint) and a short tail row
    give the native route's and the JAX package's hints and GT bytes."""
    coeffs = _rand_vals(length, 500 + length)
    coeffs[8:16] = [0] * 8                        # row 1 is all zero
    port, jax = setups
    kc, kh = tdory.Dory(port, "cpu", _k3=True).commit(coeffs)
    nc, nh = tdory.Dory(port, "cpu").commit(coeffs)
    jc, jh = jdory.Dory(jax).commit(coeffs)
    assert kh.rows[1] is None and kh.rows[(length - 1) // 8] is not None
    assert kh.rows == nh.rows == jh.rows
    assert _gt("port", kc.c) == _gt("port", nc.c) == _gt("jax", jc.c)


def test_k3_route_onehot_many_matches_jax(setups):
    """`commit_onehot_many` on the K3 route (one bucket_sum over every
    matrix's rows) gives the JAX package's row hints and GT bytes."""
    positions = _onehot_positions(320, 3)
    port, jax = setups
    got = tdory.Dory(port, "cpu", _k3=True).commit_onehot_many(positions)
    want = jdory.Dory(jax).commit_onehot_many(positions)
    for (tc, th), (jc, jh) in zip(got, want):
        assert th.rows == jh.rows
        assert _gt("port", tc.c) == _gt("jax", jc.c)


def test_k3_route_open_rlc_matches_jax(setups, opened):
    """The K3 route's commits and `open_rlc` (phase B's MSMs and Gamma1
    folds on K3's plain versions) give the JAX package's commitments,
    proof fields and transcript state, and the native route's."""
    case, (_, ncomms, nproof, ntr), (_, jcomms, jproof, jtr) = opened
    _, comms, proof, tr = _open("port", setups[0], case, k3=True)
    assert {n: _gt("port", c.c) for n, c in comms.items()} == \
        {n: _gt("jax", c.c) for n, c in jcomms.items()}
    assert _proof_values("port", proof) == _proof_values("jax", jproof) \
        == _proof_values("port", nproof)
    assert tr.state == jtr.state == ntr.state
    assert tr.n_rounds == jtr.n_rounds


def test_failed_library_build_raises(monkeypatch, tmp_path):
    """A pairing library that does not build raises; it never selects the
    Python tier."""
    broken = tmp_path / "pairing.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_pairing, "SRC", str(broken))
    monkeypatch.setattr(native_pairing, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native_pairing, "_lib", None)
    with pytest.raises(RuntimeError, match="pairing.cpp failed"):
        native_pairing.load()
    assert not list((tmp_path / "b").iterdir())     # no half-built file
