"""The torch port's zk and committed-image proofs against the JAX
package's, byte for byte, on the CPU (slow tier).

For each case the port's `prove(..., device="cpu")` and `jolt_tpu.prove`
run on the same trace (the port's is `interop`'s copy of the JAX
package's), with the same flags, the same Dory setup size and, with zk,
`zk_rng=random.Random(42)` on both sides:

  * fib of the JAX package's `tests/test_zk_prove.py` with zk;
  * the guest of `tests/test_program_image.py` (it reads its own code
    through RAM, so its RAM space holds the image) with the committed
    image;
  * the Dory pipeline guest of `tests/test_full_pipeline_dory.py` with a
    2^13 Dory setup and zk;
  * the image guest with a 2^13 Dory setup and the committed image.

`proof_io.serialize_proof` gives the same bytes, the port's FS tape equals
the JAX package's (JOLT_TPU_FS_TRACE) at every checkpoint the port takes,
and the port's `verify` accepts.  Slow tier because the JAX package's
BlindFold commits every grid row with a Python double-and-add MSM (minutes
for fib) and its Dory proves compile for minutes cold.
"""

import dataclasses
import json
import random

import pytest

from jolt_tpu import proof_io as jproof_io
from jolt_tpu.pcs.dory import DorySetup as JDorySetup
from jolt_tpu.prover import prove as j_prove
from jolt_tpu.riscv.emulator import MemoryLayout as JaxLayout
from jolt_tpu.tracer import trace_program

import jolt_tpu_torch as jt
from jolt_tpu_torch import proof_io
from jolt_tpu_torch.pcs.dory import DorySetup
from test_program_image import GUEST as IMAGE_GUEST
from test_torch_prove import DORY_GUEST, DORY_LAYOUT
from test_torch_stage1 import _port_trace
from test_zk_prove import FIB, L

pytestmark = pytest.mark.slow

DORY_VARS = 13
# case -> (guest, layout, min_padded, Dory setup?, prove flags)
CASES = {
    "fib-zk": (FIB, L, 32, False, {"zk": True}),
    "image": (IMAGE_GUEST, L, 32, False, {"committed_image": True}),
    "dory-zk": (DORY_GUEST, DORY_LAYOUT, 32, True, {"zk": True}),
    "dory-image": (IMAGE_GUEST, L, 32, True, {"committed_image": True}),
}
# checkpoints the JAX package's tape takes and the port's does not: before
# the transcript exists, and at setup=None the two Dory stages' marks
JAX_ONLY = {"witness-extraction"}
JAX_ONLY_NO_SETUP = {"stage0-commit", "stage8-openings"}


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request, tmp_path_factory, monkeypatch_module):
    """The case's port proof, the JAX package's proof and FS tape, the
    statement, the port's trace and setup."""
    guest, layout, min_padded, dory, flags = CASES[request.param]
    jax_tr = trace_program(guest, layout=JaxLayout(
        **dataclasses.asdict(layout)), min_padded=min_padded)
    tmp = tmp_path_factory.mktemp(request.param)
    jax_setup = port_setup = None
    if dory:
        jax_setup = JDorySetup.generate(DORY_VARS,
                                        cache_dir=str(tmp / "jax_srs"))
        port_setup = DorySetup.generate(DORY_VARS,
                                        cache_dir=str(tmp / "port_srs"))
    tape = tmp / "tape.json"
    monkeypatch_module.setenv("JOLT_TPU_FS_TRACE", str(tape))
    jax_kw = dict(flags, zk_rng=random.Random(42)) if "zk" in flags else flags
    jax_proof = j_prove(jax_tr, setup=jax_setup, **jax_kw)
    monkeypatch_module.delenv("JOLT_TPU_FS_TRACE")
    port_kw = dict(flags, zk_rng=random.Random(42)) if "zk" in flags else flags
    port_tr = _port_trace(jax_tr)
    port_proof = jt.prove(port_tr, setup=port_setup, device="cpu", **port_kw)
    statement = {"outputs": bytes(jax_tr.device.outputs)}
    skip = JAX_ONLY | (set() if dory else JAX_ONLY_NO_SETUP)
    jax_tape = [e for e in json.loads(tape.read_text())
                if e["stage"] not in skip]
    return (request.param, port_proof, jax_proof, jax_tape, statement,
            port_tr, port_setup)


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_proof_bytes_match_jax(both):
    case, port_proof, jax_proof, _, statement, _, _ = both
    if "zk" in case:
        assert port_proof.zk_commitments and port_proof.zk_blindfold
    else:
        assert port_proof.program_image_claim is not None
    assert (proof_io.serialize_proof(port_proof, statement)
            == jproof_io.serialize_proof(jax_proof, statement))


def test_fs_tape_matches_jax(both):
    case, port_proof, _, jax_tape, _, _, _ = both
    assert port_proof.fs_tape == jax_tape
    if "zk" in case:
        assert port_proof.fs_tape[-1]["stage"] == "blindfold"


def test_port_verifies(both):
    _, port_proof, _, _, _, port_tr, port_setup = both
    assert jt.verify(port_proof, jt.PublicIO.from_trace(port_tr),
                     setup=port_setup)
