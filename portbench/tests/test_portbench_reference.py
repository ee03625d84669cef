"""The reference accepts a small CPU proof and rejects a tampered
one; the control (the proof at half precision) comes out not correct; and
a whole run with the timed path broken underneath comes out not correct
for each fault a cell can have.  CPU only, at a small size (`_small.py`):
the card's runs are `control.py`'s."""

import dataclasses
import os

import pytest

from portbench.tests._small import SHA2_TRAFFIC, TRAFFIC, run_small, small_cell
from portbench import traffic as traffic_gen
from portbench.reference import check
from portbench.reference.jolt.proof_io import (deserialize_proof,
                                               serialize_proof)
from portbench.reference.lower_precision import lower_precision


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    """One fib proof of the port on the CPU, with its job and cache."""
    import jolt_tpu_torch
    from jolt_tpu_torch.pcs.dory import DorySetup
    from jolt_tpu_torch.proof_io import serialize_proof as port_serialize
    from jolt_tpu_torch.riscv.emulator import MemoryLayout
    from jolt_tpu_torch.tracer.native import trace_program_native
    cache = tmp_path_factory.mktemp("cache")
    g = traffic_gen.guest_runs(TRAFFIC, 3, MemoryLayout)[0]
    tr = trace_program_native(g.source, layout=MemoryLayout(64, 64),
                              inputs=g.inputs)
    setup = DorySetup.generate(16, nu=4, cache_dir=str(cache / "srs"))
    proof = jolt_tpu_torch.prove(tr, setup=setup, device="cpu")
    job = check.Job(0, 0, g.inputs, tr.length, tr.padded_length,
                    bytes(tr.device.outputs), bool(tr.device.panic),
                    port_serialize(proof))
    return job, str(cache / "reference")


@pytest.fixture(scope="module")
def sound_zk(sound):
    """The same fib input proved with zk=True, under the same setup."""
    import random

    import jolt_tpu_torch
    from jolt_tpu_torch.pcs.dory import DorySetup
    from jolt_tpu_torch.proof_io import serialize_proof as port_serialize
    from jolt_tpu_torch.riscv.emulator import MemoryLayout
    from jolt_tpu_torch.tracer.native import trace_program_native
    job, cache = sound
    tr = trace_program_native(traffic_gen.guest_source(TRAFFIC,
                                                       MemoryLayout(64, 64)),
                              layout=MemoryLayout(64, 64), inputs=job.inputs)
    srs = os.path.join(os.path.dirname(cache), "srs")
    setup = DorySetup.generate(16, nu=4, cache_dir=srs)
    proof = jolt_tpu_torch.prove(tr, setup=setup, device="cpu", zk=True,
                                 zk_rng=random.Random(1))
    return dataclasses.replace(job, proof=port_serialize(proof)), cache


def _judge(job, cache, traffic=TRAFFIC, zk=False):
    return check.judge(small_cell(zk=zk).config, traffic, [job],
                       [(job.inputs, job.claimed_outputs)], cache)


def _alter(proof_bytes, fn):
    proof, statement = deserialize_proof(proof_bytes)
    fn(proof)
    return serialize_proof(proof, statement)


def test_reference_accepts_the_sound_proof(sound):
    v = _judge(*sound)
    assert v.correct, v
    assert [n[1] for n in v.numbers] == [0, 0, 0]


@pytest.mark.parametrize("where", ["stage2_polys", "stage5i_openings",
                                   "stage8_openings", "joint_opening",
                                   "commitment"])
def test_reference_rejects_a_tampered_proof(sound, where):
    job, cache = sound

    def tamper(p):
        if where == "stage2_polys":
            p.stage2_polys[3][1] += 1
        elif where == "stage5i_openings":
            key = next(iter(p.stage5i_openings))
            p.stage5i_openings[key] += 1
        elif where == "stage8_openings":
            p.stage8_openings[-1] += 1
        elif where == "joint_opening":
            p.opening_proofs["joint"].b_final_s += 1
        else:
            a, b = list(p.commitments)[:2]
            p.commitments[a], p.commitments[b] = (p.commitments[b],
                                                  p.commitments[a])
    bad = dataclasses.replace(job, proof=_alter(job.proof, tamper))
    v = _judge(bad, cache)
    assert not v.correct and v.numbers[2][1] == 1, v


def test_reference_accepts_the_sound_zk_proof(sound_zk):
    v = _judge(*sound_zk, zk=True)
    assert v.correct, v


@pytest.mark.parametrize("stated", ["zk", "clear"])
def test_reference_holds_the_proof_to_the_stated_mode(sound, sound_zk,
                                                      stated):
    """A clear proof where the configuration states zk, and the reverse,
    read `proofs_rejected` 1: the copy's verifier takes its mode from the
    proof, so the check holds it to the configuration's."""
    job, cache = sound if stated == "zk" else sound_zk
    v = _judge(job, cache, zk=stated == "zk")
    assert not v.correct and v.numbers[2][1] == 1, v
    assert v.rejected_at[0].startswith("mode:"), v


def test_dory_verify_in_worker_processes(sound, monkeypatch):
    """The Dory verifier's group work gives the same verdicts in worker
    processes as in this one."""
    job, cache = sound
    bad = dataclasses.replace(job, proof=_alter(
        job.proof, lambda p: p.opening_proofs["joint"].a_d1r.reverse()))
    for workers in (1, 3):
        monkeypatch.setattr(check, "WORKERS", workers)
        assert _judge(job, cache).correct
        v = _judge(bad, cache)
        assert not v.correct and v.rejected_at[0].startswith("dory-open"), v


def test_control_is_not_correct(sound):
    job, cache = sound
    v = _judge(dataclasses.replace(job, proof=lower_precision(job.proof)),
               cache)
    assert not v.correct and v.numbers[2][1] == 1, v


def test_wrong_statement_is_not_correct(sound):
    job, cache = sound
    out = bytearray(job.claimed_outputs)
    out[0] ^= 1
    v = _judge(dataclasses.replace(job, claimed_outputs=bytes(out)), cache)
    assert not v.correct and v.numbers[1][1] == 1, v


def test_second_witness_catches_a_wrong_output(sound):
    job, cache = sound
    claimed = [(bytes(32), bytes(32))]       # hashlib's chain differs
    v = check.judge(small_cell().config, SHA2_TRAFFIC, [], claimed, cache)
    assert not v.correct and v.numbers[0][1] == 1, v


# ---- a whole run, with the timed path broken underneath -----------------

def _fault(kind):
    import jolt_tpu_torch
    state = {}

    def prove(trace, **kw):
        proof = jolt_tpu_torch.prove(trace, **kw)
        if kind == "answer altered":         # a round's message, where made
            proof.stage3_polys[0][0] = (proof.stage3_polys[0][0] + 1)
        elif kind == "state unchanged":      # the first proof, every time
            proof = state.setdefault("first", proof)
        elif kind == "half the work":        # the joint opening left out
            proof.opening_proofs = {}
        return proof
    return prove


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_sound_run_is_correct(tmp_path, zk):
    out = run_small(tmp_path, zk=zk, per_layer=True)
    assert out["correct"] and out["failed"] == 0, out
    assert out["metrics"]["sumcheck_s"]["value"] > 0
    assert ("blindfold_s" in out["metrics"]) == zk


@pytest.mark.parametrize("kind", ["answer altered", "state unchanged",
                                  "half the work"])
def test_broken_run_is_not_correct(tmp_path, kind):
    out = run_small(tmp_path, prove_fn=_fault(kind))
    assert not out["correct"], out


def test_control_readings_small(tmp_path):
    """`control.py`'s readings at the small size: the sound proofs read 0
    in every number, the control and each planted fault fail one."""
    from portbench import control
    out = control.readings(small_cell(), [1, 2], device="cpu",
                           cache_dir=str(tmp_path.parent / "pb-cache"))
    for r in out["readings"]:
        bad = sum(r["numbers"].values())
        assert (bad == 0) == (r["kind"] == "sound"), r
    assert {r["kind"] for r in out["readings"]} == {
        "sound", "control", "token altered", "half the work",
        "state unchanged", "mode flipped"}
