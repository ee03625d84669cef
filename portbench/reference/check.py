"""The reference's judgement of a run's proofs.

It takes only what the benchmark made: the traffic file (the guest's
template, its parameters, the layout), each checked proof's input bytes,
the seed's sample, the configuration's setup labels and sizes, and the
program's outputs to judge: the proof bytes (the port's `serialize_proof`,
the wire format) and the statement the program's trace claims (length,
padded length, output bytes, panic flag).  Everything else it works out
again with its frozen copy (`reference/jolt`, which imports nothing of the
port):

  1. the guest, run on the copy's Python emulator (`tracer/trace.py`):
     the trace length, padded length, output bytes and panic flag; and,
     where the traffic names one, a second witness of the output (the
     SHA-256 chain by `hashlib`), which must agree with the emulator;
  2. its own Dory setup from the labels (`pcs/dory.py: DorySetup.generate`
     on Python ints), cached in `.cache/reference/`;
  3. the proof held to the configuration's mode (a clear proof where it
     states zk, or a zk proof where it does not, is rejected: the copy's
     verifier takes its mode from the proof), then the copy's verifier
     over the decoded proof against the statement of step 1, stage by
     stage: the commitments absorbed, s1 ... s8 (the clear sumcheck
     rounds and opening claims, or in zk mode the committed rounds'
     challenges), the joint Dory opening of the reduced claims (its group
     work in `WORKERS` forked processes), and in zk mode the BlindFold
     proof of every committed round.

The copy is the port's own verifier, frozen: it is not independent of
the port, and a fault the port's prover shares with it does not show.

Numbers compared, each with its limit (all exact: the limit is 0):
  * `outputs_wrong`: the run's inputs whose claimed output differs from
    the second witness (every input of the run, where the traffic names a
    witness);
  * `statement_wrong`: of the checked proofs, those whose claimed length,
    padded length, output or panic flag differs from the emulator's;
  * `proofs_rejected`: of the checked proofs, those the verifier rejects,
    with the layer it rejected at.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import random
import time
from typing import Callable, List, Optional, Tuple

from .jolt.pcs import dory as dory_pcs
from .jolt.pcs.dory import DorySetup
from .jolt.proof_io import deserialize_proof
from .jolt.proof import required_num_vars
from .jolt.riscv.emulator import MemoryLayout
from .jolt.tracer.trace import trace_program
from .jolt.verifier import verifier as V
from .. import traffic as traffic_gen


@dataclasses.dataclass
class Job:
    """One proof of the window, with what the program claims for it."""
    prove_index: int
    input_index: int
    inputs: bytes
    claimed_length: int
    claimed_padded: int
    claimed_outputs: bytes
    claimed_panic: bool
    proof: bytes


@dataclasses.dataclass
class Verdict:
    correct: bool
    numbers: List[list]       # [name, value, limit]
    rejected_at: List[str]


# worker processes for the Dory verifier's group work (`dory_pcs.parallel`)
WORKERS = min(8, len(os.sched_getaffinity(0)))


def sample(n: int, seed: int, k: int) -> List[int]:
    """Which of the window's n completed proofs are checked: k of them,
    drawn from the seed."""
    return sorted(random.Random(f"portbench/check/{seed}").sample(
        range(n), min(k, n)))


def second_witness(traffic: dict, inputs: bytes) -> Optional[bytes]:
    """The output the traffic's "expect" names, by other means than a
    RISC-V emulator; None where it names none."""
    expect = traffic.get("expect")
    if expect is None:
        return None
    if expect["kind"] == "sha256_chain":
        out = inputs
        for _ in range(int(expect["links"])):
            out = hashlib.sha256(out).digest()
        return out
    raise ValueError(f"unknown witness {expect['kind']!r}")


@contextlib.contextmanager
def _layers(seen: List[str]):
    """Records each layer the verifier enters, in order (the copy's
    verifier is stage-sequential: the last one entered is the one that
    rejected)."""
    stage, make_scheme, bf = V._Run.stage, V.make_scheme, V.blindfold_verify
    uniskip = V.verify_uniskip

    def uniskip_w(*a, **kw):
        seen.append("s1-uniskip")
        return uniskip(*a, **kw)

    def stage_w(self, polys, insts, label):
        seen.append(label)
        return stage(self, polys, insts, label)

    def make_scheme_w(setup, device):
        pcs = make_scheme(setup, device)
        absorb, verify_rlc = pcs.absorb, pcs.verify_rlc

        def absorb_w(*a, **kw):
            if not seen or seen[-1] != "commitments":
                seen.append("commitments")
            return absorb(*a, **kw)

        def verify_rlc_w(*a, **kw):
            seen.append("dory-open")
            return verify_rlc(*a, **kw)
        pcs.absorb, pcs.verify_rlc = absorb_w, verify_rlc_w
        return pcs

    def bf_w(*a, **kw):
        seen.append("blindfold")
        return bf(*a, **kw)
    V._Run.stage, V.make_scheme, V.blindfold_verify = stage_w, make_scheme_w, bf_w
    V.verify_uniskip = uniskip_w
    try:
        yield
    finally:
        V._Run.stage, V.make_scheme, V.blindfold_verify = stage, make_scheme, bf
        V.verify_uniskip = uniskip


def proof_mode(proof) -> str:
    """"zk" where the proof carries committed rounds or a BlindFold proof,
    else "clear"."""
    zk = (bool(getattr(proof, "zk_commitments", None))
          or getattr(proof, "zk_blindfold", None) is not None)
    return "zk" if zk else "clear"


def verify_proof(proof_bytes: bytes, io, setup,
                 zk: bool) -> Tuple[bool, str]:
    """The copy's verifier over the proof bytes, holding the proof to the
    mode the configuration states (`zk`): the copy's verifier takes its
    mode from the proof, so a clear proof in a zk configuration, or the
    reverse, is rejected here first.  Returns (accepted, where and why it
    rejected)."""
    seen = ["decode"]
    try:
        proof, _ = deserialize_proof(proof_bytes)
        seen.append("mode")
        want = "zk" if zk else "clear"
        if proof_mode(proof) != want:
            return False, (f"mode: the configuration states a {want} "
                           f"proof, the proof is {proof_mode(proof)}")
        with _layers(seen):
            ok = V.verify(proof, io, setup=setup)
    except Exception as e:            # any failure to verify is a rejection
        return False, f"{seen[-1]}: {type(e).__name__}: {e}"
    if ok is not True:
        return False, f"{seen[-1]}: verify returned {ok!r}"
    return True, " ".join(seen)


def judge(config: dict, traffic: dict, jobs: List[Job],
          claimed_all: List[Tuple[bytes, bytes]], cache_dir: str,
          log: Callable[[str], None] = print) -> Verdict:
    """Check the run's proofs `jobs` and every input's claimed output in
    `claimed_all` ((input, claimed output) pairs)."""
    outputs_wrong = 0
    for inputs, claimed in claimed_all:
        want = second_witness(traffic, inputs)
        if want is not None and claimed[:len(want)] != want:
            outputs_wrong += 1
    sizes = traffic["memory_layout"]
    layout = MemoryLayout(int(sizes["max_input_size"]),
                          int(sizes["max_output_size"]))
    source = traffic_gen.guest_source(traffic, layout)
    statement_wrong = rejected = 0
    rejected_at, setups = [], {}
    for job in jobs:
        t = time.perf_counter()
        ref = trace_program(source, inputs=job.inputs, layout=layout)
        outputs = bytes(ref.device.outputs)
        want = second_witness(traffic, job.inputs)
        if want is not None and outputs[:len(want)] != want:
            raise RuntimeError("the reference's emulator and its second "
                               "witness disagree: the reference is broken")
        if (job.claimed_length, job.claimed_padded, job.claimed_outputs,
                job.claimed_panic) != (ref.length, ref.padded_length,
                                       outputs, bool(ref.device.panic)):
            statement_wrong += 1
        t_emu = time.perf_counter() - t
        num_vars = required_num_vars(ref.padded_length, 0, 0)
        if num_vars not in setups:
            t = time.perf_counter()
            setups[num_vars] = DorySetup.generate(
                num_vars, nu=min(num_vars // 2, int(config["dory_max_nu"])),
                cache_dir=cache_dir)
            log(f"[check] reference Dory setup 2^{num_vars}: "
                f"{time.perf_counter() - t:.3f} s")
        io = V.PublicIO(ref.length, ref.padded_length, job.inputs, outputs,
                        bool(ref.device.panic), layout, ref.code, ref.entry,
                        ref.program.start)
        t = time.perf_counter()
        with dory_pcs.parallel(WORKERS):
            ok, where = verify_proof(job.proof, io, setups[num_vars],
                                     bool(config["zk"]))
        log(f"[check] prove {job.prove_index} (input {job.input_index}): "
            f"emulated {ref.length} cycles in {t_emu:.3f} s; "
            f"{'accepted' if ok else 'REJECTED at ' + where} in "
            f"{time.perf_counter() - t:.3f} s")
        if not ok:
            rejected += 1
            rejected_at.append(where)
    numbers = [["outputs_wrong", outputs_wrong, 0],
               ["statement_wrong", statement_wrong, 0],
               ["proofs_rejected", rejected, 0]]
    correct = all(value <= limit for _, value, limit in numbers)
    return Verdict(correct, numbers, rejected_at)
