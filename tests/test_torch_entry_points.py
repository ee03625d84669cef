"""The port's host entry points against the JAX package's, on the CPU:
`sdk.py`, `cli.py` (through `main(argv)`) and `eval/`'s generator,
calibration and invariants.

The host values (a guest's run and analysis, its preprocessing digest,
`cli run` / `trace` output, fuzz guests, sweep calibration and the
workload table) equal the JAX package's.  One fib proof on the CPU is
shared by the module: `cli prove --device cpu --profile` writes it with
JOLT_TPU_FS_TRACE set, and the port's `cli verify`, the JAX package's
`cli verify` and the SDK's verifier closure accept it; a wrong claimed
output is refused.  Its `.profile.json` holds the JAX package's stage
spans, and its tape file equals the one the JAX package's `cli prove`
writes on the same trace (`FIB_JAX_TAPE`; the slow
tests/test_torch_entry_points_slow.py holds that file to a live run).  `--device cuda`
(the default) raises on a host without a card.  The proofs of the sweep,
fuzz's prove-and-tamper and the JAX package's own proof bytes are in the
slow tests/test_torch_entry_points_slow.py.
"""

import json
import pathlib
import random

import pytest
import torch

from jolt_tpu import cli as jcli
from jolt_tpu import sdk as jsdk
from jolt_tpu.eval import fuzz as jfuzz
from jolt_tpu.eval import sweep as jsweep
from jolt_tpu.riscv.emulator import MemoryLayout as JLayout
from jolt_tpu.tracer import trace_program as j_trace_program

from jolt_tpu_torch import cli, sdk
from jolt_tpu_torch.eval import fuzz, sweep
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.tracer import trace_program
from jolt_tpu_torch.utils import profiling
from test_sdk import FIB as SDK_FIB
from test_torch_profiling import jax_stage_labels

torch.set_num_threads(1)

FIB_S = "examples/fibonacci.s"
FIB_INPUT = "0a00000000000000"
# the FS tape file of `python -m jolt_tpu.cli prove examples/fibonacci.s
# --input 0a00000000000000 --platform cpu` with JOLT_TPU_FS_TRACE set
FIB_JAX_TAPE = pathlib.Path(__file__).parent / "data" / "fib_jax_fs_tape.json"


@pytest.fixture(autouse=True)
def _no_host_settings(monkeypatch):
    """The JAX package's `cli.main` may raise the host's vm.max_map_count
    (an XLA:CPU guard); these tests change no host setting."""
    monkeypatch.setattr("jolt_tpu.utils.env.ensure_map_count", lambda: None)


def _fib_src():
    layout = MemoryLayout(max_input_size=64, max_output_size=64)
    return SDK_FIB.format(out=layout.output_start, term=layout.termination)


def test_guest_host_values_match_jax():
    mine = sdk.provable(_fib_src(), device="cpu")
    theirs = jsdk.provable(_fib_src())
    assert mine.preprocess() == theirs.preprocess()
    assert vars(mine.analyze()) == vars(theirs.analyze())
    assert vars(mine.run()) == vars(theirs.run())
    assert int.from_bytes(mine.run().outputs[:8], "little") == 55


def test_guest_and_cli_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is the default and runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sdk.provable(_fib_src())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["prove", FIB_S, "--input", FIB_INPUT, "-o", "unused"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.run_point("fib", 8, native=False)


@pytest.mark.parametrize("cmd", ["run", "trace"])
def test_cli_host_commands_print_the_jax_packages_lines(cmd, capsys):
    out = {}
    for name, mod in (("torch", cli), ("jax", jcli)):
        assert mod.main([cmd, FIB_S, "--input", FIB_INPUT]) == 0
        lines = capsys.readouterr().out.splitlines()
        # the first line of `run` carries its wall time
        out[name] = lines[1:] if cmd == "run" else lines
    assert out["torch"] == out["jax"]


@pytest.fixture(scope="module")
def fib_proof(tmp_path_factory):
    """The CLI's fib proof on the CPU, with `--profile` (its report and
    `<proof>.profile.json`) and its FS tape file (`<proof>.tape.json`)."""
    path = str(tmp_path_factory.mktemp("cli") / "fib.proof")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "PROFILER", profiling._NULL)   # restored after
        mp.setenv("JOLT_TPU_FS_TRACE", path + ".tape.json")
        assert cli.main(["prove", FIB_S, "--input", FIB_INPUT, "-o", path,
                         "--device", "cpu", "--profile"]) == 0
    return path


def test_cli_profile_holds_the_jax_stage_spans(fib_proof):
    tree = json.loads(open(fib_proof + ".profile.json").read())
    assert [s["name"] for s in tree] == jax_stage_labels()
    assert all(s["wall_s"] >= 0 and "hbm_bytes" not in s for s in tree)
    assert sum(s["wall_s"] for s in tree) > 0


def test_cli_tape_file_equals_the_jax_packages(fib_proof):
    tape = json.loads(open(fib_proof + ".tape.json").read())
    assert tape[0] == {"stage": "witness-extraction"}
    assert [e["stage"] for e in tape] == jax_stage_labels()
    assert tape == json.loads(FIB_JAX_TAPE.read_text())


def test_cli_proof_verifies_in_both_packages(fib_proof, capsys):
    for mod in (cli, jcli):
        assert mod.main(["verify", FIB_S, fib_proof, "--input",
                         FIB_INPUT]) == 0
        out = capsys.readouterr().out
        assert ": True" in out and "claimed outputs: 3700000000000000" in out
    # another input is another statement: refused
    assert cli.main(["verify", FIB_S, fib_proof, "--input",
                     "0b00000000000000"]) == 1
    assert "REJECTED" in capsys.readouterr().out


def test_sdk_verifier_closure_accepts_the_cli_proof(fib_proof):
    from jolt_tpu_torch.proof_io import deserialize_proof
    guest = sdk.provable(FIB_S, device="cpu")
    proof, st = deserialize_proof(open(fib_proof, "rb").read())
    verify_fib = guest.build_verifier()
    inputs = bytes.fromhex(FIB_INPUT)
    assert verify_fib(inputs, st["outputs"], st["panic"], proof)
    bad = bytearray(st["outputs"])
    bad[0] ^= 1
    assert not verify_fib(inputs, bytes(bad), st["panic"], proof)


@pytest.mark.parametrize("seed", [0, 7])
def test_fuzz_guests_and_invariants_match_jax(seed):
    layout = MemoryLayout(max_input_size=64, max_output_size=64)
    jlayout = JLayout(max_input_size=64, max_output_size=64)
    src = fuzz.gen_program(random.Random(seed), 50, layout)
    assert src == jfuzz.gen_program(random.Random(seed), 50, jlayout)
    tr = trace_program(src, layout=layout, min_padded=16)
    jtr = j_trace_program(src, layout=jlayout, min_padded=16)
    assert fuzz.check_invariants(tr) == jfuzz.check_invariants(jtr) == []
    fuzz.run_differential(seed, n_instr=60)
    fuzz.run_fuzz_case(seed, prove_roundtrip=False)


def test_sweep_calibration_and_workloads_match_jax():
    assert ({k: v[1:] for k, v in sweep.WORKLOADS.items()}
            == {k: v[1:] for k, v in jsweep.WORKLOADS.items()})
    n, layout = sweep.calibrate("fib", 11, native=False)
    assert n == jsweep.calibrate("fib", 11, native=False)[0]
    tr = sweep._trace(sweep._fib_src, n, layout, native=False)
    assert (1 << 10) <= tr.length <= (1 << 12)
