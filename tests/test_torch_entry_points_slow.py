"""The port's host entry points against the JAX package's, with proofs
(slow tier, as the JAX package's own tests/test_sweep.py and
tests/test_fuzz.py are slow modules there).

  * `eval.sweep.run_sweep` on the CPU: fib at 2^9 and 2^10, the run
    directory's records and summary;
  * `eval.fuzz.run_fuzz_case` on the CPU: a random guest's proof verifies
    and a tampered copy is refused;
  * `cli prove --profile` on the CPU writes the JAX package's `cli prove`
    file, byte for byte, the same root spans in its `.profile.json`, and
    with JOLT_TPU_FS_TRACE the same tape file, which is also the file
    tests/test_torch_entry_points.py holds the port's to (the JAX prove of
    fib takes minutes with a cold compile cache).
"""

import json
import os

import pytest
import torch

from jolt_tpu import cli as jcli
from jolt_tpu.utils import profiling as jprofiling

from jolt_tpu_torch import cli
from jolt_tpu_torch.eval import fuzz, sweep
from jolt_tpu_torch.utils import profiling
from test_torch_entry_points import FIB_JAX_TAPE

pytestmark = pytest.mark.slow

torch.set_num_threads(1)


def test_sweep_artifacts_on_the_cpu(tmp_path):
    summary = sweep.run_sweep(["fib"], 9, 10, pcs=None, out_dir=str(tmp_path),
                              native=False, device="cpu")
    assert summary["points"] == 2 and summary["best_khz"] > 0
    lines = open(os.path.join(summary["run_dir"],
                              "sweep.jsonl")).read().splitlines()
    rec = json.loads(lines[0])
    assert rec["workload"] == "fib" and rec["target_log2"] == 9
    assert rec["cycles"] > 0 and rec["prove_s"] > 0
    assert rec["proof_bytes"] and rec["proof_bytes"] > 1000
    assert rec["hbm_bytes"] is None              # no card: nothing reported
    s = json.load(open(os.path.join(summary["run_dir"], "summary.json")))
    assert s["summary"]["points"] == 2


def test_fuzz_prove_verify_with_tamper_on_the_cpu():
    fuzz.run_fuzz_case(11, n_instr=25, tamper=True, device="cpu")


def test_cli_proof_file_equals_the_jax_packages(tmp_path, monkeypatch):
    # the JAX package's `cli.main` may raise the host's vm.max_map_count
    # (an XLA:CPU guard); this test changes no host setting
    monkeypatch.setattr("jolt_tpu.utils.env.ensure_map_count", lambda: None)
    monkeypatch.setattr(profiling, "PROFILER", profiling._NULL)
    monkeypatch.setattr(jprofiling, "PROFILER", jprofiling._NULL)
    args = ["prove", "examples/fibonacci.s", "--input", "0a00000000000000",
            "--profile", "-o"]
    monkeypatch.setenv("JOLT_TPU_FS_TRACE", str(tmp_path / "port.tape"))
    assert cli.main(args + [str(tmp_path / "port.proof"), "--device",
                            "cpu"]) == 0
    monkeypatch.setenv("JOLT_TPU_FS_TRACE", str(tmp_path / "jax.tape"))
    assert jcli.main(args + [str(tmp_path / "jax.proof"), "--platform",
                             "cpu"]) == 0
    assert ((tmp_path / "port.proof").read_bytes()
            == (tmp_path / "jax.proof").read_bytes())
    tapes = [json.loads((tmp_path / f"{n}.tape").read_text())
             for n in ("port", "jax")]
    assert tapes[0] == tapes[1] == json.loads(FIB_JAX_TAPE.read_text())
    roots = [[s["name"] for s in json.loads(
        (tmp_path / f"{n}.proof.profile.json").read_text())]
        for n in ("port", "jax")]
    assert roots[0] == roots[1]
