"""The port's span profiler (`utils/profiling.py`) and `prove`'s stage
spans, on the CPU: tests/test_profiling.py's cases (nesting and timing, a
disabled profiler, the report, JSON and dump, JOLT_TPU_PROFILE at import),
`Profiler.stage`'s retroactive spans, and on that module's tiny guest the
port's `prove` emitting the JAX package's stage labels as its root spans
in `prove`'s order (read from the JAX package's `_mark` calls), the spans
covering `prove`'s wall time, and the JOLT_TPU_FS_TRACE file: the proof's
FS tape with the JAX package's `witness-extraction`, `stage0-commit` and
`stage8-openings` entries.  The CLI's `--profile` file and the tape file
against the JAX package's are in tests/test_torch_entry_points.py.
"""

import ast
import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from jolt_tpu_torch import prove
from jolt_tpu_torch.riscv.emulator import MemoryLayout
from jolt_tpu_torch.tracer import trace_program
from jolt_tpu_torch.utils import profiling
from jolt_tpu_torch.utils.profiling import Profiler

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def jax_stage_labels(zk: bool = False):
    """The stage labels the JAX package's `prove` marks, in order: its
    `_mark("...")` calls (`jolt_tpu/prover/prover.py`); "blindfold" only
    with zk."""
    tree = ast.parse((ROOT / "jolt_tpu" / "prover" / "prover.py").read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "_mark"]
    labels = [c.args[0].value for c in sorted(
        calls, key=lambda c: (c.lineno, c.col_offset))]
    return [x for x in labels if zk or x != "blindfold"]


def test_jax_stage_labels_are_the_pipelines():
    assert jax_stage_labels() == [
        "witness-extraction", "stage0-commit", "stage1-spartan",
        "stage1s-shift", "stage2-reg-rw", "stage3-reg-val", "stage4-5-ram",
        "stage5i-instr-lookups", "stage6-bytecode", "stage6v-ra-virtual",
        "stage7-booleanity", "stage8-reduction", "stage8-openings"]


def test_spans_nest_and_time():
    prof = Profiler(track_memory=False)
    with prof.span("outer"):
        with prof.span("inner"):
            time.sleep(0.01)
        with prof.span("inner"):
            time.sleep(0.01)
    assert len(prof.roots) == 1
    outer = prof.roots[0]
    assert [c.name for c in outer.children] == ["inner", "inner"]
    assert outer.wall_s >= 0.02
    assert prof.total("inner") >= 0.02
    assert "outer" in prof.report()
    tree = json.loads(prof.to_json())
    assert tree[0]["name"] == "outer"
    assert len(tree[0]["children"]) == 2


def test_disabled_profiler_is_noop():
    prof = Profiler(enabled=False)
    with prof.span("x"):
        pass
    prof.stage("y", 0.0, 1.0)
    assert prof.roots == [] and prof.report() == ""


def test_report_json_and_dump_round_trip(tmp_path):
    prof = Profiler(track_memory=False)
    with prof.span("a"):
        with prof.span("b"):
            pass
    prof.roots[0].hbm_enter, prof.roots[0].hbm_exit = 2 << 20, 5 << 20
    assert prof.report().splitlines()[0].endswith("hbm=5MB (+3)")
    assert prof.report().splitlines()[1].startswith("  b: ")
    path = tmp_path / "p.json"
    prof.dump(str(path))
    tree = json.loads(path.read_text())
    assert tree == json.loads(prof.to_json()) == [r.as_dict(prof.anchor)
                                                  for r in prof.roots]
    assert tree[0]["hbm_bytes"] == 5 << 20
    b = prof.roots[0].children[0]
    assert tree[0]["children"] == [{
        "name": "b", "start_ns": prof.anchor.unix_ns(round(b.start * 1e9)),
        "wall_s": round(b.wall_s, 4)}]
    assert "start_ns" not in prof.roots[0].as_dict()


def test_stage_spans_adopt_the_spans_opened_in_the_stage():
    prof = Profiler(track_memory=False)
    t0 = time.perf_counter()
    with prof.span("before"):
        pass
    t1 = time.perf_counter()
    with prof.span("in.stage"):
        pass
    with prof.span("in.stage"):
        pass
    t2 = time.perf_counter()
    prof.stage("stage-a", t1, t2)
    prof.stage("stage-b", t2, t2 + 0.5)
    assert [r.name for r in prof.roots] == ["before", "stage-a", "stage-b"]
    assert [c.name for c in prof.roots[1].children] == ["in.stage"] * 2
    assert prof.roots[2].children == [] and prof.roots[2].wall_s == 0.5
    assert prof.total("in.stage") > 0 and t0 <= prof.roots[0].start


_ENV_SWITCH = """
import importlib, os
from jolt_tpu_torch.utils import profiling
on = profiling.PROFILER.enabled and profiling.active() is profiling.PROFILER
del os.environ["JOLT_TPU_PROFILE"]
importlib.reload(profiling)
off = profiling.active().enabled
prof = profiling.enable()
print(on, off, prof.enabled, profiling.active() is prof is profiling.enable())
"""


def test_env_switch_enables_at_import():
    res = subprocess.run([sys.executable, "-c", _ENV_SWITCH], cwd=ROOT,
                         env={**__import__("os").environ,
                              "JOLT_TPU_PROFILE": "1"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["True", "False", "True", "True"]


@pytest.fixture(scope="module")
def profiled_prove(tmp_path_factory):
    """tests/test_profiling.py's guest proved on the CPU with a profiler
    installed and JOLT_TPU_FS_TRACE set."""
    L = MemoryLayout(max_input_size=64, max_output_size=64)
    tr = trace_program(f"""
        li   a1, 2
        li   a2, 3
        add  a3, a1, a2
        li   t0, {L.output_start}
        sd   a3, 0(t0)
        li   t1, {L.termination}
        li   t2, 1
        sd   t2, 0(t1)
    """, layout=L, min_padded=16)
    tape = tmp_path_factory.mktemp("fs") / "tape.json"
    prof = Profiler()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "PROFILER", prof)
        mp.setenv("JOLT_TPU_FS_TRACE", str(tape))
        t0 = time.perf_counter()
        proof = prove(tr, device="cpu")
        wall = time.perf_counter() - t0
    return proof, prof, wall, json.loads(tape.read_text())


def test_prove_emits_the_jax_stage_spans(profiled_prove):
    proof, prof, wall, _ = profiled_prove
    assert [s.name for s in prof.roots] == jax_stage_labels()
    assert all(s.wall_s >= 0 and s.hbm_exit is None for s in prof.roots)
    covered = sum(s.wall_s for s in prof.roots)
    assert covered <= wall and wall - covered < 0.25 * wall
    assert prof.total("stage1-spartan") > 0
    # the spans' starts follow on from each other
    for a, b in zip(prof.roots, prof.roots[1:]):
        assert b.start == pytest.approx(a.start + a.wall_s, abs=1e-9)


def test_fs_trace_file_is_the_tape_with_the_jax_entries(profiled_prove):
    proof, _, _, tape = profiled_prove
    assert [e["stage"] for e in tape] == jax_stage_labels()
    assert tape[0] == {"stage": "witness-extraction"}
    listed = {e["stage"] for e in proof.fs_tape}
    assert [e for e in tape if e["stage"] in listed] == proof.fs_tape
    # at setup=None stage 0 commits nothing and the opening absorbs nothing
    by = {e["stage"]: e for e in tape}
    assert by["stage0-commit"]["n_rounds"] < by["stage1-spartan"]["n_rounds"]
    assert ({k: v for k, v in by["stage8-openings"].items() if k != "stage"}
            == {k: v for k, v in by["stage8-reduction"].items()
                if k != "stage"})


# ---- counters, the clock anchor, and the spans inside each stage ---------

# each batched stage's root and its proof fields of round polynomials (one
# `stage.setup` a batched sumcheck: stage 4-5 has two)
BATCHED = {"stage1-spartan": ["stage1_polys"],
           "stage1s-shift": ["shift_polys"],
           "stage2-reg-rw": ["stage2_polys"],
           "stage3-reg-val": ["stage3_polys"],
           "stage4-5-ram": ["stage4_polys", "stage5_polys"],
           "stage5i-instr-lookups": ["stage5i_polys"],
           "stage6-bytecode": ["stage6_polys"],
           "stage6v-ra-virtual": ["stage6v_polys"],
           "stage7-booleanity": ["stage7_polys"],
           "stage8-reduction": ["stage8_polys"]}


def test_counts_add_to_the_innermost_span_or_the_next_stage():
    prof = Profiler(track_memory=False)
    prof.count("d2h")                       # no span open: waits
    t0 = time.perf_counter()
    with prof.span("a"):
        prof.count("d2h", 2)
        with prof.span("b"):
            prof.count("h2d_bytes", 96)
    prof.count("d2h", 4)
    prof.stage("stage-a", t0, time.perf_counter())
    stage = prof.roots[0]
    assert stage.counts == {"d2h": 5} and stage.children[0].counts == {
        "d2h": 2}
    assert stage.children[0].children[0].counts == {"h2d_bytes": 96}
    assert prof.tally("d2h") == 7 and prof.tally("d2h", within="a") == 2
    assert "d2h=5" in prof.report().splitlines()[0]
    tree = json.loads(prof.to_json())
    assert tree[0]["counts"] == {"d2h": 5}
    assert tree[0]["children"][0]["children"][0]["counts"] == {
        "h2d_bytes": 96}


def test_null_profiler_records_nothing():
    prof = Profiler(enabled=False)
    prof.count("d2h")
    with prof.span("x"):
        prof.count("d2h", 3)
    assert prof.stage("y", 0.0, 1.0) is None
    assert prof.roots == [] and prof.proves == [] and prof._loose == {}
    assert prof.tally("d2h") == 0 and json.loads(prof.to_json()) == []
    # the process-wide null object, whatever ran under it in this process
    assert not profiling._NULL.roots and not profiling._NULL.proves
    assert not profiling._NULL._loose


def test_recording_restores_the_profiler_before_it():
    before = profiling.active()
    with profiling.recording() as prof:
        assert profiling.active() is prof and prof.enabled
        prof.count("d2h")
    assert profiling.active() is before


def test_start_ns_follows_the_anchor(profiled_prove):
    _, prof, _, _ = profiled_prove
    a = prof.anchor
    assert abs((a.time_ns - time.time_ns())
               - (a.perf_ns - time.perf_counter_ns())) < 50_000_000
    tree = json.loads(prof.to_json())

    def pairs(spans, dicts):
        for s, d in zip(spans, dicts):
            yield s, d
            yield from pairs(s.children, d.get("children", []))
    seen = list(pairs(prof.roots, tree))
    assert len(seen) == sum(1 for r in prof.roots for _ in r.walk())
    for s, d in seen:
        assert d["start_ns"] == a.time_ns + round(s.start * 1e9) - a.perf_ns
    assert a.time_ns <= tree[0]["start_ns"] <= time.time_ns()


def test_proves_keep_each_calls_stage_spans(profiled_prove):
    _, prof, _, _ = profiled_prove
    assert len(prof.proves) == 1 and prof.proves[0] == prof.roots
    assert prof.proves[0] is not prof.roots


def test_witness_steps_cover_its_wall_time(profiled_prove):
    _, prof, _, _ = profiled_prove
    w = prof.roots[0]
    assert [c.name for c in w.children] == [
        "witness.r1cs_inputs", "witness.registers", "witness.ram",
        "witness.bytecode", "witness.lookups", "witness.chunks",
        "witness.advice"]
    assert sum(c.wall_s for c in w.children) >= 0.95 * w.wall_s


def test_every_batched_stage_has_its_setup_then_rounds(profiled_prove):
    proof, prof, _, _ = profiled_prove
    by = {r.name: r for r in prof.roots}
    for label, fields in BATCHED.items():
        ran = [f for f in fields if getattr(proof, f)]
        names = [c.name for c in by[label].children]
        # on the CPU every stage takes the host engine
        assert names == ["stage.setup", "engine.rounds",
                         "stage.openings"] * len(ran), (label, names)
        kids = by[label].children
        assert sum(c.wall_s for c in kids) >= 0.9 * by[label].wall_s or \
            by[label].wall_s < 0.01, label
    assert [c.name for c in by["stage1-spartan"].children[0].children] == [
        "s1.uniskip"]
    assert [c.name for c in by["stage0-commit"].children] == []


def test_s5i_parts(profiled_prove):
    proof, prof, _, _ = profiled_prove
    s5i = next(r for r in prof.roots if r.name == "stage5i-instr-lookups")
    setup, rounds, _ = s5i.children
    log_t = len(proof.stage5i_polys) - 128
    parts = [c.name for c in rounds.children]
    # a message and a bind span a round; 16 phase tables, the first in
    # the set-up, the last rebuild the cycle rounds' stack
    assert parts.count("s5i.address") == 2 * 128
    assert parts.count("s5i.cycle") == 2 * log_t
    assert parts.count("s5i.rebuild") == 16
    assert [c.name for c in setup.children] == ["s5i.rebuild"]


def test_copies_are_counted_in_the_tree(profiled_prove):
    proof, prof, _, _ = profiled_prove
    by = {r.name: r for r in prof.roots}
    # the host engine fetches each round's messages once
    for label in ("stage2-reg-rw", "stage3-reg-val", "stage6-bytecode"):
        rounds = by[label].children[1]
        n = len(getattr(proof, BATCHED[label][0]))
        assert rounds.counts["d2h"] == n, label
        assert rounds.counts["d2h_bytes"] > 0
    assert prof.tally("d2h") == sum(prof.tally("d2h", roots=[r])
                                    for r in prof.roots)
    assert prof.tally("h2d") > 0 and prof.tally("h2d_bytes") > 0
    tree = json.loads(prof.to_json())

    def total(d, key):
        return d.get("counts", {}).get(key, 0) + sum(
            total(c, key) for c in d.get("children", []))
    for key in ("d2h", "d2h_bytes", "h2d", "h2d_bytes"):
        assert sum(total(d, key) for d in tree) == prof.tally(key)
