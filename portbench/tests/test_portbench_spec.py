"""Every file a cell of BENCHMARK.json names is found by name, and a cell
that names a missing file fails loudly."""

import json
import os
import re
import shutil

import pytest

from portbench import spec

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["padded_log2"] == c.config["trace_log2"]
    assert {m["name"] for m in c.per_layer} == set(c.readers)
    assert any(m["name"] == "setup_s" for m in c.end_to_end)


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def _copy_root(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    return root


@pytest.mark.parametrize("what", ["traffic", "config", "cell", "reader"])
def test_missing_file_fails_loudly(tmp_path, what):
    root = _copy_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]
    if what == "traffic":
        cell["traffic"] = "no-such-mix"
    elif what == "config":
        bench["configs"][0]["file"] = "portbench/configs/no-such.json"
    elif what == "cell":
        os.remove(root / "portbench" / "cells" / f"{cell['name']}.json")
    else:
        bench["per_layer"].append({**bench["per_layer"][0],
                                   "name": "no_such_metric"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError, match="missing|no reader"):
        spec.load_cell(cell["name"], root=str(root))


def test_reader_must_match_its_entry(tmp_path):
    root = _copy_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"][0]["moves"] = "setup_s"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError, match="moves"):
        spec.load_cell(bench["workloads"][0]["name"], root=str(root))
