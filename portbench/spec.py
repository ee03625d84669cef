"""Finds a cell's files by the names in `BENCHMARK.json`.

Every file is looked up by name and a missing or inconsistent one raises
`SpecError`: the harness never runs a cell it cannot fully resolve.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class SpecError(RuntimeError):
    pass


def _read_json(path: str) -> dict:
    if not os.path.isfile(path):
        raise SpecError(f"missing file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the workload's entry in BENCHMARK.json
    config: dict           # configs/<config>.json
    traffic: dict          # traffic/<traffic>.json
    settings: dict         # cells/<name>.json
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports
    readers: Dict[str, object]  # per-layer metric name -> reader module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(name: str, root: str = ROOT):
    """The per-layer metric reader `metrics/<name>.py`, as a module with
    LAYER, UNIT, MOVES and `read(window)`."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise SpecError(f"no reader for the per-layer metric {name}: "
                        f"missing {os.path.relpath(path, root)}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr in ("LAYER", "UNIT", "MOVES", "read"):
        if not hasattr(mod, attr):
            raise SpecError(f"reader {name} lacks {attr}")
    return mod


def load_cell(name: str, root: str = ROOT,
              bench_file: str = "BENCHMARK.json") -> Cell:
    bench = _read_json(os.path.join(root, bench_file))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SpecError(f"{bench_file} has no workload {name}")
    conf_entry = next((c for c in bench["configs"]
                       if c["name"] == entry["config"]), None)
    if conf_entry is None:
        raise SpecError(f"{bench_file} has no config {entry['config']}")
    config = _read_json(os.path.join(root, conf_entry["file"]))
    traffic = _read_json(os.path.join(root, "portbench", "traffic",
                                      f"{entry['traffic']}.json"))
    settings = _read_json(os.path.join(root, "portbench", "cells",
                                       f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    readers = {}
    for m in layer:
        mod = load_reader(m["name"], root)
        for key, attr in (("layer", "LAYER"), ("unit", "UNIT"),
                          ("moves", "MOVES")):
            if m[key] != getattr(mod, attr):
                raise SpecError(f"metric {m['name']}: {bench_file} says "
                                f"{key} {m[key]!r}, its reader "
                                f"{getattr(mod, attr)!r}")
        readers[m["name"]] = mod
    return Cell(name, entry, config, traffic, settings, e2e, layer, readers)
