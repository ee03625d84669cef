"""Span-based profiling: nested wall-clock spans + device-memory watermarks.

Copied from the JAX package's `utils/profiling.py` (the analog of the
reference's span machinery, `crates/jolt-profiling/src/lib.rs`: spans,
their export, the `--profile` CLI path), imports rewritten.  Design notes
kept from there:

  * CUDA launches are asynchronous -- a span around a launch measures
    enqueue time unless the caller waits for the result.  Spans therefore
    record wall time as observed by the HOST (which is what the prover's
    throughput is made of: each stage's fetch is the synchronization
    point), plus the card's live allocated bytes
    (`torch.cuda.memory_allocated`) once the process has used the card.
  * No global subscriber: an explicit `Profiler` object threads through
    (or the module-level `PROFILER`, enabled by JOLT_TPU_PROFILE=1 at
    import or by `enable()`), so nothing is paid when disabled.

`prove` (`prover/prover.py`) adds one retroactive span per stage at the
stage's end (`Profiler.stage`), after the stage's fetch, with the spans
opened during the stage (Dory's, the device tier's) as its children.

Output: a tree of spans with {name, wall_s, hbm_bytes?} -- `report()`
renders an indented text profile, `to_json()` a machine-readable dump
(the CLI writes it next to the proof with --profile).
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Optional


def _device_mem_bytes() -> Optional[int]:
    """Live allocated bytes on the current CUDA device
    (`torch.cuda.memory_allocated`, the caching allocator's count: no
    sync) once the process has used the card; None otherwise (a CPU run
    reports nothing)."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return int(torch.cuda.memory_allocated()) or None
    return None


@dataclass
class Span:
    name: str
    start: float
    wall_s: float = 0.0
    hbm_enter: Optional[int] = None
    hbm_exit: Optional[int] = None
    children: List["Span"] = field(default_factory=list)

    def as_dict(self) -> dict:
        d = {"name": self.name, "wall_s": round(self.wall_s, 4)}
        if self.hbm_exit is not None:
            d["hbm_bytes"] = self.hbm_exit
        if self.children:
            d["children"] = [c.as_dict() for c in self.children]
        return d


class Profiler:
    """Nested span recorder.  Usage:

        prof = Profiler(enabled=True)
        with prof.span("stage1"):
            with prof.span("message"):
                ...
        print(prof.report())
    """

    def __init__(self, enabled: bool = True, track_memory: bool = True):
        self.enabled = enabled
        self.track_memory = track_memory
        self.roots: List[Span] = []
        self._stack: List[Span] = []

    @contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        s = Span(name, time.perf_counter())
        if self.track_memory:
            s.hbm_enter = _device_mem_bytes()
        (self._stack[-1].children if self._stack else self.roots).append(s)
        self._stack.append(s)
        try:
            yield s
        finally:
            self._stack.pop()
            s.wall_s = time.perf_counter() - s.start
            if self.track_memory:
                s.hbm_exit = _device_mem_bytes()

    def stage(self, name: str, start: float, end: float) -> None:
        """A retroactive span from `start` to `end` (`time.perf_counter`)
        at the current level (`prove` is a linear pipeline: one per
        stage, as the JAX package's prover adds them), with the spans
        opened at that level since `start` as its children."""
        if not self.enabled:
            return
        level = self._stack[-1].children if self._stack else self.roots
        k = len(level)
        while k and level[k - 1].start >= start:
            k -= 1
        s = Span(name, start, end - start, children=level[k:])
        if self.track_memory:
            s.hbm_exit = _device_mem_bytes()
        del level[k:]
        level.append(s)

    # ---- reporting -------------------------------------------------------

    def report(self) -> str:
        lines: List[str] = []

        def walk(s: Span, depth: int):
            mem = ""
            if s.hbm_exit is not None:
                mem = f"  hbm={s.hbm_exit / 2**20:.0f}MB"
                if s.hbm_enter is not None:
                    mem += f" (+{(s.hbm_exit - s.hbm_enter) / 2**20:.0f})"
            lines.append(f"{'  ' * depth}{s.name}: {s.wall_s:.3f}s{mem}")
            for c in s.children:
                walk(c, depth + 1)

        for r in self.roots:
            walk(r, 0)
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps([r.as_dict() for r in self.roots], indent=1)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def total(self, name: str) -> float:
        """Sum of wall_s over all spans with this name (any depth)."""
        acc = 0.0

        def walk(s: Span):
            nonlocal acc
            if s.name == name:
                acc += s.wall_s
            for c in s.children:
                walk(c)

        for r in self.roots:
            walk(r)
        return acc


_NULL = Profiler(enabled=False)
PROFILER: Profiler = (Profiler() if os.environ.get("JOLT_TPU_PROFILE")
                      else _NULL)


def active() -> Profiler:
    """The process-wide profiler (null object when disabled)."""
    return PROFILER


def enable() -> Profiler:
    """Turn on the process-wide profiler (used by the CLI's --profile)."""
    global PROFILER
    if not PROFILER.enabled:
        PROFILER = Profiler()
    return PROFILER
