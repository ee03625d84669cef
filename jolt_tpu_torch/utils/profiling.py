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

Counters live in the same tree: `count(name, n)` adds n to the innermost
open span's `counts` (the copies between host and card, `d2h` / `d2h_bytes`
and `h2d` / `h2d_bytes`, counted by `field/ops.py`'s `host` and `upload`);
a count made while no span is open waits for the next retroactive span
at that level (`stage`), which takes it.  The null profiler returns after
one attribute check.

One clock with the device trace: the profiler takes an anchor when it is
made, `time.perf_counter_ns()` beside `time.time_ns()` (the Unix clock
that Kineto stamps device events on).  Spans keep `start` in
`perf_counter` seconds; `as_dict` adds `start_ns` on the Unix clock, and
`unix_ns` maps any `perf_counter_ns` instant (a launch record's enqueue
stamp, `field/kernels.py`) the same way.

Output: a tree of spans with {name, start_ns, wall_s, hbm_bytes?,
counts?} -- `report()` renders an indented text profile, `to_json()` a
machine-readable dump (the CLI writes it next to the proof with
--profile).  `proves` keeps each `prove` call's stage spans, one list a
call, whatever a caller does to `roots` between calls.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional


_NO_SPAN = nullcontext()


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
    counts: Dict[str, int] = field(default_factory=dict)

    def as_dict(self, anchor: Optional["Anchor"] = None) -> dict:
        """The span and its children as plain data; with the profiler's
        `anchor`, each span's start on the Unix clock (`start_ns`)."""
        d = {"name": self.name}
        if anchor is not None:
            d["start_ns"] = anchor.unix_ns(round(self.start * 1e9))
        d["wall_s"] = round(self.wall_s, 4)
        if self.hbm_exit is not None:
            d["hbm_bytes"] = self.hbm_exit
        if self.counts:
            d["counts"] = dict(self.counts)
        if self.children:
            d["children"] = [c.as_dict(anchor) for c in self.children]
        return d

    def walk(self):
        """This span and every span below it, depth first."""
        yield self
        for c in self.children:
            yield from c.walk()


@dataclass(frozen=True)
class Anchor:
    """One instant read on both clocks: `time.perf_counter_ns()` (spans,
    launch stamps) and `time.time_ns()` (the device trace's)."""
    perf_ns: int
    time_ns: int

    @staticmethod
    def now() -> "Anchor":
        return Anchor(time.perf_counter_ns(), time.time_ns())

    def unix_ns(self, perf_ns: int) -> int:
        """A `perf_counter_ns` instant on the Unix clock."""
        return perf_ns - self.perf_ns + self.time_ns


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
        self.anchor = Anchor.now()
        self.roots: List[Span] = []
        self.proves: List[List[Span]] = []
        self._stack: List[Span] = []
        self._loose: Dict[str, int] = {}

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the counter `name` of the innermost open span (with no
        span open, of the next retroactive span, `stage`)."""
        if not self.enabled:
            return
        counts = self._stack[-1].counts if self._stack else self._loose
        counts[name] = counts.get(name, 0) + n

    def span(self, name: str):
        """A context manager: the span `name`, open for the block (on a
        disabled profiler, one shared object that does nothing)."""
        return self._span(name) if self.enabled else _NO_SPAN

    @contextmanager
    def _span(self, name: str):
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

    def stage(self, name: str, start: float, end: float) -> Optional[Span]:
        """A retroactive span from `start` to `end` (`time.perf_counter`)
        at the current level (`prove` is a linear pipeline: one per
        stage, as the JAX package's prover adds them, and one per part of
        a stage), with the spans opened at that level since `start` as its
        children; at the top level it takes the counts made with no span
        open.  Returns the span (None when disabled)."""
        if not self.enabled:
            return None
        level = self._stack[-1].children if self._stack else self.roots
        k = len(level)
        while k and level[k - 1].start >= start:
            k -= 1
        s = Span(name, start, end - start, children=level[k:])
        if not self._stack:
            s.counts, self._loose = self._loose, {}
        if self.track_memory:
            s.hbm_exit = _device_mem_bytes()
        del level[k:]
        level.append(s)
        return s

    # ---- reporting -------------------------------------------------------

    def report(self) -> str:
        lines: List[str] = []

        def walk(s: Span, depth: int):
            mem = ""
            if s.hbm_exit is not None:
                mem = f"  hbm={s.hbm_exit / 2**20:.0f}MB"
                if s.hbm_enter is not None:
                    mem += f" (+{(s.hbm_exit - s.hbm_enter) / 2**20:.0f})"
            counts = "".join(f"  {k}={v}" for k, v in s.counts.items())
            lines.append(f"{'  ' * depth}{s.name}: {s.wall_s:.3f}s{mem}"
                         f"{counts}")
            for c in s.children:
                walk(c, depth + 1)

        for r in self.roots:
            walk(r, 0)
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps([r.as_dict(self.anchor) for r in self.roots],
                          indent=1)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def total(self, name: str) -> float:
        """Sum of wall_s over all spans with this name (any depth)."""
        return sum(s.wall_s for r in self.roots for s in r.walk()
                   if s.name == name)

    def tally(self, name: str, within: Optional[str] = None,
              roots: Optional[List[Span]] = None) -> int:
        """Sum of the counter `name` over every span of `roots` (default
        the profiler's), at any depth, or only over the spans named
        `within`."""
        return sum(s.counts.get(name, 0)
                   for r in (self.roots if roots is None else roots)
                   for s in r.walk() if within is None or s.name == within)


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


@contextmanager
def recording(track_memory: bool = False):
    """A fresh profiler as the process-wide one for the block, the one
    before it restored after: how a caller reads the counts of one call
    (`parallel/spawn.py`: the device tier's fetches, `d2h` in the spans
    `fused.fetch`)."""
    global PROFILER
    prev, PROFILER = PROFILER, Profiler(track_memory=track_memory)
    try:
        yield PROFILER
    finally:
        PROFILER = prev
