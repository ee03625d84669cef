"""Span-based profiling: nested wall-clock spans + device-memory watermarks.

Copied from the JAX package's `utils/profiling.py` and cut to what the
port reads: `Profiler.span` (Dory's `open`, `open_rlc` and the prover's
stage-0 commits open spans on the process-wide `PROFILER`) and
`Profiler.total`.  `PROFILER` is the disabled null object until a caller
installs an enabled `Profiler` in its place, as `chip_smoke.py` does, so
nothing is paid when no one reads the spans.

Spans record wall time as the HOST sees it (the Dory work they cover runs
on the host), plus the card's peak allocated bytes
(`torch.cuda.max_memory_allocated`) once the process has used the card.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Optional


def _device_mem_bytes() -> Optional[int]:
    """Peak allocated bytes on the current CUDA device
    (`torch.cuda.max_memory_allocated`) once the process has used the
    card; None otherwise (a CPU run reports nothing)."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return int(torch.cuda.max_memory_allocated()) or None
    return None


@dataclass
class Span:
    name: str
    start: float
    wall_s: float = 0.0
    hbm_enter: Optional[int] = None
    hbm_exit: Optional[int] = None
    children: List["Span"] = field(default_factory=list)


class Profiler:
    """Nested span recorder.  Usage:

        prof = Profiler(enabled=True)
        with prof.span("stage1"):
            with prof.span("message"):
                ...
        prof.total("message")
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
PROFILER: Profiler = _NULL


def active() -> Profiler:
    """The process-wide profiler (null object when disabled)."""
    return PROFILER

