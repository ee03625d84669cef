"""The span trees of the window's proves, for the readers of the spans
below the stage roots and of the counters in them.

The harness's `Window` carries each prove's root spans as name -> seconds.
The trees are read from the program's profiler instead, which keeps the
stage spans of each `prove` call, children and counts included
(`Profiler.proves`, `jolt_tpu_torch/utils/profiling.py`), until the
harness replaces it after the readers have run.  Each of the window's
proves is matched, in order, to the call whose root spans give the same
names and seconds.  A program that keeps no such list, or a window that a
call does not match, gives None: the reader then reports nothing.
"""

from __future__ import annotations

from typing import List, Optional


def trees(window) -> Optional[List[list]]:
    """One list of root spans a prove of the window, or None."""
    try:
        from jolt_tpu_torch.utils import profiling
    except ImportError:
        return None
    calls = getattr(profiling.PROFILER, "proves", None)
    if not calls or not window.spans:
        return None
    out, it = [], iter(calls)
    for want in window.spans:
        for roots in it:
            if {s.name: s.wall_s for s in roots} == want:
                out.append(roots)
                break
        else:
            return None
    return out


def walk(span):
    """The span and every span below it."""
    yield span
    for c in span.children:
        yield from walk(c)


def counted(roots, name: str) -> int:
    """The counter `name` summed over every span of a prove's tree."""
    return sum(s.counts.get(name, 0) for r in roots for s in walk(r))
