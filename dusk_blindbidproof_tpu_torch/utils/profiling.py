"""Lightweight per-phase wall-clock profiling (SURVEY.md §5 tracing row).

The reference has no tracing beyond dispatch logs
(/root/reference/src/futures/main.rs:31,35); profiling was external.  Here
the prover/verifier wrap each phase in `span(name)`: a no-op unless enabled
via BLINDBID_PROFILE=1 (or `enable()`), in which case wall time per span is
accumulated into a global table, printable with `report()`.

Phase boundaries in the engine are host-synchronized (transcript challenges
need device bytes on host), so wall-clock between boundaries is an honest
device+host split — spans do not add extra synchronization.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

_ENABLED = os.environ.get("BLINDBID_PROFILE", "0") == "1"
_TOTALS: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def reset() -> None:
    _TOTALS.clear()
    _COUNTS.clear()


@contextmanager
def span(name: str):
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TOTALS[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def totals() -> dict[str, float]:
    return dict(_TOTALS)


def report() -> str:
    lines = []
    total = sum(_TOTALS.values())
    for name, t in sorted(_TOTALS.items(), key=lambda kv: -kv[1]):
        lines.append(
            f"{name:28s} {t * 1e3:9.1f} ms  x{_COUNTS[name]:<4d}"
            f" {100 * t / total:5.1f}%"
        )
    lines.append(f"{'TOTAL':28s} {total * 1e3:9.1f} ms")
    return "\n".join(lines)
