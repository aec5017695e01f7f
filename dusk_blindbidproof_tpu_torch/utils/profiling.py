"""Spans of the port's layers, kept in memory; off unless `enable()` is called.

The reference daemon has no tracing beyond its dispatch logs
(dusk-blindbidproof, src/futures/main.rs:31,35).  Here each layer wraps its
steps in `span(name)`:

  * off (the default), `span` returns one shared no-op context: nothing is
    made and nothing recorded;
  * on (`enable()`), a span pushes itself on its thread's stack and, when it
    closes, appends a `Span` record (index, name, start_ns, end_ns, parent,
    pass_id, thread) to a bounded buffer.  Clocks are
    `time.perf_counter_ns()`.  `index` numbers the spans in the order they
    opened; `parent` is the index of the innermost span open on the same
    thread when it opened (None at the top); a span opened on an empty stack
    starts a new `pass_id`, which its children inherit.  Once the buffer
    holds `CAPACITY` records the oldest go, counted by `dropped()`;
  * on, while a torch.profiler runs on the span's thread, the span is also a
    `torch.profiler.record_function` range of its name: it lands in the
    trace on the device trace's clock, and an idle gap of the card can be
    put down to the program's own innermost span.  Without a profiler the
    range is not made (it would cost some 15 us a span and record nothing).

Per name, the totals (`totals()`), the counts and the self times
(`self_times()`: the span's duration less the part its children cover) are
summed as spans close, so they never drop.  `records()` returns the buffer,
`report()` a table by total, and `reset()` clears all of it.

Counters sit beside the spans: `count(name, value)` adds `value` to the
counter `name` while spans are on and does nothing while they are off;
`counters()` returns the sums, and `reset()` clears them too.

Spans do not synchronise the device: a span around device work times the
host's enqueue, and the host's blocking copies are spans of their own
(`device.h2d`, `device.d2h` in models/bulletproofs.py).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch

CAPACITY = 1 << 16  # records kept; a prove and verify of 256 bids makes about 3,800


class Span(NamedTuple):
    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    pass_id: int
    thread: int


class _Off:
    """The context `span` returns while spans are off."""

    __slots__ = ()
    index = pass_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_ENABLED = False
_LOCK = threading.Lock()
_LOCAL = threading.local()
_INDEX = itertools.count()
_PASS = itertools.count()
_RECORDS: deque = deque(maxlen=CAPACITY)
_DROPPED = 0
_TOTALS: dict[str, int] = defaultdict(int)  # ns
_SELF: dict[str, int] = defaultdict(int)  # ns
_COUNTS: dict[str, int] = defaultdict(int)
_COUNTERS: dict[str, float] = defaultdict(float)


class _On:
    __slots__ = ("name", "index", "parent", "pass_id", "start", "child_ns", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.index = next(_INDEX)
        if stack:
            outer = stack[-1]
            self.parent, self.pass_id = outer.index, outer.pass_id
        else:
            self.parent, self.pass_id = None, next(_PASS)
        self.child_ns = 0
        stack.append(self)
        self.start = time.perf_counter_ns()
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        end = time.perf_counter_ns()
        stack = _LOCAL.stack
        stack.pop()
        dur = end - self.start
        if stack:
            stack[-1].child_ns += dur
        _close(Span(self.index, self.name, self.start, end, self.parent, self.pass_id,
                    threading.get_ident()), dur - self.child_ns)
        return False


def _close(rec: Span, self_ns: int) -> None:
    global _DROPPED
    with _LOCK:
        if len(_RECORDS) == _RECORDS.maxlen:
            _DROPPED += 1
        _RECORDS.append(rec)
        _TOTALS[rec.name] += rec.end_ns - rec.start_ns
        _SELF[rec.name] += self_ns
        _COUNTS[rec.name] += 1


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def reset() -> None:
    global _DROPPED
    with _LOCK:
        _RECORDS.clear()
        _DROPPED = 0
        _TOTALS.clear()
        _SELF.clear()
        _COUNTS.clear()
        _COUNTERS.clear()


def span(name: str):
    """A context that records one span of `name` while spans are on."""
    return _On(name) if _ENABLED else _OFF


def count(name: str, value: float = 1) -> None:
    """Add `value` to the counter `name` while spans are on."""
    if _ENABLED:
        with _LOCK:
            _COUNTERS[name] += value


def counters() -> dict[str, float]:
    """The counters' sums by name."""
    with _LOCK:
        return dict(_COUNTERS)


def records() -> list[Span]:
    with _LOCK:
        return list(_RECORDS)


def dropped() -> int:
    return _DROPPED


def totals() -> dict[str, float]:
    """Seconds by name, each span's whole duration."""
    with _LOCK:
        return {k: v / 1e9 for k, v in _TOTALS.items()}


def self_times() -> dict[str, float]:
    """Seconds by name, each span's duration less its children's."""
    with _LOCK:
        return {k: v / 1e9 for k, v in _SELF.items()}


def report() -> str:
    """One line a name, by total: total and self ms, count, and the self
    time's share of all self time (the spans' covered wall)."""
    tot, own = totals(), self_times()
    wall = sum(own.values())
    lines = []
    for name, t in sorted(tot.items(), key=lambda kv: -kv[1]):
        lines.append(
            f"{name:28s} {t * 1e3:9.1f} ms  self {own[name] * 1e3:9.1f} ms"
            f"  x{_COUNTS[name]:<4d} {100 * own[name] / wall if wall else 0.0:5.1f}%"
        )
    lines.append(f"{'TOTAL':28s} {wall * 1e3:9.1f} ms")
    return "\n".join(lines)
