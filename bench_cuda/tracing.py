"""The traced window: the benchmark's own wrappers around the port's layer
calls, torch.profiler over the window, and the reduction of its trace to the
record that the per-layer metric readers read.

`Tracer.install()` wraps, in the process that runs the passes:

  * `blindbid.prove_batch` and `verify_batch` (models/blindbid.py): a
    profiler range `bench.prove_batch` / `bench.verify_batch` around each,
    the application layer's own host work (witness, limbs) included;
  * `Prover.prove` and `Verifier.verify` (models/bulletproofs.py): a range
    `bench.prove` / `bench.verify` around each;
  * the `span` of models/bulletproofs.py: each of the port's own spans is
    also a profiler range of its name, so an idle gap can be named by the
    span that was open on the host;
  * every kernel wrapper of ops/fused.py: a range `bench.kernel.<name>`, and
    the work of each call (`roofline.work`) while the window is open.

`start()` and `stop()` must run on the thread that runs the passes:
torch.profiler records the host ranges of the thread that started it.
`stop()` returns the window's counters and `export()` writes its Chrome
trace; the harness reduces the two with `summarize()`.
"""

from __future__ import annotations

import bisect
import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

from . import roofline

# the port's host-only spans: transcript, blinding draws, compression, assembly
HOST_SPANS = ("prove.host_rng", "prove.commit_V_host", "prove.host_yz", "prove.host_T",
              "prove.host_uxw", "prove.ipa_host", "verify.transcript", "verify.assemble")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# namespaces of the kernels PyTorch launches itself (copies inside a wrapper)
TORCH_KERNELS = ("at::", "c10::", "cub::")
TOP = 10


class Tracer:
    def __init__(self, trace_path: Path):
        self.trace_path = Path(trace_path)
        self.active = False
        self._prof = None
        self._reset()

    def _reset(self):
        self.least_s = 0.0
        self.calls = 0

    def install(self) -> None:
        import torch

        from dusk_blindbidproof_tpu_torch.models import blindbid, bulletproofs
        from dusk_blindbidproof_tpu_torch.ops import fused

        tracer = self
        record = torch.profiler.record_function
        program_span = bulletproofs.span

        @contextmanager
        def span(name):
            with program_span(name), record(name):
                yield

        bulletproofs.span = span

        def ranged(name, fn):
            def call(*args, **kwargs):
                with record(name):
                    return fn(*args, **kwargs)
            return call

        bulletproofs.Prover.prove = ranged("bench.prove", bulletproofs.Prover.prove)
        bulletproofs.Verifier.verify = ranged("bench.verify", bulletproofs.Verifier.verify)
        blindbid.prove_batch = ranged("bench.prove_batch", blindbid.prove_batch)
        blindbid.verify_batch = ranged("bench.verify_batch", blindbid.verify_batch)

        def kernel(name, fn):
            def call(*args):
                if tracer.active:
                    least = roofline.least_seconds(*roofline.work(name, args))
                    tracer.least_s += least
                    tracer.calls += 1
                with record(f"bench.kernel.{name}"):
                    return fn(*args)
            return call

        for name in roofline.WRAPPERS:
            setattr(fused, name, kernel(name, getattr(fused, name)))

    def start(self) -> None:
        import torch

        from dusk_blindbidproof_tpu_torch.utils import profiling

        self._reset()
        profiling.reset()
        profiling.enable(True)
        self.cuda = torch.cuda.is_available()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        import torch

        from dusk_blindbidproof_tpu_torch.utils import profiling

        if self.cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self.active = False
        profiling.enable(False)
        spans = profiling.totals()
        return {"window_s": window_s,
                "host_span_s": sum(spans.get(n, 0.0) for n in HOST_SPANS),
                "kernel_least_s": self.least_s, "kernel_calls": self.calls}


    def export(self) -> None:
        """Write the stopped window's Chrome trace (seconds for a busy window)."""
        self.trace_path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.trace_path))
        self._prof = None

    @staticmethod
    def warm_up() -> None:
        """Start and stop the profiler once, so that its first start in the
        window does not pay CUPTI's initialisation."""
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _gap_time_by_range(gaps, ranges) -> dict:
    """Each idle gap's time, split by the innermost host range open during
    it ("between passes" where none is): a sweep over the edges of both."""
    edges = [(s, 1, i) for i, (s, _, _) in enumerate(ranges)]
    edges += [(e, 0, i) for i, (_, e, _) in enumerate(ranges)]
    edges += [(g0, 3, -1) for g0, _ in gaps] + [(g1, 2, -1) for _, g1 in gaps]
    edges.sort()
    out = defaultdict(float)
    open_ranges: list[int] = []  # in the order opened; ranges of one thread nest
    in_gap, last = False, None
    for t, kind, i in edges:
        if in_gap and last is not None and t > last:
            out[ranges[open_ranges[-1]][2] if open_ranges else "between passes"] += t - last
        last = t
        if kind == 1:
            open_ranges.append(i)
        elif kind == 0:
            open_ranges.remove(i)
        else:
            in_gap = kind == 3
    return out


def summarize(trace_path: Path, counters: dict) -> dict:
    """The record of one traced window: the counters, and from the trace the
    device-busy seconds, the device operations by name, the idle time by the
    host range open during it, the device events counted, and the
    device time of the hand-written kernels (those launched inside a
    `bench.kernel.*` range whose names are not PyTorch's own)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    device, ranges, kranges, launches = [], [], defaultdict(list), []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("name", ""), cat,
                           e.get("args", {}).get("correlation")))
        elif cat == "user_annotation":
            ranges.append((ts, ts + dur, e["name"]))
            if e["name"].startswith("bench.kernel."):
                kranges[e.get("tid")].append((ts, ts + dur))
        elif cat == "cuda_runtime" and "Launch" in e.get("name", ""):
            launches.append((e.get("tid"), ts, e.get("args", {}).get("correlation")))
    busy = _union([(s, e) for s, e, *_ in device])
    busy_s = sum(e - s for s, e in busy) / 1e6
    by_name = defaultdict(float)
    for s, e, name, *_ in device:
        by_name[name[:120]] += (e - s) / 1e6
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    by_label = {k: v / 1e6 for k, v in _gap_time_by_range(gaps, ranges).items()}
    # the hand-written kernels: launched inside a wrapper's range
    inside = set()
    for tid, rs in kranges.items():
        rs.sort()
        starts = [s for s, _ in rs]
        for ltid, ts, corr in launches:
            if ltid != tid or corr is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= rs[i][1]:
                inside.add(corr)
    own_s = sum((e - s) / 1e6 for s, e, name, cat, corr in device
                if cat == "kernel" and corr in inside and not any(k in name for k in TORCH_KERNELS))
    return dict(
        counters,
        busy_s=busy_s,
        device_events=len(device),
        kernel_device_s=own_s,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP],
    )
