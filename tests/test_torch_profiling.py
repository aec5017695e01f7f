"""The port's spans (utils/profiling.py), on the CPU: records with parent and
pass ids, self times, the bounded buffer, the ranges they leave in a
torch.profiler trace, the benchmark's readers of them, and the per-proof
accounts of a BlindBid prove and verify, without a mesh and on one."""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cheap_msms import fakes as msm_fakes
from bench_cuda import harness
from bench_cuda.tracing import HOST_SPANS
from dusk_blindbidproof_tpu_torch.models import blindbid
from dusk_blindbidproof_tpu_torch.ops import msm
from dusk_blindbidproof_tpu_torch.utils import profiling

torch.set_num_threads(1)

READERS = ("app.host_ms.batch", "device.wait_ms.batch", "limb.enqueue_ms.batch")
# a cut across the accounts: the committed values' host spans, whole
COMMIT = "commit.host_ms.batch"
COMMIT_SPANS = ("prove.commit_V_host", "verify.commit_V", "verify.wV")
MESH_READERS = ("mesh.collective_ms.batch", "mesh.rank_skew.batch")


@pytest.fixture
def spans():
    """Spans on, emptied, and off and emptied again afterwards."""
    profiling.reset()
    profiling.enable(True)
    try:
        yield profiling
    finally:
        profiling.enable(False)
        profiling.reset()


@pytest.fixture
def clock(monkeypatch):
    """profiling's clock made a counter that each read moves by 1 ns."""
    ticks = iter(range(10**9))
    monkeypatch.setattr(profiling, "time", SimpleNamespace(perf_counter_ns=lambda: next(ticks)))


def test_a_disabled_span_records_nothing_and_is_the_shared_no_op():
    profiling.reset()
    profiling.enable(False)
    first, second = profiling.span("a"), profiling.span("b")
    assert first is second
    with first as s:
        assert s.pass_id is None and s.index is None
    assert profiling.records() == [] and profiling.totals() == {}
    assert profiling.self_times() == {} and profiling.dropped() == 0


def test_nested_spans_carry_parent_and_pass_ids_on_each_thread(spans):
    barrier = threading.Barrier(2, timeout=30)

    def work(tag):
        with spans.span(f"{tag}.outer"):
            barrier.wait()  # both threads hold a span open at once
            with spans.span(f"{tag}.inner"):
                with spans.span(f"{tag}.leaf"):
                    pass
            with spans.span(f"{tag}.second"):
                pass

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    recs = {r.name: r for r in spans.records()}
    assert len(recs) == 8
    for tag in "ab":
        outer, inner = recs[f"{tag}.outer"], recs[f"{tag}.inner"]
        assert outer.parent is None
        assert inner.parent == outer.index
        assert recs[f"{tag}.leaf"].parent == inner.index
        assert recs[f"{tag}.second"].parent == outer.index
        assert {recs[f"{tag}.{n}"].pass_id for n in ("inner", "leaf", "second")} == {
            outer.pass_id}
        assert len({recs[f"{tag}.{n}"].thread for n in ("outer", "leaf")}) == 1
        r = recs[f"{tag}.leaf"]
        assert inner.start_ns <= r.start_ns <= r.end_ns <= inner.end_ns
    assert recs["a.outer"].pass_id != recs["b.outer"].pass_id
    assert recs["a.outer"].thread != recs["b.outer"].thread
    # a span opened after a pass has closed starts the next pass
    with spans.span("later"):
        pass
    later = spans.records()[-1]
    assert later.parent is None
    assert later.pass_id not in {recs["a.outer"].pass_id, recs["b.outer"].pass_id}


def test_self_times_take_away_the_children(spans, clock):
    # the clock moves 1 ns a read, and a span reads it as it opens and as it
    # closes: a span lasts 1 ns and 2 more for each span opened inside it
    with spans.span("root"):
        with spans.span("child"):
            with spans.span("leaf"):
                pass
        with spans.span("child"):
            pass
    tot, own = spans.totals(), spans.self_times()
    ns = {k: round(v * 1e9) for k, v in tot.items()}
    own_ns = {k: round(v * 1e9) for k, v in own.items()}
    assert ns == {"leaf": 1, "child": 3 + 1, "root": 7}
    assert own_ns == {"leaf": 1, "child": 4 - 1, "root": 7 - 4}
    assert sum(own_ns.values()) == ns["root"]  # self times tile the root
    assert "root" in spans.report() and "TOTAL" in spans.report()


def test_the_buffer_is_bounded_and_counts_what_it_dropped(spans, monkeypatch):
    monkeypatch.setattr(spans, "_RECORDS", deque(maxlen=4))
    for i in range(10):
        with spans.span(f"s{i}"):
            pass
    recs = spans.records()
    assert [r.name for r in recs] == ["s6", "s7", "s8", "s9"]
    assert spans.dropped() == 6
    assert len(spans.totals()) == 10  # totals never drop
    spans.reset()
    assert spans.records() == [] and spans.dropped() == 0 and spans.totals() == {}


def test_a_cpu_profiler_trace_holds_a_range_per_span(spans, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("app.outer"):
            with spans.span("device.h2d"):
                torch.ones(4).add_(1)
            with spans.span("device.h2d"):
                pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert len(ranges["app.outer"]) == 1 and len(ranges["device.h2d"]) == 2
    (s0, e0), = ranges["app.outer"]
    assert all(s0 <= s and e <= e0 for s, e in ranges["device.h2d"])


def _reader(name):
    return harness.Finder().module("metrics", name)


def test_the_readers_on_a_synthetic_record():
    record = {
        "proofs": 4,
        "span_self_s": {"app.prove_batch": 0.010, "app.witness": 0.030,
                        "prove": 0.002, "verify": 0.001, "prove.phase_a": 0.004,
                        "verify.device": 0.005, "prove.host_rng": 0.5,
                        "device.d2h": 0.006},
        "span_total_s": {"device.d2h": 0.006, "device.h2d": 0.010, "prove": 0.9},
    }
    assert _reader("app.host_ms.batch").read(record) == pytest.approx(10.0)
    assert _reader("device.wait_ms.batch").read(record) == pytest.approx(4.0)
    assert _reader("limb.enqueue_ms.batch").read(record) == pytest.approx(3.0)
    # a program without the spans: nothing to read, and no error
    bare = {"proofs": 4, "span_self_s": {"prove.phase_a": 1.0},
            "span_total_s": {"prove.host_rng": 1.0}}
    for name in READERS + (COMMIT,):
        assert _reader(name).read(bare) is None
        assert _reader(name).read({"proofs": 0}) is None


def test_the_committed_values_reader_on_a_synthetic_record():
    reader = _reader(COMMIT)
    record = {
        "proofs": 4,
        "span_total_s": {"prove.commit_V_host": 0.004, "verify.commit_V": 0.002,
                         "verify.wV": 0.006, "verify.assemble": 0.5, "prove": 0.9},
        "span_self_s": {"verify.commit_V": 1.0},  # not read: totals only
    }
    assert reader.read(record) == pytest.approx(3.0)
    # a parent without `verify.wV` reads the two spans it has
    parent = dict(record, span_total_s={"prove.commit_V_host": 0.004, "verify.commit_V": 0.002})
    assert reader.read(parent) == pytest.approx(1.5)
    # none of the three spans, or no proofs: nothing to read, and no error
    assert reader.read(dict(record, span_total_s={"verify.assemble": 0.5})) is None
    assert reader.read(dict(record, proofs=0)) is None
    assert reader.read({}) is None


def test_the_mesh_readers_on_a_synthetic_record():
    record = {
        "proofs": 4,
        "span_total_s": {"mesh.gather": 0.3, "mesh.broadcast": 0.1, "prove": 5.0},
        # the ranks' own work: 9, 8, 7 and 8 s, mean 8
        "rank_trip_s": [10.0, 10.0, 10.0, 10.0],
        "rank_mesh_s": [1.0, 2.0, 3.0, 2.0],
    }
    assert _reader("mesh.collective_ms.batch").read(record) == pytest.approx(100.0)
    assert _reader("mesh.rank_skew.batch").read(record) == pytest.approx(12.5)
    gather_only = dict(record, span_total_s={"mesh.gather": 0.2})
    assert _reader("mesh.collective_ms.batch").read(gather_only) == pytest.approx(50.0)
    even = dict(record, rank_mesh_s=[2.0] * 4)
    assert _reader("mesh.rank_skew.batch").read(even) == 0.0
    # nothing to read, and no error: an empty record, one card, a port
    # without the mesh's spans (a rank with none), lists that disagree
    for name in MESH_READERS:
        assert _reader(name).read({}) is None
        assert _reader(name).read({"proofs": 4, "span_total_s": {"prove": 1.0}}) is None
    assert _reader("mesh.collective_ms.batch").read(dict(record, proofs=0)) is None
    for spent in ([None] * 4, [1.0, 2.0, None, 2.0], [1.0, 2.0], []):
        assert _reader("mesh.rank_skew.batch").read(dict(record, rank_mesh_s=spent)) is None


# ---------------------------------------------------------------------------
# The four accounts of one prove_batch + verify_batch (L = 4, B = 2)
# ---------------------------------------------------------------------------


@pytest.fixture
def cheap_msms(monkeypatch):
    """The generator tables and every MSM replaced by zero tables and the
    basepoint (tests/cheap_msms.py): the control flow, the spans and the
    host work are the real ones, the proofs do not verify."""
    for name, fake in msm_fakes().items():
        monkeypatch.setattr(msm, name, fake)


def _measure(intervals) -> int:
    out, last = 0, None
    for s, e in sorted(intervals):
        if last is None or s > last:
            out += e - s
            last = e
        elif e > last:
            out += e - last
            last = e
    return out


def _accounts(recs) -> dict[str, list[tuple[int, int]]]:
    """Each account's host intervals: whole spans for the host phases, the
    device waits and the mesh's collectives, spans less their children for
    the self-time accounts."""
    enqueue = set(_reader("limb.enqueue_ms.batch").ENQUEUE_SPANS)
    kids = defaultdict(list)
    for r in recs:
        if r.parent is not None:
            kids[r.parent].append(r)

    def own(r):
        out, t = [], r.start_ns
        for c in sorted(kids[r.index], key=lambda c: c.start_ns):
            out.append((t, c.start_ns))
            t = c.end_ns
        out.append((t, r.end_ns))
        return [(s, e) for s, e in out if e > s]

    acc = defaultdict(list)
    for r in recs:
        if r.name in HOST_SPANS:
            acc["host"].append((r.start_ns, r.end_ns))
        elif r.name.startswith("app."):
            acc["app"] += own(r)
        elif r.name in enqueue:
            acc["enqueue"] += own(r)
        elif r.name in ("device.d2h", "device.h2d"):
            acc["wait"].append((r.start_ns, r.end_ns))
        elif r.name.startswith("mesh."):
            acc["mesh"].append((r.start_ns, r.end_ns))
    return acc


def test_the_four_accounts_are_disjoint_and_cover_a_round_trip(spans, cheap_msms):
    B = 2
    reqs = [blindbid.make_prove_request(d=1000 + i, k=2000 + i, seed=3000 + i,
                                        pub_list_extra=[11, 12, 13], toggle_pos=i)
            for i in range(B)]
    t0 = time.perf_counter_ns()
    proofs = blindbid.prove_batch(reqs, rng=np.random.default_rng(5), device="cpu")
    verdicts = blindbid.verify_batch(
        [blindbid.VerifyRequest(proof=p, score=r.q, z_img=r.z_img, seed=r.seed,
                                pub_list=r.pub_list) for p, r in zip(proofs, reqs)],
        device="cpu")
    wall = time.perf_counter_ns() - t0
    assert len(verdicts) == B
    recs = spans.records()
    assert spans.dropped() == 0
    names = {r.name for r in recs}
    assert {"app.prove_batch", "app.verify_batch", "app.circuit", "app.blindings",
            "app.witness", "app.publics", "prove", "verify",
            "device.h2d", "device.d2h", "prove.host_rng.transcript",
            "prove.host_rng.draw"} <= names
    assert {r.pass_id for r in recs if r.name == "prove"} != {
        r.pass_id for r in recs if r.name == "verify"}
    # the verifier's weights of the committed values: one span a verify call,
    # inside verify.assemble, so inside the host account's whole span
    by_index = {r.index: r for r in recs}
    weights = [r for r in recs if r.name == "verify.wV"]
    assert len(weights) == sum(1 for r in recs if r.name == "verify") == 1
    for r in weights:
        outer = by_index[r.parent]
        assert outer.name == "verify.assemble"
        assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns

    acc = _accounts(recs)
    sizes = {k: sum(e - s for s, e in v) for k, v in acc.items()}
    union = _measure([iv for v in acc.values() for iv in v])
    assert sum(sizes.values()) == union  # no instant is counted twice
    assert union <= wall
    assert union >= 0.9 * wall, (sizes, wall)

    # the readers give the same accounts from the totals and self times
    record = {"proofs": B, "span_self_s": spans.self_times(),
              "span_total_s": spans.totals()}
    host = sum(v for k, v in spans.totals().items() if k in HOST_SPANS)
    for name, key in zip(READERS, ("app", "wait", "enqueue")):
        assert _reader(name).read(record) == pytest.approx(sizes[key] / 1e6 / B, rel=1e-6)
    assert host * 1e3 / B == pytest.approx(sizes["host"] / 1e6 / B, rel=1e-6)
    commit = sum(r.end_ns - r.start_ns for r in recs if r.name in COMMIT_SPANS)
    assert {r.name for r in recs} >= set(COMMIT_SPANS)
    assert _reader(COMMIT).read(record) == pytest.approx(commit / 1e6 / B, rel=1e-6)
    # without the record's keys they read the same from the program's spans
    for name in READERS + (COMMIT,):
        assert _reader(name).read({"proofs": B}) == _reader(name).read(record)


@pytest.fixture
def one_rank_mesh():
    """A 1 x 1 mesh over a gloo process group of this process alone."""
    import torch.distributed as dist

    from dusk_blindbidproof_tpu_torch.parallel import mesh as pmesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield pmesh.make_mesh(bids=1, points=1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_the_accounts_stay_disjoint_with_the_mesh_spans_inside_them(spans, cheap_msms,
                                                                   one_rank_mesh):
    """With `mesh=`, the collectives' spans are children of `app.prove_batch`,
    `prove` and `verify`: their time leaves those spans' self time, so the
    five accounts never count an instant twice."""
    B = 2
    reqs = [blindbid.make_prove_request(d=1000 + i, k=2000 + i, seed=3000 + i,
                                        pub_list_extra=[11, 12, 13], toggle_pos=i)
            for i in range(B)]
    t0 = time.perf_counter_ns()
    proofs = blindbid.prove_batch(reqs, rng=np.random.default_rng(5), mesh=one_rank_mesh)
    verdicts = blindbid.verify_batch(
        [blindbid.VerifyRequest(proof=p, score=r.q, z_img=r.z_img, seed=r.seed,
                                pub_list=r.pub_list) for p, r in zip(proofs, reqs)],
        mesh=one_rank_mesh)
    wall = time.perf_counter_ns() - t0
    assert len(verdicts) == B
    recs = spans.records()
    names = {r.index: r.name for r in recs}
    parents = defaultdict(set)
    for r in recs:
        if r.name.startswith("mesh."):
            parents[r.name].add(names[r.parent])
    assert parents == {"mesh.broadcast": {"app.prove_batch"},
                       "mesh.gather": {"app.prove_batch", "prove", "verify"}}

    acc = _accounts(recs)
    assert set(acc) == {"host", "app", "enqueue", "wait", "mesh"}
    sizes = {k: sum(e - s for s, e in v) for k, v in acc.items()}
    union = _measure([iv for v in acc.values() for iv in v])
    assert sum(sizes.values()) == union  # no instant is counted twice
    assert wall * 0.9 <= union <= wall, (sizes, wall)
    record = {"proofs": B, "span_self_s": spans.self_times(), "span_total_s": spans.totals()}
    assert _reader("mesh.collective_ms.batch").read(record) == pytest.approx(
        sizes["mesh"] / 1e6 / B, rel=1e-6)
    for name, key in zip(READERS, ("app", "wait", "enqueue")):
        assert _reader(name).read(record) == pytest.approx(sizes[key] / 1e6 / B, rel=1e-6)
