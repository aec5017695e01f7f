"""The port's daemon under a backlog of bidder sessions.

The daemon is the port's own `server.BlindBidServer` over
`BatchingService(device=)` at the service's defaults (a batch flushed 5 ms
after its first request or at `max_batch` 16, one worker thread), on a Unix
socket in the run's folder.  Its event loop is this process's main thread and
its passes run on the service's worker thread, so the tracer sees them.  The
bidders are `bench_cuda/uds_client.py`, a child process that speaks wire
bytes alone (`reference/wire.py`) and imports nothing of the port: the
cell's connections in closed loop, each session one opcode-1 prove then one
opcode-2 verify of the proof that came back, one session in `altered_every`
sending its proof back with t_x + 1.

End-to-end metrics, on the client's clock:

  proofs_per_s  sessions answered in full (a proof, then a verdict) over the
                time from the first session's start to the last one's end;
                every session started inside the window runs to its end;
  setup_s       from this process's start to the end of the client's
                warm-up session through the socket (the daemon started: its
                kernels, tables and circuit).

With `--trace 1` the tracer starts on the service's worker thread at the
first pass boundary after the window's midpoint, and stops there at the
first one after the loop has seen the `trace_passes`-th pass begin (or at
the window's end, if fewer began), both through the service's
`run_on_worker`.  The first half is left out: the bidders' first requests
all arrive in the window's first second and queue in order, so the first
few dozen passes are the ramp's proves, fuller than later ones.  Later the
passes still come in waves, a few dozen proves then their verifies, so a
stretch of 32 holds mostly one kind.  The counters carry the port's span
totals and self times and its counters (`program_counters`) as they stood
at the stop; the traced passes and requests are the port's counts
`server.passes` and `server.requests`, and a traced proof is one session,
two requests passed.

The daemon draws its blindings from its own entropy, as the upstream
daemon's `thread_rng`, so no proof can be made again: the reference verifies
the sampled proofs against the statements the client sent, and rebuilds
none.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import queue
import sys
import time
from pathlib import Path

from bench_cuda import faults, traffic, tracing
from bench_cuda.drivers.batch_closed import _sync
from bench_cuda.reference import circuits

CLIENT = Path(__file__).resolve().parents[1] / "uds_client.py"
ANSWER_TIMEOUT_S = 300.0  # the longest the client waits for one answer
SLACK_S = 2 * ANSWER_TIMEOUT_S + 60.0  # s beyond the window for the last sessions
SOCKET_PATH_MAX = 100  # bytes: sun_path holds 108 with its terminator
POLL_S = 0.005  # how often the loop looks at the traced stretch's pass count


def _worker(service, tracer):
    """(run, counts) of the daemon's worker thread: `run(fn)` awaits `fn()`
    there, between two passes, ahead of the passes queued; `counts()` gives
    the passes begun and the requests passed while the tracer is on, and the
    port's counters.  A port without `run_on_worker` and its counters gets
    both from a wrapper around its pass, and no counters."""
    from dusk_blindbidproof_tpu_torch.utils import profiling

    if hasattr(service, "run_on_worker"):
        def counts():
            program = profiling.counters()
            return program.get("server.passes", 0), program.get("server.requests", 0), program

        return service.run_on_worker, counts

    calls, seen = queue.SimpleQueue(), [0, 0]
    inner = service._pass

    def drain():
        while not calls.empty():
            fn, fut = calls.get()
            try:
                fut.set_result(fn())
            except BaseException as exc:
                fut.set_exception(exc)

    def traced(key, q):
        drain()
        if tracer.active:
            seen[0] += 1
            seen[1] += len(q)
        return inner(key, q)

    async def run(fn):
        fut = concurrent.futures.Future()
        calls.put((fn, fut))
        service._executor.submit(drain)
        return await asyncio.wrap_future(fut)

    service._pass = traced
    return run, lambda: (seen[0], seen[1], None)


async def _traced_stretch(service, tracer, limit: int, start_at: float,
                          closed: asyncio.Event, log) -> dict:
    """The tracer on over `limit` passes from `start_at` (perf_counter s), or
    up to `closed`; the window's counters."""
    from dusk_blindbidproof_tpu_torch.utils import profiling

    run, counts = _worker(service, tracer)
    try:
        await asyncio.wait_for(closed.wait(), max(0.0, start_at - time.perf_counter()))
    except asyncio.TimeoutError:
        pass
    await run(tracer.start)
    while counts()[0] < limit and not closed.is_set():
        await asyncio.sleep(POLL_S)

    def stop() -> dict:
        counters = tracer.stop()
        counters["span_total_s"] = profiling.totals()
        counters["span_self_s"] = profiling.self_times()
        passes, requests, program = counts()
        counters.update(traced_passes=passes, traced_requests=requests)
        if program is not None:
            counters["program_counters"] = program
        return counters

    counters = await run(stop)
    if not counters["traced_passes"]:
        raise RuntimeError("no pass began in the window's second half")
    wait = (counters.get("program_counters") or {}).get("server.queue_wait_s")
    log(f"traced {counters['traced_passes']} passes, {counters['traced_requests']} "
        f"requests, {counters['window_s']:.3f} s"
        + ("" if wait is None else
           f", queue wait {wait / counters['traced_requests'] * 1e3:.1f} ms a request"))
    return counters


async def _line(proc, timeout: float, what: str) -> dict:
    try:
        line = await asyncio.wait_for(proc.stdout.readline(), timeout)
    except asyncio.TimeoutError:
        proc.kill()
        await proc.wait()
        raise RuntimeError(f"the client gave no {what} line within {timeout:.0f} s") from None
    if not line:
        raise RuntimeError(f"the client ended before its {what} line: exit {await proc.wait()}")
    return json.loads(line)


async def _serve(ctx, tracer) -> dict:
    import torch

    from dusk_blindbidproof_tpu_torch import server

    tr = ctx.cell["traffic"]
    path = str(ctx.run_dir / "bb.sock")
    if len(path.encode()) > SOCKET_PATH_MAX:
        raise RuntimeError(f"socket path too long for AF_UNIX: {path}")
    service = server.BatchingService(device=ctx.device)
    daemon = server.BlindBidServer(path, service)
    await daemon.start()
    proc = stretch = None
    closed = asyncio.Event()
    try:
        params = dict(socket=path, seed=ctx.seed, list_len=ctx.config["list_len"],
                      seconds=ctx.seconds, out=str(ctx.run_dir / "sessions.json"),
                      traffic=tr, answer_timeout_s=ANSWER_TIMEOUT_S)
        (ctx.run_dir / "client.json").write_text(json.dumps(params))
        proc = await asyncio.create_subprocess_exec(
            sys.executable, str(CLIENT), str(ctx.run_dir / "client.json"),
            stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE)
        ready = await _line(proc, 2 * ANSWER_TIMEOUT_S, "ready")
        _sync(ctx.device)
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
        faults.install(ctx.fault)
        setup_s = time.perf_counter() - ctx.t0
        ctx.log(f"set-up {setup_s:.3f} s (client {ready['ready']:.3f} s)")
        if tracer is not None:
            stretch = asyncio.create_task(_traced_stretch(
                service, tracer, tr["trace_passes"], time.perf_counter() + ctx.seconds / 2,
                closed, ctx.log))
        proc.stdin.write(b"go\n")
        await proc.stdin.drain()
        done = await _line(proc, ctx.seconds + SLACK_S, "done")
        closed.set()
        ctx.log(f"window closed: {done['done']} sessions")
        if await proc.wait() != 0:
            raise RuntimeError(f"the client exited {proc.returncode}")
        proc = None
        counters = None if stretch is None else await stretch
        _sync(ctx.device)
        peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    finally:
        if stretch is not None and not stretch.done():
            stretch.cancel()
        if proc is not None and proc.returncode is None:
            proc.kill()
            await proc.wait()
        await daemon.close()
    if daemon.fault is not None:
        raise daemon.fault
    return dict(setup_s=setup_s, peak=peak, counters=counters)


def _answers(ctx, sessions: list[dict]) -> list[dict]:
    """`harness.judge`'s answers: each session with the reference's circuit of
    the statement its client sent (the same draw from the seed)."""
    tr = ctx.cell["traffic"]
    statements = traffic.bidders(ctx.seed, "sessions", tr["distinct_sessions"],
                                 ctx.config["list_len"])
    answers = []
    for s in sessions:
        b = statements[s["statement"]]
        points = None if s["commitments"] is None else s["commitments"] + s["toggles"]
        answers.append(dict(
            circuit=lambda b=b: circuits.blindbid(b["pub_list"], b["q"], b["z_img"], b["seed"]),
            rebuild=None,
            proof=None if s["r1cs"] is None else bytes.fromhex(s["r1cs"]),
            commitments=None if points is None else [bytes.fromhex(c) for c in points],
            verdict=s["verdict"], tampered=s["tampered"]))
    return answers


def run(ctx) -> dict:
    tr = ctx.cell["traffic"]
    tracer = None
    if ctx.trace:
        tracer = tracing.Tracer(ctx.run_dir / "trace.json")
        tracer.install()
        if ctx.device.type == "cuda":
            tracing.Tracer.warm_up()
    served = asyncio.run(_serve(ctx, tracer))
    counters = served["counters"]
    if tracer is not None:
        tracer.export()

    sessions = json.loads((ctx.run_dir / "sessions.json").read_text())
    answers = _answers(ctx, sessions)
    full = [s for s in sessions if s["r1cs"] is not None and s["verdict"] is not None]
    rate = 0.0
    if full:
        start = min(s["start"] for s in sessions)
        rate = len(full) / (max(s["end"] for s in sessions) - start)
    ctx.log(f"{len(full)} of {len(sessions)} sessions answered in full, {rate:.3f} a second")

    picks = traffic.picks(ctx.seed, "sample", len(answers), tr["sample"])
    tampered = [i for i, a in enumerate(answers) if a["tampered"]]
    if tampered:  # one altered proof goes to the reference too
        picks = sorted(set(picks) | {tampered[traffic.picks(ctx.seed, "sample_bad",
                                                            len(tampered), 1)[0]]})
    return {
        "metrics": {"proofs_per_s": rate, "setup_s": served["setup_s"]},
        "attempted": len(sessions),
        "failed": len(sessions) - len(full),
        "answers": answers,
        "picks": picks,
        "judge_rng": traffic.rng(ctx.seed, "judge"),
        "peak": served["peak"],
        "trace_path": ctx.run_dir / "trace.json",
        "counters": counters,
        "traced_proofs": 0 if counters is None else counters["traced_requests"] / 2,
    }
