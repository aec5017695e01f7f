"""One rank of the `mesh_closed` driver: a process of its own, started by
`parallel.mesh.spawn`, which finds `run` by its name in this module.

Every rank takes its share of the host's cores for torch's threads, builds
the mesh of the configuration's `mesh` block (`parallel.mesh.make_mesh`, a
card a rank over NCCL on the chip, gloo on the CPU), its own tables and
circuit, and runs the warm-up trip; then the faults of `--fault` are planted
in it.  It reports its card and backend, which the driver checks.  A trip is
`batch_closed`'s, on the mesh: every rank is handed the whole batch, proves
and verifies the rows of its bids index, and gets the whole batch's proofs
and verdicts back.  Rank 0 decides whether another trip starts inside the
window and broadcasts the decision, so every rank joins every collective of
every trip.  Rank 0 alone keeps the answers.

With `--trace 1` every rank runs its first `trace_trips` trips under a
`tracing.Tracer` of its own, so the profiler costs every rank alike; rank 0
writes its trace for the harness, and every rank reports its traced trips'
time and its time inside the port's `mesh.*` spans.
"""

from __future__ import annotations

import os
import sys
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

from bench_cuda import faults, harness, traffic, tracing
from bench_cuda.drivers import batch_closed
from bench_cuda.reference import circuits

PROVER_SEED = batch_closed.PROVER_SEED


def _verdicts(rows: list[dict], verdicts: list) -> list[dict]:
    for row, ok in zip(rows, verdicts):
        row["verdict"] = bool(ok)
    return rows


class BlindBid(batch_closed.BlindBid):
    """`prove_batch` / `verify_batch(mesh=)` on `batch_closed`'s bidders."""

    def __init__(self, ctx, batch: int, mesh):
        super().__init__(ctx, batch)
        self.mesh = mesh

    def trip(self, i: int, warm: bool = False):
        """(rows, proofs proven) of trip i: a row a proof, in batch order,
        with its wire bytes, commitments, verdict and whether it was the
        altered one."""
        from dusk_blindbidproof_tpu_torch.models.proof_struct import R1CSProof

        reqs = self.warm if warm else self.sets[i % len(self.sets)]
        seed = self.ctx.seed
        rng = traffic.rng(seed, f"blind{'w' if warm else i}")
        proofs = self.bb.prove_batch([r for r, _ in reqs], rng=rng, seed=PROVER_SEED,
                                     mesh=self.mesh)
        bad = traffic.picks(seed, f"tamper{i}", len(reqs), 1)[0]
        vreqs, rows = [], []
        for j, ((req, _), p) in enumerate(zip(reqs, proofs)):
            wire = p.r1cs.to_bytes()
            if j == bad:
                wire = traffic.tampered(wire)
                p = self.bb.BlindBidProof(r1cs=R1CSProof.from_bytes(wire),
                                          commitments=p.commitments, t_c=p.t_c)
            vreqs.append(self.bb.VerifyRequest(proof=p, score=req.q, z_img=req.z_img,
                                               seed=req.seed, pub_list=req.pub_list))
            rows.append(dict(proof=wire, commitments=list(p.commitments) + list(p.t_c),
                             verdict=None, tampered=j == bad))
        verdicts = self.bb.verify_batch(vreqs, mesh=self.mesh) if vreqs else []
        return _verdicts(rows, verdicts), len(reqs)


class Chain(batch_closed.Chain):
    """`Prover` / `Verifier(mesh=)` on `batch_closed`'s squaring chain."""

    def __init__(self, ctx, batch: int, mesh):
        super().__init__(ctx, batch)
        self.mesh = mesh

    def trip(self, i: int, warm: bool = False):
        from dusk_blindbidproof_tpu_torch.models.bulletproofs import Prover, Verifier
        from dusk_blindbidproof_tpu_torch.models.proof_struct import R1CSProof
        from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript

        B, label = self.batch, circuits.CHAIN_LABEL
        prover = Prover([Transcript(label) for _ in range(B)], cap=self.cap, mesh=self.mesh)
        comms = prover.commit_batch([[v] for v in self.v0], [[b] for b in self.blind])
        seed = traffic.rng(self.ctx.seed, f"blind{'w' if warm else i}").bytes(32)
        proofs = prover.prove(self.circuit, self.witness, seed=seed)
        bad = traffic.picks(self.ctx.seed, f"tamper{i}", B, 1)[0]
        wires = [p.to_bytes() for p in proofs]
        if bad < len(wires):
            wires[bad] = traffic.tampered(wires[bad])
        rows = [dict(proof=w, commitments=c, verdict=None, tampered=j == bad)
                for j, (w, c) in enumerate(zip(wires, comms))]
        verdicts = []
        if wires:
            verifier = Verifier([Transcript(label) for _ in wires], cap=self.cap, mesh=self.mesh)
            verifier.commit_batch(comms[:len(wires)])
            verdicts = verifier.verify(self.circuit, [R1CSProof.from_bytes(w) for w in wires],
                                       comms[:len(wires)], self.witness.publics[:len(wires)])
        return _verdicts(rows, verdicts), B


def _from_lead(go: bool) -> bool:
    """Rank 0's `go`, on every rank."""
    box = [go]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(dev: torch.device, job: dict) -> dict:
    """This rank's part of one run of the cell in `job` (seed, config, cell,
    seconds, trace, fault, trace_path).  Returns its card and backend, the
    wall-clock time (`time.time()`) at which its warm-up ended, its card's
    peak memory, and with a trace its traced trips' seconds and its seconds inside `mesh.*`
    spans (None without such spans); rank 0 adds the trips' rows, the
    proofs, the window's seconds and the tracer's counters."""
    from dusk_blindbidproof_tpu_torch.parallel import mesh as pmesh
    from dusk_blindbidproof_tpu_torch.utils import profiling

    layout, tr = job["config"]["mesh"], job["cell"]["traffic"]
    # the host's cores shared out: each rank's torch threads as on a host of its own
    world = layout["bids"] * layout["points"]
    torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                     len(os.sched_getaffinity(0)) // world)))
    mesh = pmesh.make_mesh(bids=layout["bids"], points=layout["points"], device=dev)
    lead = mesh.rank == 0
    ctx = SimpleNamespace(seed=job["seed"], config=job["config"], cell=job["cell"],
                          device=mesh.device)
    work = {"blindbid": BlindBid, "chain": Chain}[job["config"]["circuit"]](
        ctx, tr["batch"], mesh)
    tracer = None
    if job["trace"]:
        tracer = tracing.Tracer(job["trace_path"])
        tracer.install()
    work.setup()
    work.trip(0, warm=True)
    _sync(mesh.device)
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    faults.install(job["fault"])
    warm_end = time.time()
    dist.barrier()  # the window opens once every rank is warm

    rows, proofs, trips = [], 0, 0
    counters, trip_s = None, 0.0
    traced = tr.get("trace_trips", 1)
    start = time.perf_counter()
    while _from_lead(trips == 0 or time.perf_counter() - start < job["seconds"]):
        if tracer is not None and trips == 0:
            tracer.start()
        t = time.perf_counter()
        got, n = work.trip(trips)
        _sync(mesh.device)
        if trips < traced:
            trip_s += time.perf_counter() - t
        if lead:
            rows.append(got)
        proofs += n
        trips += 1
        if tracer is not None and trips == traced:
            counters = tracer.stop()
    end = time.perf_counter()
    out = {"rank": mesh.rank, "card": str(mesh.device), "backend": dist.get_backend(),
           "warm_end": warm_end,
           "peak": torch.cuda.max_memory_allocated(mesh.device)
           if mesh.device.type == "cuda" else 0}
    if tracer is not None:
        if counters is None:
            counters = tracer.stop()
        totals = profiling.totals()
        spent = [s for name, s in totals.items() if name.startswith("mesh.")]
        out["trip_s"], out["mesh_s"] = trip_s, sum(spent) if spent else None
        if lead:
            tracer.export()
            counters.update(span_total_s=totals, span_self_s=profiling.self_times())
    if lead:
        print(f"window {end - start:.3f} s, {trips} trips, {proofs} proofs",
              file=sys.stderr, flush=True)
        out.update(rows=rows, proofs=proofs, window_s=end - start, counters=counters,
                   traced_proofs=min(trips, traced) * tr["batch"])
    loaded = harness.forbidden_modules()
    if loaded:
        raise RuntimeError(f"JAX or the JAX package was loaded in rank {mesh.rank}: {loaded}")
    return out
