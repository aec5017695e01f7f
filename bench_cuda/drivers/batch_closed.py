"""Closed-loop trips of the port's batch entry points, in this process.

A trip proves `batch` fresh statements and then verifies their proofs, one
of them altered by the benchmark (`traffic.tampered`, at a place drawn from
the seed), which must be refused.  Trips run one after another; every trip
that starts inside the window runs to its end, and `proofs_per_s` is the
proofs of all trips over the time from the first trip's start to the last
one's end.

Circuits (the configuration's `circuit`):
  blindbid  `models.blindbid.prove_batch` / `verify_batch` on the bidders of
            `traffic.bidders`; `distinct_batches` sets of bidders are drawn
            in set-up and trip i proves set i mod that number, with its own
            blinding draws;
  chain     `models.bulletproofs.Prover.prove` / `Verifier.verify` on the
            squaring chain at n = cap, each proof's committed input and
            blinding drawn from the seed.

Each answer carries what the reference prover needs to make its proof again
(`harness.judge`): the statement's witness, the commitments' blindings as the
trip's rng handed them out, and the prover's seed.

Set-up: the tables, the circuit and one warm-up trip at the cell's own batch.
With `--trace 1` the window's first `trace_trips` trips run under the
profiler (`tracing.Tracer`).
"""

from __future__ import annotations

import time

import numpy as np

from bench_cuda import faults, harness, traffic, tracing
from bench_cuda.reference import circuits
from bench_cuda.reference.curve import L

PROVER_SEED = b"\x00" * 32  # the 32 bytes `prove_batch` keys its blinding rng with


class BlindBid:
    def __init__(self, ctx, batch: int):
        from dusk_blindbidproof_tpu_torch.models import blindbid

        self.bb = blindbid
        self.ctx = ctx
        self.list_len = ctx.config["list_len"]
        tr = ctx.cell["traffic"]
        self.sets = [self._requests(f"batch{j}", batch) for j in range(tr["distinct_batches"])]
        self.warm = self._requests("warm", batch)

    def _requests(self, stream: str, batch: int):
        bids = traffic.bidders(self.ctx.seed, stream, batch, self.list_len)
        return [(self.bb.ProveRequest(**b), b) for b in bids]

    def setup(self) -> None:
        from dusk_blindbidproof_tpu_torch.models.bulletproofs import generator_tables
        from dusk_blindbidproof_tpu_torch.models.constants import GENS_CAPACITY
        from dusk_blindbidproof_tpu_torch.ops import fused

        if self.ctx.device.type == "cuda":
            fused.build()
        generator_tables(GENS_CAPACITY, self.ctx.device)
        self.bb.blindbid_circuit(self.list_len, self.ctx.device)

    def _blindings(self, stream: str, j: int) -> list[int]:
        """The blindings of row j's commitments, as the trip's rng hands them
        out: m scalars a row, rows in batch order."""
        gen = traffic.rng(self.ctx.seed, stream)
        m = 4 + self.list_len
        draws = [int.from_bytes(gen.bytes(32), "little") % L for _ in range((j + 1) * m)]
        return draws[-m:]

    def trip(self, i: int, warm: bool = False):
        """(answers, proofs proven) of trip i; the answer at the tampered
        place is the altered proof and the program's verdict on it."""
        from dusk_blindbidproof_tpu_torch.models.proof_struct import R1CSProof

        reqs = self.warm if warm else self.sets[i % len(self.sets)]
        seed = self.ctx.seed
        stream = f"blind{'w' if warm else i}"
        proofs = self.bb.prove_batch([r for r, _ in reqs], rng=traffic.rng(seed, stream),
                                     seed=PROVER_SEED, device=self.ctx.device)
        bad = traffic.picks(seed, f"tamper{i}", len(reqs), 1)[0]
        vreqs, answers = [], []
        for j, ((req, bid), p) in enumerate(zip(reqs, proofs)):
            wire = p.r1cs.to_bytes()
            if j == bad:
                wire = traffic.tampered(wire)
                p = self.bb.BlindBidProof(r1cs=R1CSProof.from_bytes(wire),
                                          commitments=p.commitments, t_c=p.t_c)
            vreqs.append(self.bb.VerifyRequest(proof=p, score=req.q, z_img=req.z_img,
                                               seed=req.seed, pub_list=req.pub_list))
            answers.append(dict(
                circuit=lambda b=bid: circuits.blindbid(b["pub_list"], b["q"], b["z_img"],
                                                        b["seed"]),
                rebuild=lambda b=bid, j=j: (
                    circuits.blindbid(b["pub_list"], b["q"], b["z_img"], b["seed"], witness=b),
                    self._blindings(stream, j), PROVER_SEED),
                proof=wire, commitments=list(p.commitments) + list(p.t_c), verdict=None,
                tampered=j == bad))
        verdicts = self.bb.verify_batch(vreqs, device=self.ctx.device) if vreqs else []
        for a, ok in zip(answers, verdicts):
            a["verdict"] = bool(ok)
        answers += [dict(circuit=None, rebuild=None, proof=None, commitments=None,
                         verdict=None, tampered=False)] * (len(reqs) - len(answers))
        return answers, len(reqs)


class Chain:
    def __init__(self, ctx, batch: int):
        from dusk_blindbidproof_tpu_torch.models.bulletproofs import ProverWitness
        from dusk_blindbidproof_tpu_torch.ops import limb

        self.ctx, self.batch = ctx, batch
        self.n = ctx.config["n_pad"]
        self.cap = ctx.config["gens_capacity"]
        gen = traffic.rng(ctx.seed, "chain")
        self.v0 = [traffic.scalar(gen) for _ in range(batch)]
        self.blind = [traffic.scalar(gen) for _ in range(batch)]
        cols = {"a_L": [], "a_O": []}
        for v in self.v0:
            x = v
            for _ in range(self.n - 1):
                cols["a_L"].append(x)
                x = x * x % L
                cols["a_O"].append(x)
            cols["a_L"].append(0)
            cols["a_O"].append(0)
        shape = (batch, self.n)
        a_L = limb.ints_to_limbs_fast(cols["a_L"], shape)
        self.witness = ProverWitness(
            a_L=a_L, a_R=a_L, a_O=limb.ints_to_limbs_fast(cols["a_O"], shape),
            v=limb.ints_to_limbs_fast(self.v0, (batch, 1)),
            v_blinding=limb.ints_to_limbs_fast(self.blind, (batch, 1)),
            publics=np.zeros((batch, 0, limb.NLIMBS), dtype=np.int32))

    def setup(self) -> None:
        from dusk_blindbidproof_tpu_torch.models.bulletproofs import (
            CompiledCircuit, generator_tables,
        )
        from dusk_blindbidproof_tpu_torch.models.r1cs import LC, VerifierCS
        from dusk_blindbidproof_tpu_torch.ops import fused

        if self.ctx.device.type == "cuda":
            fused.build()
        cs = VerifierCS()
        cur = LC.of(cs.commit_var())
        for _ in range(self.n - 1):
            _, _, o = cs.multiply(cur, cur)
            cur = LC.of(o)
        self.circuit = CompiledCircuit.compile(cs.artifact(), self.ctx.device)
        generator_tables(self.cap, self.ctx.device)

    def trip(self, i: int, warm: bool = False):
        from dusk_blindbidproof_tpu_torch.models.bulletproofs import Prover, Verifier
        from dusk_blindbidproof_tpu_torch.models.proof_struct import R1CSProof
        from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript

        B, dev, label = self.batch, self.ctx.device, circuits.CHAIN_LABEL
        prover = Prover([Transcript(label) for _ in range(B)], cap=self.cap, device=dev)
        comms = prover.commit_batch([[v] for v in self.v0], [[b] for b in self.blind])
        seed = traffic.rng(self.ctx.seed, f"blind{'w' if warm else i}").bytes(32)
        proofs = prover.prove(self.circuit, self.witness, seed=seed)
        bad = traffic.picks(self.ctx.seed, f"tamper{i}", B, 1)[0]
        wires = [p.to_bytes() for p in proofs]
        if bad < len(wires):
            wires[bad] = traffic.tampered(wires[bad])
        answers = [dict(circuit=lambda: circuits.chain(self.n),
                        rebuild=lambda j=j: (circuits.chain(self.n, v0=self.v0[j]),
                                             [self.blind[j]], seed),
                        proof=w, commitments=c, verdict=None, tampered=j == bad)
                   for j, (w, c) in enumerate(zip(wires, comms))]
        if wires:
            verifier = Verifier([Transcript(label) for _ in wires], cap=self.cap, device=dev)
            verifier.commit_batch(comms[:len(wires)])
            verdicts = verifier.verify(self.circuit, [R1CSProof.from_bytes(w) for w in wires],
                                       comms[:len(wires)], self.witness.publics[:len(wires)])
            for a, ok in zip(answers, verdicts):
                a["verdict"] = bool(ok)
        answers += [dict(circuit=None, rebuild=None, proof=None, commitments=None,
                         verdict=None, tampered=False)] * (B - len(answers))
        return answers, B


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def run(ctx) -> dict:
    import torch

    tr = ctx.cell["traffic"]
    batch = tr["batch"]
    work = {"blindbid": BlindBid, "chain": Chain}[ctx.config["circuit"]](ctx, batch)
    tracer = None
    if ctx.trace:
        tracer = tracing.Tracer(ctx.run_dir / "trace.json")
        tracer.install()
    work.setup()
    work.trip(0, warm=True)
    _sync(ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    faults.install(ctx.fault)
    setup_s = time.perf_counter() - ctx.t0
    ctx.log(f"set-up {setup_s:.3f} s")

    answers, proofs, trips = [], 0, 0
    counters = None
    traced = tr.get("trace_trips", 1)
    start = time.perf_counter()
    while trips == 0 or time.perf_counter() - start < ctx.seconds:
        if tracer is not None and trips == 0:
            tracer.start()
        got, n = work.trip(trips)
        _sync(ctx.device)
        answers += got
        proofs += n
        trips += 1
        if tracer is not None and trips == traced:
            counters = tracer.stop()
    end = time.perf_counter()
    if tracer is not None:
        if counters is None:
            counters = tracer.stop()
        tracer.export()
    ctx.log(f"window {end - start:.3f} s, {trips} trips, {proofs} proofs")
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    del work
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    sample = tr["sample"]
    picks = traffic.picks(ctx.seed, "sample", len(answers), sample)
    tampered = [i for i, a in enumerate(answers) if a["tampered"]]
    if tampered:  # one altered proof goes to the reference too
        picks = sorted(set(picks) | {tampered[traffic.picks(ctx.seed, "sample_bad",
                                                            len(tampered), 1)[0]]})
    return {
        "metrics": {"proofs_per_s": harness.rate(proofs, start, end), "setup_s": setup_s},
        "attempted": proofs,
        "failed": sum(1 for a in answers if a["proof"] is None or a["verdict"] is None),
        "answers": answers,
        "picks": picks,
        "judge_rng": traffic.rng(ctx.seed, "judge"),
        "peak": peak,
        "trace_path": ctx.run_dir / "trace.json",
        "counters": counters,
        "traced_proofs": min(trips, traced) * batch,
    }
