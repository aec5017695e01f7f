"""`batch_closed`'s closed-loop trips on a mesh of ranks, one process a rank.

The configuration's `mesh` block lays out the ranks: `bids` x `points` of
them (the cell's traffic must name the same), started by
`parallel.mesh.spawn` over the block's `backend` on CUDA, and over gloo on
the CPU.  On CUDA the ranks must end on as many distinct cards as the cell
has chips, each over that backend, or the run fails: spawn refuses NCCL
without a card a rank, and nothing falls back to ranks sharing a card.
Every rank calls the port's entry points with `mesh=` on the whole batch
(`bench_cuda.mesh_rank`, which `spawn` finds by name); the trips, the
altered proof, the bidders and the blindings are `batch_closed`'s, so a
proof's bytes are those one card makes from the same inputs, and
`harness.judge` holds the answers to the same reference.

This process builds the kernels once before the ranks start, so the ranks
never run nvcc at once.  The end-to-end metrics:

  proofs_per_s  rank 0's proofs over the time from the first trip's start to
                the last one's end; a trip ends when `verify_batch` returns
                the whole batch's verdicts on rank 0;
  setup_s       from this process's start to the end of the last rank's
                warm-up, both on the wall clock (`perf_counter` is not
                comparable across processes).

`peak` is the fullest card's.  The ranks must end within the window plus
`SLACK_S`; a job that hangs fails instead of holding its cards.  With
`--trace 1` the harness reads rank 0's trace, and the counters carry rank
0's span totals and self times and, in rank order, each rank's traced trip
seconds (`rank_trip_s`) and seconds in `mesh.*` spans (`rank_mesh_s`).
"""

from __future__ import annotations

import time

from bench_cuda import mesh_rank, traffic
from bench_cuda.drivers import batch_closed
from bench_cuda.reference import circuits

SLACK_S = 600.0  # s beyond the window for set-up, the last trip and the ranks' exit


def _answers(ctx, batch: int):
    """trip index, rows -> `harness.judge`'s answers: each row with the
    reference's circuit of its statement and what its proof is rebuilt from."""
    seed = ctx.seed
    if ctx.config["circuit"] == "blindbid":
        work = batch_closed.BlindBid(ctx, batch)

        def blindbid(i, rows):
            reqs, stream = work.sets[i % len(work.sets)], f"blind{i}"
            return [dict(row,
                         circuit=lambda b=bid: circuits.blindbid(b["pub_list"], b["q"],
                                                                 b["z_img"], b["seed"]),
                         rebuild=lambda b=bid, j=j: (
                             circuits.blindbid(b["pub_list"], b["q"], b["z_img"], b["seed"],
                                               witness=b),
                             work._blindings(stream, j), mesh_rank.PROVER_SEED))
                    for j, ((_, bid), row) in enumerate(zip(reqs, rows))]
        return blindbid

    n = ctx.config["n_pad"]
    gen = traffic.rng(seed, "chain")
    v0 = [traffic.scalar(gen) for _ in range(batch)]
    blind = [traffic.scalar(gen) for _ in range(batch)]

    def chain(i, rows):
        prover_seed = traffic.rng(seed, f"blind{i}").bytes(32)
        return [dict(row, circuit=lambda: circuits.chain(n),
                     rebuild=lambda j=j: (circuits.chain(n, v0=v0[j]), [blind[j]], prover_seed))
                for j, row in enumerate(rows)]
    return chain


def run(ctx) -> dict:
    from dusk_blindbidproof_tpu_torch.ops import fused
    from dusk_blindbidproof_tpu_torch.parallel import mesh as pmesh

    t0_wall = time.time() - (time.perf_counter() - ctx.t0)
    tr = ctx.cell["traffic"]
    batch = tr["batch"]
    layout = ctx.config["mesh"]
    if (tr["bids"], tr["points"]) != (layout["bids"], layout["points"]):
        raise ValueError(f"the cell's traffic lays out {tr['bids']} x {tr['points']} ranks, "
                         f"its configuration {layout['bids']} x {layout['points']}")
    world = layout["bids"] * layout["points"]
    cuda = ctx.device.type == "cuda"
    if cuda and world != ctx.cell["chips"]:
        raise ValueError(f"{world} ranks on {ctx.cell['chips']} chips: the mesh runs a card a rank")
    backend = layout["backend"] if cuda else "gloo"
    if cuda:
        fused.build()
    job = dict(seed=ctx.seed, config=ctx.config, cell=ctx.cell, seconds=ctx.seconds,
               trace=ctx.trace, fault=ctx.fault, trace_path=str(ctx.run_dir / "trace.json"))
    ranks = pmesh.spawn(mesh_rank.run, world, device=ctx.device.type, backend=backend,
                        args=(job,), timeout=min(ctx.seconds + SLACK_S, pmesh.SPAWN_TIMEOUT))
    cards = {r["card"] for r in ranks}
    if cuda and (len(cards) != world or {r["backend"] for r in ranks} != {backend}):
        raise RuntimeError(f"the ranks ran on {sorted(cards)} over "
                           f"{sorted({r['backend'] for r in ranks})}, not a card a rank "
                           f"over {backend}")
    lead = ranks[0]
    setup_s = max(r["warm_end"] for r in ranks) - t0_wall
    ctx.log(f"set-up {setup_s:.3f} s; {len(ranks)} ranks")

    answer = _answers(ctx, batch)
    answers = []
    for i, rows in enumerate(lead["rows"]):
        got = answer(i, rows)
        answers += got + [dict(circuit=None, rebuild=None, proof=None, commitments=None,
                               verdict=None, tampered=False)] * (batch - len(got))
    counters = lead["counters"]
    if counters is not None:
        counters.update(rank_trip_s=[r["trip_s"] for r in ranks],
                        rank_mesh_s=[r["mesh_s"] for r in ranks])

    picks = traffic.picks(ctx.seed, "sample", len(answers), tr["sample"])
    tampered = [i for i, a in enumerate(answers) if a["tampered"]]
    if tampered:  # one altered proof goes to the reference too
        picks = sorted(set(picks) | {tampered[traffic.picks(ctx.seed, "sample_bad",
                                                            len(tampered), 1)[0]]})
    return {
        "metrics": {"proofs_per_s": lead["proofs"] / lead["window_s"], "setup_s": setup_s},
        "attempted": lead["proofs"],
        "failed": sum(1 for a in answers if a["proof"] is None or a["verdict"] is None),
        "answers": answers,
        "picks": picks,
        "judge_rng": traffic.rng(ctx.seed, "judge"),
        "peak": max(r["peak"] for r in ranks),
        "trace_path": ctx.run_dir / "trace.json",
        "counters": counters,
        "traced_proofs": lead["traced_proofs"],
    }
