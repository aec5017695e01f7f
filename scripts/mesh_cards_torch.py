"""The mesh with one card a rank: `chip_smoke.py`'s BlindBid round trip at
list length 4, --ranks ranks over NCCL (the backend `parallel.mesh.spawn`
picks when every rank has a card of its own).  At --batch 256 it is BASELINE
config 4: 256 independent bids sharded over one host's cards.

First, in this process, whose current card stays cuda:0: the same 16
requests proved with device=cuda:k on every card k, each digest equal to
cuda:0's (every kernel launched on its operands' card, not the current one).
Then the unsharded batch on the first rank's device (its digests, and the
direct s/op of the same trips); then every rank proves and verifies the batch
at bids x points = ranks x 1 and ranks/2 x 2: every proof's digest must equal
the unsharded one's, all must verify, a wrong seed must be rejected in its own
place; then sharded_msm over 64 points at 1 x ranks against the host sum.
Prints the s/op of each layout beside the direct one, the start-up of the
ranks (each makes its generator tables on its own card) and every rank's
launches of one round trip; exits 0 only if all agree.

Usage:
    python scripts/mesh_cards_torch.py                              # 4 cards, B = 16
    python scripts/mesh_cards_torch.py --batch 256 --trips 2        # config 4
    python scripts/mesh_cards_torch.py --ranks 2                    # 2 cards
    python scripts/mesh_cards_torch.py --device cpu --batch 4 --trips 0
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (request builders and digests shared with the smoke run)

MSM_POINTS = 64
CARD_CHECK_BATCH = 16  # requests proved on every card from this process


def layouts(ranks: int) -> tuple:
    """bids x points: every rank on the bids axis, then half of them with two
    ranks a bids index splitting each MSM's items."""
    return (ranks, 1), (ranks // 2, 2)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def round_trip(reqs, dev, mesh=None):
    from dusk_blindbidproof_tpu_torch.models.blindbid import prove_batch, verify_batch

    where = {"mesh": mesh} if mesh is not None else {"device": dev}
    proofs = prove_batch(reqs, rng=np.random.default_rng(7), **where)
    oks = verify_batch(chip_smoke.verify_requests(reqs, proofs), **where)
    _sync(dev)
    return proofs, oks


def rank_job(dev, ranks: int, batch: int, trips: int, digests: list[str]) -> dict:
    """One rank (module level: the ranks import it by name).  Raises on any
    disagreement, which fails the job."""
    import torch.distributed as dist

    from dusk_blindbidproof_tpu_torch.models.blindbid import verify_batch
    from dusk_blindbidproof_tpu_torch.ops import edwards, fused, limb
    from dusk_blindbidproof_tpu_torch.parallel import mesh as pmesh
    from dusk_blindbidproof_tpu_torch.utils import curve_host as host

    out = {"entered": time.time(), "backend": dist.get_backend(), "device": str(dev)}
    reqs = chip_smoke.requests(batch)
    for bids, points in layouts(ranks):
        mesh = pmesh.make_mesh(bids=bids, points=points, device=dev)
        out.setdefault("ready", time.time())
        proofs, oks = round_trip(reqs, dev, mesh)
        if [chip_smoke.proof_digest(p) for p in proofs] != digests or oks != [True] * batch:
            raise AssertionError(f"{bids}x{points}: proofs differ from the unsharded ones, "
                                 f"or verify gave {oks}")
        bad = batch - 1
        vreqs = chip_smoke.verify_requests(reqs, proofs)
        vreqs[bad].seed += 1
        got = verify_batch(vreqs, mesh=mesh)
        if got != [i != bad for i in range(batch)]:
            raise AssertionError(f"{bids}x{points}: wrong seed at {bad} gave {got}")
        times = []
        for trip in range(trips):
            before = fused.launch_counts()
            dist.barrier()
            t0 = time.perf_counter()
            _, oks = round_trip(reqs, dev, mesh)
            dist.barrier()
            times.append((time.perf_counter() - t0) / batch)
            if oks != [True] * batch:
                raise AssertionError(f"{bids}x{points}: a timed round trip gave {oks}")
            if trip == 0:
                after = fused.launch_counts()
                out[f"launches {bids}x{points}"] = {k: after[k] - before[k] for k in after}
        out[f"s_per_op {bids}x{points}"] = times

    mesh = pmesh.make_mesh(bids=1, points=ranks, device=dev)
    gen = np.random.default_rng(11)
    ks = [int.from_bytes(gen.bytes(32), "little") % host.L for _ in range(2 * MSM_POINTS)]
    pts = [host.ED25519_BASEPOINT.scalar_mul(k) for k in ks[:MSM_POINTS]]
    got = pmesh.sharded_msm(mesh, edwards.from_host(pts, device=dev),
                            torch.from_numpy(limb.ints_to_limbs(ks[MSM_POINTS:])).to(dev))
    want = host.EdwardsPoint.identity()
    for p, k in zip(pts, ks[MSM_POINTS:]):
        want = want + p.scalar_mul(k)
    if not pmesh._same_point(edwards.to_host(got)[0], want):
        raise AssertionError(f"sharded_msm over {MSM_POINTS} points != host sum")
    return out


def card_check() -> None:
    """The same CARD_CHECK_BATCH requests proved with device=cuda:k on every
    card k from this process, whose current card stays cuda:0: every digest
    must equal cuda:0's.  Raises otherwise."""
    from dusk_blindbidproof_tpu_torch.models.blindbid import prove_batch

    reqs = chip_smoke.requests(CARD_CHECK_BATCH)
    torch.cuda.set_device(0)
    want = None
    for k in range(torch.cuda.device_count()):
        dev = torch.device("cuda", k)
        t0 = time.perf_counter()
        proofs = prove_batch(reqs, rng=np.random.default_rng(7), device=dev)
        torch.cuda.synchronize(dev)
        got = [chip_smoke.proof_digest(p) for p in proofs]
        want = want or got
        if got != want or torch.cuda.current_device() != 0:
            raise AssertionError(f"{dev}: proofs differ from cuda:0's, or the current card "
                                 f"moved to {torch.cuda.current_device()}")
        print(f"card check: {CARD_CHECK_BATCH} proofs on {dev} (current card cuda:0) equal "
              f"cuda:0's (digests sha256 {hashlib.sha256(''.join(got).encode()).hexdigest()}), "
              f"{time.perf_counter() - t0:.2f} s incl. its tables", flush=True)
        del proofs
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    from dusk_blindbidproof_tpu_torch.parallel import mesh as pmesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda': one card a rank; 'cuda:0': ranks share it; 'cpu'")
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks, an even number (with 'cuda', one card each)")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--trips", type=int, default=3, help="timed round trips a layout")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    if args.ranks < 2 or args.ranks % 2:
        ap.error("--ranks takes an even number >= 2")

    ref_dev = pmesh.mesh_device(args.device, 0)
    if ref_dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
        print(f"cards ({torch.cuda.device_count()}):\n{card}", flush=True)
        card_check()
    else:
        print("card check: no card (the ranks run on the CPU)", flush=True)
    backend = pmesh.default_backend(args.device, args.ranks)
    reqs = chip_smoke.requests(args.batch)
    proofs, oks = round_trip(reqs, ref_dev)  # warm-up and the reference digests
    if oks != [True] * args.batch:
        print(f"FAIL: the unsharded batch gave {oks}")
        return 1
    digests = [chip_smoke.proof_digest(p) for p in proofs]
    direct = []
    for _ in range(args.trips):
        t0 = time.perf_counter()
        round_trip(reqs, ref_dev)
        direct.append((time.perf_counter() - t0) / args.batch)
    print(f"direct on {ref_dev}: s/op {direct}", flush=True)
    del proofs
    if ref_dev.type == "cuda":
        torch.cuda.empty_cache()  # the ranks share this card with this process

    t0 = time.time()
    ranks = pmesh.spawn(rank_job, args.ranks, device=args.device,
                        args=(args.ranks, args.batch, args.trips, digests), timeout=args.timeout)
    summary = {
        "ranks": args.ranks, "device": args.device, "backend": backend, "batch": args.batch,
        "rank_devices": [r["device"] for r in ranks],
        "startup_s": max(r["entered"] for r in ranks) - t0,
        "first_mesh_s": max(r["ready"] for r in ranks) - t0, "job_s": time.time() - t0,
        "direct_device": str(ref_dev), "direct_s_per_op": direct,
    }
    names = []
    for bids, points in layouts(args.ranks):
        key = f"{bids}x{points}"
        names.append(key)
        summary[f"s_per_op {key}"] = ranks[0][f"s_per_op {key}"]
        summary[f"launches {key}"] = [r.get(f"launches {key}") for r in ranks]
    print(f"all {args.batch} proofs equal the unsharded ones at {' and '.join(names)}, all "
          f"verify, a wrong seed is rejected in its own place; sharded_msm over {MSM_POINTS} "
          f"points at 1x{args.ranks} equals the host sum", flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
