"""Where the time of one B = 16 BlindBid round trip goes on the GPU.

    python3 scripts/profile_port.py [--batch 16] [--out chiprun_out/profile_port.json]

Runs one warm-up prove+verify round trip of the PyTorch port, then one under
torch.profiler (CPU and CUDA activities).  Prints the kernels by device time
(the 25 largest, then every hand-written kernel), the device-busy share of
the profiled wall time, and writes all of it as JSON.
Needs a CUDA card; the numbers come from that card only.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (request builders shared with the smoke run)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile_port.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")

    from dusk_blindbidproof_tpu_torch.models.blindbid import prove_batch, verify_batch

    dev = torch.device("cuda", 0)
    reqs = chip_smoke.requests(args.batch)

    def round_trip():
        proofs = prove_batch(reqs, rng=np.random.default_rng(7), device=dev)
        oks = verify_batch(chip_smoke.verify_requests(reqs, proofs), device=dev)
        torch.cuda.synchronize()
        if oks != [True] * args.batch:
            sys.exit("round trip did not verify")

    round_trip()
    rows, wall = chip_smoke.profiled(round_trip)
    busy_ms = sum(r["device_ms"] for r in rows)
    # the hand-written kernels, however small their share
    own = [r for r in rows if any(k in r["name"] for k in chip_smoke.OWN_KERNELS)]
    summary = {
        "card": torch.cuda.get_device_name(0),
        "batch": args.batch,
        "wall_s_profiled": wall,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall * 1e3) if rows else None,
        "kernels": rows[:25],
        "own_kernels": own,
    }
    print(f"profiled round trip: {wall:.4f} s wall, device busy {busy_ms:.1f} ms "
          f"({summary['device_busy_share']})")
    for r in rows[:25]:
        print(f"{r['device_ms']:10.3f} ms  x{r['calls']:<6d} {r['name'][:90]}")
    print(f"the port's own kernels: {sum(r['device_ms'] for r in own):.3f} ms")
    for r in own:
        print(f"{r['device_ms']:10.3f} ms  x{r['calls']:<6d} {r['name'][:90]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
