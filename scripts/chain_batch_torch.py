"""Peak device memory and s/op of the generic R1CS path at n = cap = 2^16,
batch size by batch size.

    python3 scripts/chain_batch_torch.py [--batches 4,8,16] [--out chiprun_out/chain_batch.json]

Builds the chain circuit of benchmarks/ipa_bench.py:47-69 with the port
(`chip_smoke.chain_inputs`) and the generator tables of capacity n = 2^16
(`chip_smoke.CHAIN_LARGE`), then for each batch size in the order given: one
warm-up prove+verify round trip and one timed, with
torch.cuda.max_memory_allocated() over both.  A batch that
does not fit the card (torch.OutOfMemoryError) is recorded and ends the run:
the larger ones are not tried.  Needs a CUDA card; the numbers are that
card's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the chain circuit and its prove / verify calls)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="4,8,16")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "chain_batch.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")

    from dusk_blindbidproof_tpu_torch.models.bulletproofs import (
        CompiledCircuit, generator_tables,
    )

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    n = chip_smoke.CHAIN_LARGE
    t0 = time.perf_counter()
    artifact, *wit = chip_smoke.chain_inputs(n)
    circuit = CompiledCircuit.compile(artifact, dev)
    generator_tables(n, dev)
    torch.cuda.synchronize()
    summary = {"card": card, "n": n, "setup_s": time.perf_counter() - t0,
               "tables_gb": torch.cuda.memory_allocated() / 1e9, "batches": []}
    print(f"card: {card}; n = cap = {n}: circuit and tables in {summary['setup_s']:.2f} s, "
          f"{summary['tables_gb']:.3f} GB allocated", flush=True)

    for B in (int(b) for b in args.batches.split(",")):
        witness = chip_smoke.chain_witness(n, B, *wit)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        row = {"batch": B}
        try:
            trips = []
            for _ in range(2):
                t0 = time.perf_counter()
                commitments, proofs = chip_smoke.chain_prove(circuit, witness, n, dev)
                oks = chip_smoke.chain_verify(circuit, commitments, proofs, n, dev)
                torch.cuda.synchronize()
                trips.append(time.perf_counter() - t0)
                if oks != [True] * B:
                    sys.exit(f"B = {B}: verify gave {oks}")
                del commitments, proofs
            row.update(fits=True, warm_s=trips[0], s_per_op=trips[1] / B)
        except torch.OutOfMemoryError as exc:
            row.update(fits=False, error=str(exc).splitlines()[0])
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        summary["batches"].append(row)
        print(json.dumps(row), flush=True)
        if not row["fits"]:
            break
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
