"""Run one cell of the port's benchmark once.

    python3 bench_cuda/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `bench_cuda/cells/<cell>.json`; its driver sets up (kernels,
tables, circuit, one warm-up of the cell's own shapes), measures for
`--seconds`, and hands back what the timed path answered.  The plain
reference then judges a sample of those answers, and the last line of
standard output is the result (`harness.emit`).  With `--trace 1` a part of
the window runs under torch.profiler and the result carries the cell's
per-layer metrics and the trace's breakdown instead of its end-to-end ones.

Exits non-zero, with no result, without enough CUDA cards, without the port
beside this folder, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_cuda import harness, tracing  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None,
                    help="break the timed path underneath (bench_cuda/faults.py): the "
                         "control and fault runs that show `correct` can fail")
    return ap.parse_args(argv)


def metric_specs(benchmark: dict, cell_name: str, cell: dict, traced: bool) -> dict:
    """name -> unit of the metrics this run reports."""
    if not traced:
        units = {m["name"]: m["unit"] for m in benchmark["end_to_end"]}
        return {name: units[name] for name in cell["end_to_end"]}
    out = {}
    for m in benchmark["per_layer"]:
        cells = m.get("workloads")
        if (cell_name in cells) if cells is not None else (m["moves"] in cell["end_to_end"]):
            out[m["name"]] = m["unit"]
    return out


def main(argv=None, device=None, roots=(harness.HERE,), benchmark_path=None) -> int:
    """`device` and `roots` are for the CPU tests: a device other than CUDA
    skips the look for cards, and `roots` are searched for the cell's files
    before this folder."""
    args = parse(argv)
    find = harness.Finder(roots)
    cell = find.json("cells", args.workload)
    config = find.json("configs", cell["config"])
    benchmark = json.loads(Path(benchmark_path or ROOT / "BENCHMARK.json").read_text())
    try:
        import torch

        import dusk_blindbidproof_tpu_torch  # noqa: F401  the system under test
    except ImportError as exc:
        print(f"the port cannot be imported here: {exc}", file=sys.stderr)
        return 2
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"cell {args.workload} needs {cell['chips']} CUDA card(s), found {found}",
                  file=sys.stderr)
            return 3
        device = "cuda:0"

    run_dir = Path(tempfile.mkdtemp(prefix="bench_cuda."))
    ctx = SimpleNamespace(
        name=args.workload, cell=cell, config=config, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device=torch.device(device),
        fault=args.fault, t0=T0, root=ROOT, run_dir=run_dir,
        log=lambda msg: print(msg, file=sys.stderr, flush=True),
    )
    try:
        out = find.module("drivers", cell["driver"]).run(ctx)
        record = None
        if ctx.trace:
            record = tracing.summarize(out["trace_path"], out["counters"])
            record["proofs"] = out["traced_proofs"]
        checks = harness.Checks()
        t_ref = time.perf_counter()
        harness.judge(checks, config["gens_capacity"], out["answers"], out["picks"],
                      out["judge_rng"], cell["traffic"].get("regenerate"))
        ctx.log(f"reference {time.perf_counter() - t_ref:.3f} s")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    specs = metric_specs(benchmark, args.workload, cell, ctx.trace)
    metrics = {}
    for name, unit in specs.items():
        value = out["metrics"].get(name) if not ctx.trace else find.module(
            "metrics", name).read(record)
        if value is not None and math.isfinite(value):
            metrics[name] = {"value": value, "unit": unit}
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 4
    if ctx.device.type == "cuda":
        dev_info = harness.device_info(cell["chips"], out["peak"], record)
    else:
        dev_info = {"platform": ctx.device.type, "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
    breakdown = None
    if record is not None:
        breakdown = {"device_ops": [list(r) for r in record["device_ops"]],
                     "idle_gaps": [list(r) for r in record["idle_gaps"]]}
    harness.emit(checks, out["attempted"], out["failed"], metrics, dev_info, breakdown)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
