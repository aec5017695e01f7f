"""What every cell's run shares: finding its files by name, the statistics,
the reference's judgement of the proofs the timed path returned, and the
result line.

A cell is `cells/<name>.json`: its configuration's name, the chips it needs,
its driver (`drivers/<driver>.py`, which exports `run(ctx)`), the traffic
parameters the driver reads, and the end-to-end metrics it reports.  A
configuration is `configs/<name>.json`.  A per-layer metric is
`metrics/<name>.py`, which exports `read(record)` and returns None where the
traced record has nothing for it.  `BENCHMARK.json` says which per-layer
metrics a cell reports and in which units.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dusk_blindbidproof_tpu")


class Finder:
    """Finds `<kind>/<name>.json` and `<kind>/<name>.py` in the first of
    `roots` that has it."""

    def __init__(self, roots=(HERE,)):
        self.roots = [Path(r) for r in roots]

    def path(self, kind: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            path = root / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise SystemExit(f"no {kind[:-1]} named {name!r} under {self.roots}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        path = self.path(kind, name, ".py")
        key = f"bench_cuda_{kind}_{name}".replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX or of the JAX package, by whole top-level name."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def rate(count: int, start: float, end: float) -> float:
    return count / (end - start)


@dataclass
class Checks:
    """The numbers compared with the reference, each beside its limit."""

    rows: list = field(default_factory=list)

    def add(self, name: str, value: float, limit: float) -> None:
        self.rows.append((name, value, limit))

    @property
    def correct(self) -> bool:
        return bool(self.rows) and all(v <= lim for _, v, lim in self.rows)


def judge(checks: Checks, cap: int, answers: list, picks: list[int],
          gen: np.random.Generator, regenerate: int | None = None) -> None:
    """The reference's side of `correct`, on the answers the timed path gave.

    `answers[i]` is one proof the program returned and what the program's
    verifier said of it: a dict with `circuit` (the reference's circuit of its
    public inputs, made when called), `proof` (wire bytes, or None if it never
    came), `commitments`, `verdict` (the program's, or None), `tampered` (True
    for a proof the benchmark altered) and `rebuild` (made when called: the
    reference's circuit assigned with the statement's witness, the
    commitments' blindings and the prover's 32-byte seed, all as the
    benchmark handed them to the program).  Compared:

      missing           answers that never came (no proof, or no verdict);
      verdict_wrong     the program's verdict against what the proof is: an
                        honest proof refused, or an altered one accepted;
      ref_disagree      the reference's verdict on the sample (`picks`, drawn
                        from the seed) against the program's;
      ref_bytes_differ  honest proofs of the sample (the first `regenerate`
                        of them, or all) whose bytes or commitments are not
                        the ones the reference prover makes from the same
                        inputs (`reference.prove.check`).

    `gen` draws the weights of the reference's batched check.
    """
    from .reference import prove, verify

    missing = sum(1 for a in answers if a["proof"] is None or a["verdict"] is None)
    if not answers:
        missing = 1  # nothing was answered at all
    wrong = sum(1 for a in answers if a["verdict"] is not None
                and a["verdict"] == a["tampered"])
    sample = [answers[i] for i in picks
              if answers[i]["proof"] is not None and answers[i]["verdict"] is not None]
    honest = [(a["circuit"](), a) for a in sample if not a["tampered"]]
    differ, rebuilt = 0, []
    for a in [a for _, a in honest][:regenerate]:
        circuit, gammas, seed = a["rebuild"]()
        parts, product = prove.check(circuit, gammas, seed, a["proof"], a["commitments"],
                                     cap, gen)
        if parts:
            differ += 1
            print(f"reference: a proof differs from the reference prover's in {parts}",
                  file=sys.stderr)
        else:
            rebuilt.append(product)
    products = [lambda c=c, a=a: verify.terms(c, a["proof"], a["commitments"], cap)
                for c, a in honest]
    disagree = 0
    if products or rebuilt:
        if not verify.identity_many(products + [lambda p=p: p for p in rebuilt], cap, gen):
            # name the ones at fault, one by one
            disagree += sum(1 for c, a in honest
                            if verify.verify(c, a["proof"], a["commitments"], cap) != a["verdict"])
            differ += sum(1 for p in rebuilt
                          if not verify.identity_many([lambda p=p: p], cap, gen))
        else:
            disagree += sum(1 for _, a in honest if a["verdict"] is not True)
    for a in sample:
        if a["tampered"]:
            ok = verify.verify(a["circuit"](), a["proof"], a["commitments"], cap)
            disagree += int(ok != a["verdict"])
    checks.add("missing", missing, 0)
    checks.add("verdict_wrong", wrong, 0)
    checks.add("ref_disagree", disagree, 0)
    checks.add("ref_bytes_differ", differ, 0)


def device_info(chips: int, peak: int, trace: dict | None) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": int(peak)}
    if trace is not None:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = trace["window_s"]
    return out


def emit(checks: Checks, attempted: int, failed: int, metrics: dict, device: dict,
         breakdown: dict | None) -> None:
    """The result: the compared numbers as the last lines on standard error,
    then one JSON line, the last of standard output, with them under its last
    key."""
    for name, value, limit in checks.rows:
        print(f"check {name} = {value} (limit {limit})", file=sys.stderr, flush=True)
    out = {"correct": checks.correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks.rows}
    print(json.dumps(out), flush=True)
