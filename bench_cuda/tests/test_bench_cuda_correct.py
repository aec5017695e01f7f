"""`correct` holds for the timed path and fails for the control and the faults.

On the CPU these run a throwaway cell, `chain-tiny.batch2`: the port's
generic prover and verifier on the squaring chain at n = cap = 16, B = 2,
through the same driver, judge and result line as the benchmark's cells.
The cell's files are written to a temporary folder that the harness
searches before its own, which also shows that a cell and a configuration
are added by adding files.  Each run is a process of its own, so a planted
fault ends with it.

The `cuda` cases run the control and the faults on the chip, at the
benchmark's own cells and sizes (`python -m pytest bench_cuda/tests -m cuda`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench_cuda import faults

ROOT = Path(__file__).resolve().parents[2]
CONFIG = {"name": "chain-tiny", "circuit": "chain", "n_pad": 16, "gens_capacity": 16,
          "reduced": ["n_pad", "gens_capacity"]}
CELL = {"config": "chain-tiny", "chips": 1, "driver": "batch_closed",
        "traffic": {"batch": 2, "sample": 2, "trace_trips": 1},
        "end_to_end": ["proofs_per_s", "setup_s"]}
BENCH = {"end_to_end": [{"name": "proofs_per_s", "unit": "proofs/s"},
                        {"name": "setup_s", "unit": "s"}],
         "per_layer": [{"name": "prover.host_ms.batch", "unit": "ms/proof",
                        "moves": "proofs_per_s", "workloads": ["chain-tiny.batch2"]}]}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("cells")
    (root / "configs").mkdir()
    (root / "cells").mkdir()
    (root / "configs" / "chain-tiny.json").write_text(json.dumps(CONFIG))
    (root / "cells" / "chain-tiny.batch2.json").write_text(json.dumps(CELL))
    (root / "BENCHMARK.json").write_text(json.dumps(BENCH))
    return root


def run_cpu(root: Path, *args: str) -> dict:
    code = (
        "import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]);"
        "from bench_cuda import run, harness;"
        "root = Path(sys.argv[2]);"
        "sys.exit(run.main(sys.argv[3:], device='cpu', roots=(root, harness.HERE),"
        " benchmark_path=root / 'BENCHMARK.json'))"
    )
    argv = ["--workload", "chain-tiny.batch2", "--seed", "3000000001", "--seconds", "1"]
    env = dict(os.environ, BENCH_RUN="ignored", OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code, str(ROOT), str(root), *argv, *args],
                       capture_output=True, text=True, timeout=900, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_throwaway_cell_runs_and_is_correct(tiny):
    out = run_cpu(tiny, "--trace", "0")
    assert out["correct"] is True, out
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"proofs_per_s", "setup_s"}
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_the_traced_run_reports_the_per_layer_metrics(tiny):
    out = run_cpu(tiny, "--trace", "1")
    assert out["correct"] is True, out
    assert set(out["metrics"]) == {"prover.host_ms.batch"}
    assert out["metrics"]["prover.host_ms.batch"]["value"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_the_control_and_every_fault_come_out_not_correct(tiny, fault):
    out = run_cpu(tiny, "--trace", "0", "--fault", fault)
    assert out["correct"] is False, out
    failing = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert failing, out
    if fault == "fixed_blinding":
        # every proof still verifies: the verdicts alone cannot see this fault
        assert failing == {"ref_bytes_differ"}, out


CHIP_CELLS = ("blindbid-L4.batch256", "r1cs-chain-2p16.batch16")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CHIP_CELLS)
def test_on_the_chip_the_control_and_faults_fail_at_the_cells_own_size(cell, fault):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's kernels")
    p = subprocess.run([sys.executable, str(ROOT / "bench_cuda" / "run.py"),
                        "--workload", cell, "--seed", "4000000007", "--seconds", "20",
                        "--trace", "0", "--fault", fault],
                       capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False
