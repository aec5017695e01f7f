"""The `mesh_closed` driver: `correct` holds on a mesh of ranks, the traced
run reports the mesh's per-layer metrics, and the control and the faults
come out not correct.

On the CPU these run a throwaway cell, `chain-tiny.mesh4x1-6`: the port's
generic prover and verifier with `mesh=` on the squaring chain at n = cap =
16, B = 6 over 4 gloo ranks (rows 2, 2, 1 and 1), through the same driver,
judge and result line as the benchmark's four-card cell.  The cell's files
are written to a temporary folder that the harness searches before its own,
as in test_bench_cuda_correct.py.  Each run is a process of its own, whose
ranks are processes of their own, so a planted fault ends with them.

The `cuda` cases run the control and the faults on four cards, at the
benchmark's own cell and size (`python -m pytest bench_cuda/tests -m cuda`).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench_cuda import faults

ROOT = Path(__file__).resolve().parents[2]
CELL_NAME = "chain-tiny.mesh4x1-6"
CONFIG = {"name": "chain-tiny", "circuit": "chain", "n_pad": 16, "gens_capacity": 16,
          "mesh": {"bids": 4, "points": 1, "backend": "nccl"},
          "reduced": ["n_pad", "gens_capacity"]}
CELL = {"config": "chain-tiny", "chips": 4, "driver": "mesh_closed",
        "traffic": {"batch": 6, "bids": 4, "points": 1, "sample": 3, "trace_trips": 1},
        "end_to_end": ["proofs_per_s", "setup_s"]}
MESH_METRICS = ("mesh.collective_ms.batch", "mesh.rank_skew.batch")
# rank 0's spans per proof of the whole batch; the trace's device metrics read
# nothing on the CPU
HOST_METRICS = ("prover.host_ms.batch", "limb.enqueue_ms.batch")
BENCH = {"end_to_end": [{"name": "proofs_per_s", "unit": "proofs/s"},
                        {"name": "setup_s", "unit": "s"}],
         "per_layer": [{"name": name, "unit": unit, "moves": "proofs_per_s",
                        "workloads": [CELL_NAME]}
                       for name, unit in zip(MESH_METRICS + HOST_METRICS,
                                             ("ms/proof", "%", "ms/proof", "ms/proof"))]}


def write_cell(root: Path, name: str, cell: dict) -> None:
    (root / "configs").mkdir(exist_ok=True)
    (root / "cells").mkdir(exist_ok=True)
    (root / "configs" / "chain-tiny.json").write_text(json.dumps(CONFIG))
    (root / "cells" / f"{name}.json").write_text(json.dumps(cell))
    (root / "BENCHMARK.json").write_text(json.dumps(BENCH))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("cells")
    write_cell(root, CELL_NAME, CELL)
    return root


def run_cpu(root: Path, *args: str, workload: str = CELL_NAME, ok: bool = True):
    code = (
        "import sys; from pathlib import Path; sys.path.insert(0, sys.argv[1]);"
        "from bench_cuda import run, harness;"
        "root = Path(sys.argv[2]);"
        "sys.exit(run.main(sys.argv[3:], device='cpu', roots=(root, harness.HERE),"
        " benchmark_path=root / 'BENCHMARK.json'))"
    )
    argv = ["--workload", workload, "--seed", "3000000001", "--seconds", "1"]
    env = dict(os.environ, BENCH_RUN="ignored", OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code, str(ROOT), str(root), *argv, *args],
                       capture_output=True, text=True, timeout=900, env=env)
    if not ok:
        return p
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_the_mesh_cell_runs_and_is_correct(tiny):
    out = run_cpu(tiny, "--trace", "0")
    assert out["correct"] is True, out
    assert set(out["metrics"]) == {"proofs_per_s", "setup_s"}
    assert out["failed"] == 0 and out["attempted"] >= 6 and out["attempted"] % 6 == 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_the_traced_mesh_run_reports_the_mesh_metrics(tiny):
    out = run_cpu(tiny, "--trace", "1")
    assert out["correct"] is True, out
    assert set(out["metrics"]) == set(MESH_METRICS + HOST_METRICS)
    values = {k: v["value"] for k, v in out["metrics"].items()}
    assert all(math.isfinite(v) for v in values.values()), values
    assert values["mesh.collective_ms.batch"] > 0
    assert all(values[name] > 0 for name in HOST_METRICS), values
    # rows 2, 2, 1, 1: rank 0 proves twice rank 3's rows
    assert values["mesh.rank_skew.batch"] >= 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_on_a_mesh_the_control_and_every_fault_come_out_not_correct(tiny, fault):
    out = run_cpu(tiny, "--trace", "0", "--fault", fault)
    assert out["correct"] is False, out
    failing = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert failing, out
    if fault == "fixed_blinding":
        # every proof still verifies: the verdicts alone cannot see this fault
        assert failing == {"ref_bytes_differ"}, out


def test_a_cell_whose_traffic_lays_out_another_mesh_fails_before_any_rank(tmp_path):
    """The configuration's `mesh` block is the layout's one source: a cell
    whose traffic names another ends non-zero, and no rank is started."""
    name = "chain-tiny.mesh2x2-6"
    write_cell(tmp_path, name, dict(CELL, traffic=dict(CELL["traffic"], bids=2, points=2)))
    p = run_cpu(tmp_path, "--trace", "0", workload=name, ok=False)
    assert p.returncode != 0
    assert "lays out 2 x 2 ranks, its configuration 4 x 1" in p.stderr
    assert "window" not in p.stderr


CHIP_CELL = "blindbid-L4-mesh4x1.batch256"


@pytest.mark.cuda
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_on_four_cards_the_control_and_faults_fail_at_the_cells_own_size(fault):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: the cell runs a card a rank")
    p = subprocess.run([sys.executable, str(ROOT / "bench_cuda" / "run.py"),
                        "--workload", CHIP_CELL, "--seed", "4000000007", "--seconds", "20",
                        "--trace", "0", "--fault", fault],
                       capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is False
