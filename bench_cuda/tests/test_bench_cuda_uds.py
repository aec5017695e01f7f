"""The served cell's control and faults on the chip:
`python -m pytest bench_cuda/tests/test_bench_cuda_uds.py -m cuda`.

Each run is the cell `blindbid-L4-uds.sessions64` at its own size, through
`run.py`, with one fault planted under the daemon (`bench_cuda/faults.py`);
each must end by itself, exit 0 and read `correct` false:

  accept_all   the altered sessions read 0x01: `verdict_wrong`;
  alter_proof  every proof the daemon answers is altered, so the honest
               sessions read 0x00: `verdict_wrong`;
  drop_half    a pass returns the first half of its proofs: the daemon
               answers the rest the error frame, `missing`.

`fixed_blinding` cannot show in this cell: the daemon draws its blindings
from its own entropy, as the upstream daemon's `thread_rng`, so the cell
re-proves nothing (`regenerate` 0) and a fixed draw gives proofs that still
verify.  The fault runs of the other cells show it.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELL = "blindbid-L4-uds.sessions64"
FAILS = {"accept_all": "verdict_wrong", "alter_proof": "verdict_wrong", "drop_half": "missing"}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAILS))
def test_on_the_chip_each_fault_makes_the_served_cell_not_correct(fault):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the daemon's passes run the port's kernels")
    p = subprocess.run([sys.executable, str(ROOT / "bench_cuda" / "run.py"),
                        "--workload", CELL, "--seed", "4000000011", "--seconds", "20",
                        "--trace", "0", "--fault", fault],
                       capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is False, out
    failing = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert FAILS[fault] in failing, out
