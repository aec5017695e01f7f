"""The port's scripts, run as a user runs them, on the CPU:

  * scripts/oracle_compare_torch.py 8 --device cpu: the tensor prover and the
    port's host oracle agree, the 2 x 2 verification matrix is all True,
    "ALL OK", exit 0; with no --device it raises without a GPU;
  * scripts/test-uds-torch.sh and scripts/bench-uds-torch.sh: without a GPU
    the server exits at boot, and so does the script, non-zero, with
    "server died at boot";
  * scripts/record_session_torch.py: refuses to write into tests/data; with
    no --device it raises without a GPU; slow: --device cpu gives the frozen
    session bytes in its --out directory and leaves tests/data as it was;
  * scripts/mesh_cards_torch.py: an odd --ranks is refused; slow: 4 and 2
    gloo ranks on the CPU at B = 4.

Tolerance: none; exit codes, printed verdicts and bytes.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
SESSIONS = ("session_prove.bin", "session_verify.bin")


def _run(args, timeout):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(args, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                          env=env)


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")


def test_oracle_compare_cpu_all_ok():
    proc = _run([sys.executable, "scripts/oracle_compare_torch.py", "8", "--device", "cpu"], 300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "prover intermediates: all equal" in proc.stdout
    assert "RESULT: ALL OK" in proc.stdout


def test_oracle_compare_default_device_raises_without_gpu():
    _no_gpu()
    proc = _run([sys.executable, "scripts/oracle_compare_torch.py", "8"], 120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "ALL OK" not in proc.stdout


@pytest.mark.parametrize("script", ["test-uds-torch.sh", "bench-uds-torch.sh"])
def test_uds_script_fails_at_boot_without_gpu(script):
    _no_gpu()
    proc = _run(["bash", f"scripts/{script}"], 60)
    assert proc.returncode != 0
    assert "server died at boot" in proc.stderr
    assert "no CUDA device" in proc.stderr


def test_record_session_refuses_tests_data():
    before = {name: (DATA / name).read_bytes() for name in SESSIONS}
    proc = _run([sys.executable, "scripts/record_session_torch.py", "--device", "cpu",
                 "--out", "tests/data"], 120)
    assert proc.returncode != 0
    assert "must not be tests/data" in proc.stderr
    assert {name: (DATA / name).read_bytes() for name in SESSIONS} == before


def test_record_session_default_device_raises_without_gpu(tmp_path):
    _no_gpu()
    proc = _run([sys.executable, "scripts/record_session_torch.py", "--out", str(tmp_path)], 120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not list(tmp_path.iterdir())


@pytest.mark.slow
def test_record_session_cpu_gives_frozen_bytes(tmp_path):
    before = {name: (DATA / name).stat() for name in SESSIONS}
    proc = _run([sys.executable, "scripts/record_session_torch.py", "--device", "cpu",
                 "--out", str(tmp_path)], 1800)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in SESSIONS:
        assert (tmp_path / name).read_bytes() == (DATA / name).read_bytes()
        after = (DATA / name).stat()
        assert (after.st_mtime_ns, after.st_size) == (before[name].st_mtime_ns,
                                                      before[name].st_size)


@pytest.mark.slow
@pytest.mark.parametrize("ranks, layouts", [(4, ("4x1", "2x2")), (2, ("2x1", "1x2"))])
def test_mesh_cards_script_on_cpu_ranks(ranks, layouts):
    proc = _run([sys.executable, "scripts/mesh_cards_torch.py", "--device", "cpu",
                 "--ranks", str(ranks), "--batch", "4", "--trips", "0"], 3600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"backend": "gloo"' in proc.stdout
    assert f'"ranks": {ranks}' in proc.stdout
    assert f"equal the unsharded ones at {layouts[0]} and {layouts[1]}" in proc.stdout
    assert f"at 1x{ranks} equals the host sum" in proc.stdout


def test_mesh_cards_script_refuses_an_odd_rank_count():
    proc = _run([sys.executable, "scripts/mesh_cards_torch.py", "--device", "cpu",
                 "--ranks", "3"], 120)
    assert proc.returncode == 2
    assert "--ranks takes an even number" in proc.stderr
