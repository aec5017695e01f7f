"""The port stands alone: no module of dusk_blindbidproof_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package, and its CUDA entry points
raise on a machine without a GPU instead of falling back to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dusk_blindbidproof_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dusk_blindbidproof_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    assert not _imported(path) & set(FORBIDDEN)


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where importing jax or
    the JAX package fails."""
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in sorted(PORT.rglob("*.py"))
    ]
    code = (
        "import sys, importlib\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
        + f"for m in {modules!r}:\n    importlib.import_module(m)\n"
        + "import runpy; runpy.run_path('chip_smoke.py', run_name='imported')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from dusk_blindbidproof_tpu_torch.models.bulletproofs import Verifier, resolve_device
    from dusk_blindbidproof_tpu_torch.ops import fused, limb

    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Verifier([], cap=8)
    assert resolve_device("cpu") == torch.device("cpu")
    # CPU tensors take the plain version and launch nothing
    before = fused.launch_counts()
    x = torch.ones((2, limb.NLIMBS), dtype=torch.int32)
    fused.mul_rows(limb.FP, x, x)
    assert fused.launch_counts() == before
