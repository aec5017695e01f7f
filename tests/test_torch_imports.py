"""The port stands alone: no module of dusk_blindbidproof_tpu_torch, and
neither chip_smoke.py nor the port's scripts (scripts/*_torch.py,
scripts/*-torch.sh), imports jax or the JAX package, and its CUDA entry points
(the server's included) raise on a machine without a GPU instead of falling
back to the CPU.  The port's copy of the pure-Python host oracle gives the JAX
package's bytes and verdicts."""

import ast
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dusk_blindbidproof_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dusk_blindbidproof_tpu")


SCRIPTS = sorted((ROOT / "scripts").glob("*_torch.py"))
SHELL_SCRIPTS = sorted((ROOT / "scripts").glob("*-torch.sh"))


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + SCRIPTS


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
        + "".join(f"runpy.run_path({str(p.relative_to(ROOT))!r}, run_name='imported')\n"
                  for p in SCRIPTS)
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", SHELL_SCRIPTS, ids=lambda p: p.name)
def test_shell_script_runs_the_port(path):
    """The port's server and client, never the JAX package's."""
    text = path.read_text()
    assert "python -m dusk_blindbidproof_tpu_torch.server" in text
    assert "scripts/uds_client_torch.py" in text
    assert "dusk_blindbidproof_tpu.server" not in text and "uds_client.py" not in text


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


def test_server_entry_point_exits_without_gpu():
    """`python -m dusk_blindbidproof_tpu_torch.server` with no --device: the
    error of `resolve_device`, a non-zero exit, and no socket."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bb.sock")
        proc = subprocess.run(
            [sys.executable, "-m", "dusk_blindbidproof_tpu_torch.server", "--bind-path", path],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr
        assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# The two copies of the host oracle on the CAP = 8 cube proof
# ---------------------------------------------------------------------------


def _cube(package):
    """(artifact, Transcript class, host_oracle module, R1CSProof) of a package."""
    import importlib

    r1cs = importlib.import_module(f"{package}.models.r1cs")
    cs = r1cs.VerifierCS()
    a = cs.commit_var()
    pub = cs.public_var()
    _, _, o = cs.multiply(r1cs.LC.of(a), r1cs.LC.of(a))
    _, _, o2 = cs.multiply(r1cs.LC.of(o), r1cs.LC.of(a))
    cs.constrain(r1cs.LC.of(o2) - pub)
    return (cs.artifact(),
            importlib.import_module(f"{package}.utils.merlin").Transcript,
            importlib.import_module(f"{package}.utils.host_oracle"),
            importlib.import_module(f"{package}.models.proof_struct").R1CSProof)


def _cube_prove(package):
    from test_transcript_protocol import A_VAL, BLIND, CAP, LABEL, cube_inputs

    artifact, transcript, oracle, _ = _cube(package)
    a2, a3 = cube_inputs()
    return oracle.host_prove(artifact, transcript(LABEL), [A_VAL], [BLIND], [A_VAL, a2],
                             [A_VAL, A_VAL], [a2, a3], [a3], CAP)


def test_host_oracle_copies_give_the_same_proof():
    from test_transcript_protocol import FROZEN_PROOF, FROZEN_V

    (ours, our_trace), (theirs, their_trace) = (
        _cube_prove("dusk_blindbidproof_tpu_torch"), _cube_prove("dusk_blindbidproof_tpu"))
    assert ours.to_bytes() == theirs.to_bytes()
    assert ours.to_bytes().hex() == FROZEN_PROOF
    assert our_trace.commitments[0].hex() == FROZEN_V
    assert vars(our_trace) == vars(their_trace)


@pytest.mark.parametrize("bump", [0, 1], ids=["honest", "wrong-public"])
def test_host_oracle_copies_give_the_same_verdict(bump):
    from test_transcript_protocol import CAP, FROZEN_PROOF, FROZEN_V, LABEL, cube_inputs

    verdicts = []
    for package in ("dusk_blindbidproof_tpu_torch", "dusk_blindbidproof_tpu"):
        artifact, transcript, oracle, proof_cls = _cube(package)
        proof = proof_cls.from_bytes(bytes.fromhex(FROZEN_PROOF))
        verdicts.append(oracle.host_verify(artifact, transcript(LABEL), proof,
                                           [bytes.fromhex(FROZEN_V)],
                                           [cube_inputs()[1] + bump], CAP))
    assert verdicts == [bump == 0] * 2
