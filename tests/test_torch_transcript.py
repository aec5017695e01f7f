"""The port's host transcript core (utils/native.py, utils/merlin.py).

  * the port's `Transcript`, its clone and its RNG give the bytes of the JAX
    package's pure-Python STROBE duplex over every op merlin uses, across
    rate boundaries;
  * the loader takes the shipped library; only where that fails to load
    does it build `native/strobe.cc`, and where that fails too it raises
    with both causes: there is no other core to fall back to.
"""

from __future__ import annotations

import subprocess

import pytest

from dusk_blindbidproof_tpu.utils.merlin import PyStrobe128
from dusk_blindbidproof_tpu.utils.merlin import Transcript as JaxTranscript
from dusk_blindbidproof_tpu_torch.utils import merlin, native

LABEL = b"BlindBidProofGadget"


def _python_transcript() -> JaxTranscript:
    t = JaxTranscript.__new__(JaxTranscript)
    t.strobe = PyStrobe128(JaxTranscript.MERLIN_PROTOCOL_LABEL)
    t.append_message(b"dom-sep", LABEL)
    return t


def _drive(t) -> list[bytes]:
    out = []
    for i in range(40):
        t.append_message(b"pt", bytes([i]) * (1 + 7 * i))  # crosses the rate
        t.append_u64(b"i", i)
        out.append(t.challenge_bytes(b"ch", 64))
    out.append(t.clone().challenge_bytes(b"post-clone", 33))
    rng = (t.build_rng()
           .rekey_with_witness_bytes(b"w", b"\x07" * 32)
           .rekey_with_witness_bytes(b"w2", bytes(range(200)))
           .finalize(b"\x01" * 32))
    out += [rng.fill_bytes(96), rng.fill_bytes(400)]
    out.append(t.challenge_bytes(b"after-rng", 32))
    return out


def test_transcript_matches_the_python_duplex():
    t = merlin.Transcript(LABEL)
    assert isinstance(t.strobe, native.NativeStrobe128)
    assert _drive(t) == _drive(_python_transcript())


def test_loader_builds_from_source_when_the_shipped_library_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_SHIPPED", str(tmp_path / "missing.so"))
    monkeypatch.setattr(native, "_BUILT", str(tmp_path / "build" / "libbbnative.so"))
    monkeypatch.setattr(native, "LIB", native._load())
    assert (tmp_path / "build" / "libbbnative.so").exists()
    assert _drive(merlin.Transcript(LABEL)) == _drive(_python_transcript())


def test_loader_raises_when_neither_library_loads(monkeypatch, tmp_path):
    def no_compiler(cmd, **kwargs):
        raise subprocess.CalledProcessError(1, cmd, stderr=b"g++: not here")

    monkeypatch.setattr(native, "_SHIPPED", str(tmp_path / "missing.so"))
    monkeypatch.setattr(native, "_BUILT", str(tmp_path / "build" / "libbbnative.so"))
    monkeypatch.setattr(subprocess, "run", no_compiler)
    with pytest.raises(RuntimeError, match="native transcript core unavailable") as err:
        native._load()
    assert "missing.so" in str(err.value) and "non-zero exit status 1" in str(err.value)
