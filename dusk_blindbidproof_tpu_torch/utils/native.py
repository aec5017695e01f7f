"""ctypes binding to the native host transcript core (native/strobe.cc).

The STROBE duplex under the Merlin transcript is a small C++ shared library,
`native/libbbnative.so`, shipped in the repository root.  This module loads
it as it is; only if that fails is the library compiled with g++ into
`build/native/` (never over the shipped copy) and loaded from there.  If
neither loads, importing this module raises: the port has no other
transcript core.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_ROOT, "native", "strobe.cc")
_SHIPPED = os.path.join(_ROOT, "native", "libbbnative.so")
_BUILT = os.path.join(_ROOT, "build", "native", "libbbnative.so")


class CStrobeState(ctypes.Structure):
    # must match `struct Strobe128` in native/strobe.cc
    _fields_ = [
        ("state", ctypes.c_uint8 * 200),
        ("pos", ctypes.c_uint8),
        ("pos_begin", ctypes.c_uint8),
        ("cur_flags", ctypes.c_uint8),
    ]


def _load() -> ctypes.CDLL:
    """The shipped library, else one built from its source; raises
    RuntimeError with both causes when neither loads."""
    try:
        lib = ctypes.CDLL(_SHIPPED)
    except OSError as shipped:
        try:
            os.makedirs(os.path.dirname(_BUILT), exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", _BUILT, _SRC],
                check=True,
                capture_output=True,
                timeout=120,
            )
            lib = ctypes.CDLL(_BUILT)
        except (OSError, subprocess.SubprocessError) as built:
            raise RuntimeError(
                f"native transcript core unavailable: {_SHIPPED}: {shipped}; "
                f"building {_SRC}: {built}"
            ) from built
    lib.bb_strobe_init.argtypes = [
        ctypes.POINTER(CStrobeState), ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.bb_strobe_init.restype = None
    for name in ("bb_strobe_meta_ad", "bb_strobe_ad", "bb_strobe_key", "bb_strobe_prf"):
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.POINTER(CStrobeState), ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_int,
        ]
        fn.restype = ctypes.c_int
    return lib


LIB = _load()


class NativeStrobe128:
    """The STROBE-128 duplex exactly as merlin 1.3.0 implements it, backed
    by the C++ core: the subset of STROBE ops merlin uses."""

    __slots__ = ("c",)

    def __init__(self, protocol_label: bytes):
        self.c = CStrobeState()
        LIB.bb_strobe_init(
            ctypes.byref(self.c), protocol_label, len(protocol_label)
        )

    def _check(self, rc: int) -> None:
        if rc == -1:
            raise ValueError("continued op with changed flags")
        if rc:
            raise ValueError("strobe op failed")

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._check(LIB.bb_strobe_meta_ad(
            ctypes.byref(self.c), data, len(data), int(more)))

    def ad(self, data: bytes, more: bool) -> None:
        self._check(LIB.bb_strobe_ad(
            ctypes.byref(self.c), data, len(data), int(more)))

    def prf(self, n: int, more: bool) -> bytes:
        out = ctypes.create_string_buffer(n)
        self._check(LIB.bb_strobe_prf(
            ctypes.byref(self.c), out, n, int(more)))
        return out.raw

    def key(self, data: bytes, more: bool) -> None:
        self._check(LIB.bb_strobe_key(
            ctypes.byref(self.c), data, len(data), int(more)))

    def clone(self) -> "NativeStrobe128":
        s = NativeStrobe128.__new__(NativeStrobe128)
        s.c = CStrobeState()
        ctypes.memmove(
            ctypes.byref(s.c), ctypes.byref(self.c), ctypes.sizeof(CStrobeState)
        )
        return s
