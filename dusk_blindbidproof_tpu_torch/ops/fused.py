"""Hand-written Hopper kernels for the limb engine's hot ops, and their
plain PyTorch versions.

Four kernels (csrc/edwards_kernels.cu over csrc/field25519.cuh) replace the
JAX package's four Pallas kernels:

    K1 mul_rows  a*b mod p or mod l on [..., 21] limb rows
    K2 madd      extended + affine-Niels point add (7M), the bucket-scan leaf
    K3 add       unified extended point add (9M)
    K4 double    extended point doubling (4M + 4S)

Every wrapper takes a CPU tensor to its plain version (`mul_rows_ref`,
`madd_ref`, `add_ref`, `double_ref`) and a CUDA tensor to its kernel, or
raises: nothing falls back from the kernel to the plain version.  A CUDA
wrapper checks device, dtype, shape and contiguity, allocates its output
with torch.empty, launches on the current stream, raises on the returned
cudaGetLastError() code, and adds one to its launch count.

Kernel inputs are limbs in [0, 8192] (any std-form or strict value);
kernel outputs are canonical (limbs < 2^13, value < M), which is a valid
std form for every consumer.  Raw limbs of the kernel and the plain path
differ; they agree after `limb.canon`.

The kernels are compiled with nvcc for sm_90a into build/kernels/ at first
use and bound with ctypes (plain C interface, no PyTorch headers).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from . import limb
from .limb import FL, FP, NLIMBS

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("edwards_kernels.cu", "field25519.cuh")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# one launch count per kernel entry point; K1 counts each modulus apart
KERNELS = ("mul_rows_fp", "mul_rows_fl", "madd", "add", "double")
LAUNCHES = {name: 0 for name in KERNELS}
BUILD_SECONDS = None  # wall time of this process's nvcc build, if it ran one
BUILD_LOG = ""  # nvcc's output of that build (ptxas registers and spills)

_LIB = None
_READY_DEVICES: set = set()


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path() -> Path:
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libbbkernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source's library is already built."""
    global BUILD_SECONDS, BUILD_LOG
    so = _library_path()
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / "edwards_kernels.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = proc.stdout + proc.stderr
    return so


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bb_init_constants.argtypes = [vp, ll, vp]
        lib.bb_mul_rows.argtypes = [ci, vp, vp, vp, ll, vp]
        lib.bb_point_add.argtypes = [vp, vp, vp, ll, vp]
        lib.bb_point_madd.argtypes = [vp, vp, vp, ll, vp]
        lib.bb_point_double.argtypes = [vp, vp, ll, vp]
        for fn in (lib.bb_init_constants, lib.bb_mul_rows, lib.bb_point_add,
                   lib.bb_point_madd, lib.bb_point_double):
            fn.restype = ci
        _LIB = lib
    return _LIB


def mod_constants(ctx: limb.ModContext) -> np.ndarray:
    """One `BbModConst` table (csrc/field25519.cuh) as int32 words."""
    bias_k = -(-(1 << (limb.LIMB_BITS * NLIMBS)) // ctx.modulus)
    sb_limb, sb_off = divmod(ctx.split_bit, limb.LIMB_BITS)
    return np.concatenate([
        ctx.fold_rows[:NLIMBS].reshape(-1),
        ctx.mod_limbs,
        ctx.canon_row,
        limb.int_to_limbs(bias_k * ctx.modulus, NLIMBS + 1),
        np.array([sb_limb, sb_off, int(ctx.canon_neg)]),
    ]).astype(np.int32)


def _ready(device: torch.device):
    """The bound library, with its constant tables uploaded to `device`."""
    lib = _lib()
    if device.index not in _READY_DEVICES:
        from .edwards import D2_LIMBS

        mods = np.ascontiguousarray(
            np.concatenate([mod_constants(FP), mod_constants(FL)])
        )
        d2 = np.ascontiguousarray(D2_LIMBS, dtype=np.int32)
        with torch.cuda.device(device):
            rc = lib.bb_init_constants(
                mods.ctypes.data, mods.size, d2.ctypes.data
            )
        if rc != 0:
            raise RuntimeError(f"bb_init_constants failed with code {rc}")
        _READY_DEVICES.add(device.index)
    return lib


def kernel_operands(*xs):
    """Broadcast CUDA operands to one shape and make them contiguous, the
    layout the kernels take; CPU tensors pass through unchanged (their plain
    versions broadcast)."""
    if not any(x.is_cuda for x in xs):
        return xs
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    return tuple(x.expand(shape).contiguous() for x in xs)


def _check(shape, *xs) -> None:
    """Raise unless every operand is what the kernels take: int32,
    contiguous, of `shape`, on one CUDA device."""
    dev = xs[0].device
    for x in xs:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"kernel operands must share one CUDA device, got {x.device}")
        if x.dtype != torch.int32:
            raise TypeError(f"kernel operands must be int32, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"kernel operand shape {tuple(x.shape)} != {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"kernel {name} failed to launch: cudaError {rc}")
    LAUNCHES[name] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# K1: modular product of limb rows
# ---------------------------------------------------------------------------


def mul_rows_ref(ctx: limb.ModContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: the bound-tracked schoolbook product (std form)."""
    return limb.lb_mul(ctx, limb.wrap(a), limb.wrap(b)).x


def mul_rows(ctx: limb.ModContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b mod M on [..., NLIMBS] rows: K1 for CUDA tensors (same shape,
    contiguous; canonical output), the plain version for CPU tensors."""
    if not (a.is_cuda or b.is_cuda):
        return mul_rows_ref(ctx, a, b)
    shape = a.shape
    if shape[-1:] != (NLIMBS,):
        raise ValueError(f"mul_rows takes [..., {NLIMBS}] limb rows, got {tuple(shape)}")
    _check(shape, a, b)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // NLIMBS
    if n:
        lib = _ready(a.device)
        mod = {"fp": 0, "fl": 1}[ctx.name]
        _launch(f"mul_rows_{ctx.name}", lib.bb_mul_rows, mod, a.data_ptr(),
                b.data_ptr(), out.data_ptr(), n, _stream(a.device))
    return out


# ---------------------------------------------------------------------------
# K2-K4: Edwards point ops on [..., 4, NLIMBS] rows (X, Y, Z, T)
# ---------------------------------------------------------------------------


def _fmul(a, b):
    return mul_rows_ref(FP, a, b)


def _finish(e, f, g, h):
    return torch.stack([_fmul(e, f), _fmul(g, h), _fmul(f, g), _fmul(e, h)], dim=-2)


def add_ref(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: add-2008-hwcd-3 with a = -1 and the 2d constant
    (9M), complete, so safe for P+P, identity and mixed inputs."""
    from .edwards import D2_LIMBS

    x1, y1, z1, t1 = p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]
    x2, y2, z2, t2 = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    d2 = limb.const(D2_LIMBS, p.device)
    a = _fmul(limb.sub(FP, y1, x1), limb.sub(FP, y2, x2))
    b = _fmul(limb.add(FP, y1, x1), limb.add(FP, y2, x2))
    c = _fmul(_fmul(t1, d2), t2)
    dd = _fmul(limb.add(FP, z1, z1), z2)
    return _finish(
        limb.sub(FP, b, a), limb.sub(FP, dd, c),
        limb.add(FP, dd, c), limb.add(FP, b, a),
    )


def madd_ref(p: torch.Tensor, q_niels: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: p extended + q affine-Niels (y-x, y+x, 2d*xy),
    madd-2008-hwcd-3 (7M)."""
    x1, y1, z1, t1 = p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]
    a2, b2, c2 = q_niels[..., 0, :], q_niels[..., 1, :], q_niels[..., 2, :]
    a = _fmul(limb.sub(FP, y1, x1), a2)
    b = _fmul(limb.add(FP, y1, x1), b2)
    c = _fmul(t1, c2)
    dd = limb.add(FP, z1, z1)
    return _finish(
        limb.sub(FP, b, a), limb.sub(FP, dd, c),
        limb.add(FP, dd, c), limb.add(FP, b, a),
    )


def double_ref(p: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: dbl-2008-hwcd with a = -1 (4M + 4S)."""
    x1, y1, z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    a = _fmul(x1, x1)
    b = _fmul(y1, y1)
    zz = _fmul(z1, z1)
    c = limb.add(FP, zz, zz)
    h = limb.add(FP, a, b)
    xy = limb.add(FP, x1, y1)
    e = limb.sub(FP, h, _fmul(xy, xy))
    g = limb.sub(FP, a, b)
    f = limb.add(FP, c, g)
    return _finish(e, f, g, h)


def _point_op(name: str, fn_name: str, *xs) -> torch.Tensor:
    shape = xs[0].shape
    if tuple(shape[-2:]) != (4, NLIMBS):
        raise ValueError(f"point ops take [..., 4, {NLIMBS}] rows, got {tuple(shape)}")
    _check(shape, *xs)
    out = torch.empty(shape, dtype=torch.int32, device=xs[0].device)
    n = out.numel() // (4 * NLIMBS)
    if n:
        lib = _ready(out.device)
        ptrs = [x.data_ptr() for x in xs]
        _launch(name, getattr(lib, fn_name), *ptrs, out.data_ptr(), n,
                _stream(out.device))
    return out


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA tensors (same shape, contiguous), `add_ref` on CPU tensors."""
    if not (p.is_cuda or q.is_cuda):
        return add_ref(p, q)
    return _point_op("add", "bb_point_add", p, q)


def madd(p: torch.Tensor, q_niels: torch.Tensor) -> torch.Tensor:
    """K2 on CUDA tensors, `madd_ref` on CPU tensors."""
    if not (p.is_cuda or q_niels.is_cuda):
        return madd_ref(p, q_niels)
    return _point_op("madd", "bb_point_madd", p, q_niels)


def double(p: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA tensors, `double_ref` on CPU tensors."""
    if not p.is_cuda:
        return double_ref(p)
    return _point_op("double", "bb_point_double", p)
