"""Hand-written Hopper kernels for the limb engine's hot ops, and their
plain PyTorch versions.

The kernels of csrc/edwards_kernels.cu replace the JAX package's four
Pallas kernels, and the loops that drove them:

    K1 mul_rows   a*b mod p or mod l on [..., 21] limb rows
    sqr_chain     x^(2^k) mod p, k squarings of K1 inside one launch
    K3 add        unified extended point add (9M)
    K4 double     extended point doubling (4S + 4M)
    double_chain  2^(steps w) P for every window w, K4 inside one launch
    madd_scan     R-step inclusive scan of every block of R Niels items; its
                  leaf is K2 madd, extended + affine-Niels (7M)
    add_scan      the same over extended points (K3 leaf)
    add_total     the R-item block sums alone (K3 leaf)
    compress      Ristretto compression of extended points to their 32-byte
                  encodings (the prover's transcript points; no TPU kernel)
    mimc_chain    the BlindBid witness's four MiMC hashes, a thread a hash
    witness_fanout  and its wires a_L, a_R, a_O, a thread a gate (no TPU
                  kernel: the host's witness)

Everything mod p runs on csrc/fe25519.cuh (10 limbs of 26/25 bits inside the
kernel), K1 mod l on csrc/sc25519.cuh (10 limbs of 28 bits); the tensors keep
the 21-limb layout.  K2 has no one-step entry: every madd of the port is a
step of `madd_scan`, and `madd_ref` is that scan's plain leaf.

Every wrapper takes a CPU tensor to its plain version (`mul_rows_ref`,
`sqr_chain_ref`, `add_ref`, `double_ref`, `double_chain_ref`,
`madd_scan_ref`, `add_scan_ref`, `add_total_ref`, `compress_ref`) and a CUDA
tensor to its kernel, or raises: nothing falls back from the kernel to the
plain version.  The witness's two launches, `mimc_chain` and
`witness_fanout`, take CUDA tensors alone: their caller,
models.blindbid.witness_wires, holds the gate layout and the plain version.
A CUDA wrapper checks device, dtype, shape and contiguity, allocates its
output with torch.empty, launches on its operands' card and that card's
current stream (inside a device guard of that card, whichever card is
current), raises `KernelError` on the returned cudaGetLastError() code, and
adds one to its launch count.  A failed build or initialisation raises
`KernelError` too.  The point kernels read 16-byte vectors and raise on an
operand that is not aligned so; the row kernels (K1, `sqr_chain`) take any
int32 alignment and copy the ragged head and tail of a block's rows word by
word.

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
from .limb import FP, NLIMBS

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("edwards_kernels.cu", "fe25519.cuh", "sc25519.cuh")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# one launch count per kernel entry point; K1 counts each modulus apart
KERNELS = ("mul_rows_fp", "mul_rows_fl", "sqr_chain", "add", "double", "double_chain",
           "madd_scan", "add_scan", "add_total", "compress", "mimc_chain", "witness_fanout")
LAUNCHES = {name: 0 for name in KERNELS}
BUILD_SECONDS = None  # wall time of this process's nvcc build, if it ran one
BUILD_LOG = ""  # nvcc's output for the library in use (ptxas registers and spills)

_LIB = None
_READY_DEVICES: set = set()


class KernelError(RuntimeError):
    """The kernels failed to build, to initialise or to launch: a fault of the
    device or of the build, never of a request's data."""


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
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _library_path() -> Path:
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((_CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libbbkernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source's library is already built.
    nvcc's output is kept beside the library, so `BUILD_LOG` holds it either way."""
    global BUILD_SECONDS, BUILD_LOG
    so = _library_path()
    log = so.with_suffix(".log")
    if so.exists() and log.exists():
        BUILD_LOG = log.read_text()
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / "edwards_kernels.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = proc.stdout + proc.stderr
    log_tmp = log.with_suffix(f".log.{os.getpid()}.tmp")
    log_tmp.write_text(BUILD_LOG)
    os.replace(log_tmp, log)  # the log first: a library on disk always has one
    os.replace(tmp, so)
    return so


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bb_init.argtypes = []
        lib.bb_mul_rows.argtypes = [ci, vp, vp, vp, ll, vp]
        lib.bb_sqr_chain.argtypes = [vp, vp, ll, ci, vp]
        lib.bb_point_add.argtypes = [vp, vp, vp, ll, vp]
        lib.bb_point_double.argtypes = [vp, vp, ll, vp]
        lib.bb_double_chain.argtypes = [vp, vp, ll, ci, ci, vp]
        lib.bb_point_scan.argtypes = [ci, ci, vp, vp, vp, ll, ci, vp]
        lib.bb_compress.argtypes = [vp, vp, ll, vp]
        lib.bb_mimc_chain.argtypes = [vp, ci, vp, ci, vp, vp, ll, vp]
        lib.bb_witness_fanout.argtypes = [vp, ci, vp, ci, vp, vp, ll, ci, ci, vp]
        for fn in (lib.bb_init, lib.bb_mul_rows, lib.bb_sqr_chain, lib.bb_point_add,
                   lib.bb_point_double, lib.bb_double_chain, lib.bb_point_scan,
                   lib.bb_compress, lib.bb_mimc_chain, lib.bb_witness_fanout):
            fn.restype = ci
        _LIB = lib
    return _LIB


def _ready(device: torch.device):
    """The bound library, with the kernels' shared-memory preference set on
    `device` (the kernels carry their constants in the code)."""
    lib = _lib()
    if device.index not in _READY_DEVICES:
        with torch.cuda.device(device):
            rc = lib.bb_init()
        if rc != 0:
            raise KernelError(f"bb_init failed with code {rc}")
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


def _check(shape, *xs, vector_loads: bool = False) -> None:
    """Raise unless every operand is what the kernels take: int32,
    contiguous, of `shape`, on one CUDA device; the kernels that read
    16-byte vectors (the point kernels) also need that alignment."""
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
        if vector_loads and x.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def _launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Launch the library's `entry` on `device`, the card of its operands,
    with that card's current stream as the last argument.  The CUDA runtime
    launches into the calling thread's current device, so the launch is made
    inside a guard of `device`: a kernel on another card than its pointers
    would fault or race that card's stream."""
    lib = _ready(device)
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, _stream(device))
    if rc != 0:
        raise KernelError(f"kernel {name} failed to launch: cudaError {rc}")
    LAUNCHES[name] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# K1: modular product of limb rows, and the squaring chain
# ---------------------------------------------------------------------------


def mul_rows_ref(ctx: limb.ModContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: the bound-tracked schoolbook product (std form)."""
    return limb.lb_mul(ctx, limb.wrap(a), limb.wrap(b)).x


def _rows_shape(name: str, shape) -> None:
    if shape[-1:] != (NLIMBS,):
        raise ValueError(f"{name} takes [..., {NLIMBS}] limb rows, got {tuple(shape)}")


def mul_rows(ctx: limb.ModContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b mod M on [..., NLIMBS] rows: K1 for CUDA tensors (same shape,
    contiguous, any int32 alignment; canonical output), the plain version for
    CPU tensors.  Mod p, passing one tensor twice takes the kernel's square."""
    if not (a.is_cuda or b.is_cuda):
        return mul_rows_ref(ctx, a, b)
    shape = a.shape
    _rows_shape("mul_rows", shape)
    _check(shape, a, b)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // NLIMBS
    if n:
        mod = {"fp": 0, "fl": 1}[ctx.name]
        _launch(f"mul_rows_{ctx.name}", "bb_mul_rows", a.device, mod, a.data_ptr(),
                b.data_ptr(), out.data_ptr(), n)
    return out


def sqr_chain_ref(ctx: limb.ModContext, x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of `sqr_chain`: k steps of `mul_rows_ref`."""
    if k < 1:
        raise ValueError(f"sqr_chain takes k >= 1 squarings, got {k}")
    for _ in range(k):
        x = mul_rows_ref(ctx, x, x)
    return x


def sqr_chain(ctx: limb.ModContext, x: torch.Tensor, k: int) -> torch.Tensor:
    """x^(2^k) mod p on [..., NLIMBS] rows, k >= 1: one kernel launch on a CUDA
    tensor (mod p only; canonical output), `sqr_chain_ref` on a CPU tensor."""
    if not x.is_cuda:
        return sqr_chain_ref(ctx, x, k)
    if ctx.name != "fp":
        raise ValueError("the sqr_chain kernel is mod p only")
    if k < 1:
        raise ValueError(f"sqr_chain takes k >= 1 squarings, got {k}")
    _rows_shape("sqr_chain", x.shape)
    _check(x.shape, x)
    out = torch.empty_like(x)
    n = out.numel() // NLIMBS
    if n:
        _launch("sqr_chain", "bb_sqr_chain", x.device, x.data_ptr(), out.data_ptr(), n, k)
    return out


# ---------------------------------------------------------------------------
# K3, K4 and the doubling chain on [..., 4, NLIMBS] rows (X, Y, Z, T); K2's
# plain version, the leaf of `madd_scan_ref`
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
    """Plain version of K2, one step of `madd_scan_ref`: p extended + q
    affine-Niels (y-x, y+x, 2d*xy), madd-2008-hwcd-3 (7M)."""
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


def _point_op(name: str, entry: str, *xs) -> torch.Tensor:
    shape = xs[0].shape
    if tuple(shape[-2:]) != (4, NLIMBS):
        raise ValueError(f"point ops take [..., 4, {NLIMBS}] rows, got {tuple(shape)}")
    _check(shape, *xs, vector_loads=True)
    out = torch.empty(shape, dtype=torch.int32, device=xs[0].device)
    n = out.numel() // (4 * NLIMBS)
    if n:
        _launch(name, entry, out.device, *(x.data_ptr() for x in xs), out.data_ptr(), n)
    return out


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA tensors (same shape, contiguous), `add_ref` on CPU tensors."""
    if not (p.is_cuda or q.is_cuda):
        return add_ref(p, q)
    return _point_op("add", "bb_point_add", p, q)


def double(p: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA tensors, `double_ref` on CPU tensors."""
    if not p.is_cuda:
        return double_ref(p)
    return _point_op("double", "bb_point_double", p)


def double_chain_ref(points: torch.Tensor, windows: int, steps: int) -> torch.Tensor:
    """Plain version of `double_chain`: `steps` times `double_ref` a window."""
    if windows < 1 or steps < 1:
        raise ValueError(f"double_chain takes windows, steps >= 1, got {windows}, {steps}")
    scaled = [points]
    for _ in range(windows - 1):
        nxt = scaled[-1]
        for _ in range(steps):
            nxt = double_ref(nxt)
        scaled.append(nxt)
    return torch.stack(scaled, dim=-3)


def double_chain(points: torch.Tensor, windows: int, steps: int) -> torch.Tensor:
    """[..., 4, NLIMBS] points -> [..., windows, 4, NLIMBS] with
    out[..., w, :, :] = 2^(steps w) P.  One kernel launch on a CUDA tensor (a
    thread doubles its point in registers and writes one point a window),
    `double_chain_ref` on a CPU tensor."""
    if not points.is_cuda:
        return double_chain_ref(points, windows, steps)
    shape = points.shape
    if tuple(shape[-2:]) != (4, NLIMBS):
        raise ValueError(f"point ops take [..., 4, {NLIMBS}] rows, got {tuple(shape)}")
    if windows < 1 or steps < 1:
        raise ValueError(f"double_chain takes windows, steps >= 1, got {windows}, {steps}")
    _check(shape, points, vector_loads=True)
    out = torch.empty((*shape[:-2], windows, 4, NLIMBS), dtype=torch.int32,
                      device=points.device)
    n = points.numel() // (4 * NLIMBS)
    if n:
        _launch("double_chain", "bb_double_chain", points.device, points.data_ptr(),
                out.data_ptr(), n, windows, steps)
    return out


# ---------------------------------------------------------------------------
# The R-step block scans over [..., C*R, 4, NLIMBS] items (K2 / K3 leaves)
# ---------------------------------------------------------------------------

_LEAF_MADD, _LEAF_ADD = 0, 1  # bb_point_scan's `leaf`
_MODE_PREFIXES, _MODE_TOTALS = 0, 1  # and `mode`


def _scan_ref(step, items: torch.Tensor, R: int, prefixes: bool):
    """R lockstep steps over all blocks: step r adds item c*R + r of every
    block c to that block's running sum, which starts at the identity."""
    from .edwards import identity

    batch, m = items.shape[:-3], items.shape[-3]
    if R < 1 or m % R:
        raise ValueError(f"scan takes C*R items, got {m} items for R = {R}")
    xs = items.reshape(*batch, m // R, R, 4, NLIMBS).movedim(-3, 0)
    acc = identity(device=items.device).expand(*xs.shape[1:])
    within = []
    for r in range(R):
        acc = step(acc, xs[r])
        if prefixes:
            within.append(acc)
    if not prefixes:
        return acc
    return torch.stack(within, dim=-3).reshape(*batch, m, 4, NLIMBS), acc


def madd_scan_ref(items_niels: torch.Tensor, R: int):
    """Plain version of `madd_scan`: R steps of `madd_ref`."""
    return _scan_ref(madd_ref, items_niels, R, True)


def add_scan_ref(items: torch.Tensor, R: int):
    """Plain version of `add_scan`: R steps of `add_ref`."""
    return _scan_ref(add_ref, items, R, True)


def add_total_ref(items: torch.Tensor, R: int) -> torch.Tensor:
    """Plain version of `add_total`: R steps of `add_ref`, last sum only."""
    return _scan_ref(add_ref, items, R, False)


def _scan_op(name: str, leaf: int, mode: int, items: torch.Tensor, R: int):
    shape = items.shape
    if len(shape) < 3 or tuple(shape[-2:]) != (4, NLIMBS):
        raise ValueError(f"scans take [..., C*R, 4, {NLIMBS}] items, got {tuple(shape)}")
    if R < 1 or shape[-3] % R:
        raise ValueError(f"scan takes C*R items, got {shape[-3]} items for R = {R}")
    _check(shape, items, vector_loads=True)
    batch, blocks = shape[:-3], shape[-3] // R
    totals = torch.empty((*batch, blocks, 4, NLIMBS), dtype=torch.int32, device=items.device)
    within = torch.empty_like(items) if mode == _MODE_PREFIXES else None
    nblocks = totals.numel() // (4 * NLIMBS)
    if nblocks:
        _launch(name, "bb_point_scan", items.device, leaf, mode, items.data_ptr(),
                None if within is None else within.data_ptr(), totals.data_ptr(), nblocks, R)
    return within, totals


def madd_scan(items_niels: torch.Tensor, R: int):
    """Inclusive scan inside every block of R consecutive affine-Niels items.

    items_niels: [..., C*R, 4, NLIMBS] in item order.  Returns (within
    [..., C*R, 4, NLIMBS], totals [..., C, 4, NLIMBS]) with within[c*R + r] =
    items[c*R] + ... + items[c*R + r] and totals[c] = within[c*R + R - 1].
    One kernel launch on a CUDA tensor, `madd_scan_ref` on a CPU tensor."""
    if not items_niels.is_cuda:
        return madd_scan_ref(items_niels, R)
    return _scan_op("madd_scan", _LEAF_MADD, _MODE_PREFIXES, items_niels, R)


def add_scan(items: torch.Tensor, R: int):
    """`madd_scan` over extended points (the 9M leaf)."""
    if not items.is_cuda:
        return add_scan_ref(items, R)
    return _scan_op("add_scan", _LEAF_ADD, _MODE_PREFIXES, items, R)


def add_total(items: torch.Tensor, R: int) -> torch.Tensor:
    """Sums of every block of R consecutive extended points:
    [..., C*R, 4, NLIMBS] -> [..., C, 4, NLIMBS], no prefixes written."""
    if not items.is_cuda:
        return add_total_ref(items, R)
    return _scan_op("add_total", _LEAF_ADD, _MODE_TOTALS, items, R)[1]


# ---------------------------------------------------------------------------
# Ristretto compression of [..., 4, NLIMBS] points
# ---------------------------------------------------------------------------

ENCODING_WORDS = 8  # int32 words of one 32-byte encoding


def compress_ref(points: torch.Tensor) -> torch.Tensor:
    """Plain version of `compress`: `ristretto.compress`, then the canonical
    s as the little-endian words of its 32 bytes."""
    from . import ristretto

    enc = limb.limbs_to_bytes_le(ristretto.compress(points))  # [..., 32] uint8
    return torch.from_numpy(enc.view(np.int32)).to(points.device)


def compress(points: torch.Tensor) -> torch.Tensor:
    """[..., 4, NLIMBS] extended points -> [..., ENCODING_WORDS] int32: each
    point's 32-byte Ristretto encoding as little-endian words (on the host,
    `.view(np.uint8)` of the read gives the bytes).  One kernel launch on a
    CUDA tensor (contiguous, 16-byte aligned), `compress_ref` on a CPU tensor."""
    if not points.is_cuda:
        return compress_ref(points)
    shape = points.shape
    if tuple(shape[-2:]) != (4, NLIMBS):
        raise ValueError(f"compress takes [..., 4, {NLIMBS}] points, got {tuple(shape)}")
    _check(shape, points, vector_loads=True)
    out = torch.empty((*shape[:-2], ENCODING_WORDS), dtype=torch.int32, device=points.device)
    n = out.numel() // ENCODING_WORDS
    if n:
        _launch("compress", "bb_compress", points.device, points.data_ptr(), out.data_ptr(), n)
    return out


# ---------------------------------------------------------------------------
# The BlindBid witness: its MiMC hashes, then its wires
# ---------------------------------------------------------------------------

MIMC_ROUNDS = 90  # the rounds of a hash built into mimc_chain_kernel (kRounds)
MIMC_SCRATCH_ROWS = 4 * MIMC_ROUNDS + 4  # the rounds' inputs, then the four outputs


def _check_operands(*operands) -> None:
    """`_check` of each (shape, tensor) pair, and all of them on one card."""
    for shape, x in operands:
        _check(shape, x)
    devices = {x.device for _, x in operands}
    if len(devices) > 1:
        raise ValueError("kernel operands must share one CUDA device, got "
                         + ", ".join(sorted(map(str, devices))))


def mimc_chain(v: torch.Tensor, publics: torch.Tensor, constants: torch.Tensor) -> torch.Tensor:
    """The `mimc_chain` launch: v [n, 4 + L, NLIMBS] (d, k, y, y_inv, the L
    toggles), publics [n, 3 + L, NLIMBS] (q, z_img, seed, the L items) and
    the round constants [MIMC_ROUNDS, NLIMBS], limbs in [0, 8192] read mod l
    -> the scratch [n, MIMC_SCRATCH_ROWS, NLIMBS] of the four hashes' round
    inputs a (hash h, round r at row 90 h + r) and outputs (row 360 + h).
    CUDA tensors alone: the gate layout and the plain version of the witness
    are the application's (models.blindbid.witness_wires)."""
    n, m = v.shape[0], v.shape[1]
    _check_operands(((n, m, NLIMBS), v), ((n, m - 1, NLIMBS), publics),
                    ((MIMC_ROUNDS, NLIMBS), constants))
    scratch = torch.empty((n, MIMC_SCRATCH_ROWS, NLIMBS), dtype=torch.int32, device=v.device)
    if n:
        _launch("mimc_chain", "bb_mimc_chain", v.device, v.data_ptr(), m, publics.data_ptr(),
                m - 1, constants.data_ptr(), scratch.data_ptr(), n)
    return scratch


def witness_fanout(v: torch.Tensor, publics: torch.Tensor, scratch: torch.Tensor, n_pad: int,
                   list_len: int) -> torch.Tensor:
    """The `witness_fanout` launch: `mimc_chain`'s operands and scratch ->
    [3, n, n_pad, NLIMBS] canonical limbs, the wires a_L, a_R, a_O of
    list_len bids, zero past their 1442 + 3 list_len gates (an n_pad below
    them raises KernelError).  CUDA tensors alone."""
    n = v.shape[0]
    _check_operands(((n, 4 + list_len, NLIMBS), v), ((n, 3 + list_len, NLIMBS), publics),
                    ((n, MIMC_SCRATCH_ROWS, NLIMBS), scratch))
    out = torch.empty((3, n, n_pad, NLIMBS), dtype=torch.int32, device=v.device)
    if n:
        _launch("witness_fanout", "bb_witness_fanout", v.device, v.data_ptr(), 4 + list_len,
                publics.data_ptr(), 3 + list_len, scratch.data_ptr(), out.data_ptr(), n, n_pad,
                list_len)
    return out
