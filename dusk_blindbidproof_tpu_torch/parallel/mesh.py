"""Mesh sharding on torch.distributed: bids over ranks, one MSM's items over
ranks.  The counterpart of the JAX package's parallel/mesh.py.

The JAX package drives a (bids, points) grid of devices from one controller
through shard_map.  Here the program is SPMD: one process per rank, each on
its own torch.device, every rank called with the same full inputs.  Rank r
sits at (bids index r // points, points index r % points), the row-major
order of the JAX grid.

  * bids axis (independent proofs): a rank works on the contiguous rows of
    its bids index (`shard_batch_over_bids`; B need not divide, nothing is
    padded) and the rows are gathered over the bids axis in batch order, so
    every rank returns the full batch.  Ranks of one bids row compute the
    same rows, replicated over `points`.
  * points axis (one MSM's items): each rank bucket-accumulates its slice of
    the items; the partial points are all-gathered over the points axis and
    summed with the group law (a tree of Edwards adds), never with an
    arithmetic reduction: `all_reduce` cannot add curve points.

Collectives move int32 limb tensors (`dist.all_gather`) and pickled bytes
(`all_gather_object`, `broadcast_object_list`).  A rank whose slice is empty
still joins every collective.

`spawn` starts the ranks: the `spawn` start method (the parent may hold a
CUDA context), rendezvous through a FileStore in a temporary directory (no
port).  Backend rule: NCCL when every rank has a card of its own, gloo when
ranks share a card or run on the CPU (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops import edwards, fused, limb, msm
from ..ops.limb import NLIMBS

SPAWN_TIMEOUT = 1800.0  # s, for the whole job and for every collective in it


@dataclass(eq=False)
class Mesh:
    """This rank's place in a (bids, points) grid of ranks, its device, and
    the two subgroups it belongs to (None where an axis has one rank)."""

    bids: int
    points: int
    rank: int
    device: torch.device
    bids_group: object  # the ranks of this rank's points column: vary the bids index
    points_group: object  # the ranks of this rank's bids row: vary the points index

    @property
    def bid_index(self) -> int:
        return self.rank // self.points

    @property
    def point_index(self) -> int:
        return self.rank % self.points


def mesh_device(device=None, local_rank: int | None = None) -> torch.device:
    """A rank's device: "cpu", a card shared by every rank ("cuda:0"), or for
    None or "cuda" cuda:(local_rank % cards), one card a rank in turn.  Raises
    when CUDA is asked for and there is no GPU; the CPU only when named."""
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    if device is not None:
        device = torch.device(device)
    if device is None or device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        if device is None or device.index is None:
            device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def make_mesh(n_devices: int | None = None, bids: int | None = None,
              points: int | None = None, device=None) -> Mesh:
    """Build the (bids, points) mesh over the ranks of the initialised default
    process group; every rank calls it with the same arguments.  The axes
    default as in the JAX package: points = 1, bids = n."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh spans every rank: {n} devices asked, world size {world}")
    if bids is None and points is None:
        points = 1
    if bids is None:
        bids = n // points
    if points is None:
        points = n // bids
    if bids * points != world:
        raise ValueError(f"bids x points = {bids} x {points} != world size {world}")
    device = mesh_device(device)
    # every rank creates every group, in the same order
    bids_group = points_group = None
    for b in range(bids) if points > 1 else ():
        group = dist.new_group([b * points + p for p in range(points)])
        if b == rank // points:
            points_group = group
    for p in range(points) if bids > 1 else ():
        group = dist.new_group([b * points + p for b in range(bids)])
        if p == rank % points:
            bids_group = group
    if device.type == "cuda":
        # object collectives under NCCL stage on the current device
        torch.cuda.set_device(device)
        # one nvcc run for the job: rank 0 builds, the others load after the barrier
        if rank == 0:
            fused.build()
    dist.barrier()
    return Mesh(bids, points, rank, device, bids_group, points_group)


# ---------------------------------------------------------------------------
# Rows over the bids axis
# ---------------------------------------------------------------------------


def _split(n: int, parts: int, index: int) -> slice:
    """The index-th of `parts` contiguous pieces of range(n), as np.array_split
    cuts them: the first n % parts pieces are one longer."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return slice(lo, lo + base + (index < extra))


def bid_rows(mesh: Mesh, batch: int) -> slice:
    """The rows of a [batch, ...] batch that this rank's bids index works on."""
    return _split(batch, mesh.bids, mesh.bid_index)


def shard_batch_over_bids(mesh: Mesh, x):
    """This rank's contiguous rows of a [B, ...] tensor or array, or of a list."""
    return x[bid_rows(mesh, len(x))]


def gather_rows(mesh: Mesh, local):
    """This rank's rows (a list, or a [b, ...] tensor) -> the full batch's, in
    batch order, on every rank: gathered over the bids axis."""
    if isinstance(local, torch.Tensor):
        if mesh.bids_group is None:
            return local
        # all_gather takes equal shapes: pad to the longest slice, then trim
        counts = [None] * mesh.bids
        dist.all_gather_object(counts, local.shape[0], group=mesh.bids_group)
        pad = max(counts) - local.shape[0]
        if pad:
            local = torch.cat([local, local.new_zeros((pad, *local.shape[1:]))])
        parts = _all_gather(local, mesh.bids_group, mesh.bids)
        return torch.cat([part[:c] for part, c in zip(parts, counts)])
    if mesh.bids_group is None:
        return list(local)
    parts = [None] * mesh.bids
    dist.all_gather_object(parts, list(local), group=mesh.bids_group)
    return [row for part in parts for row in part]


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's `obj` on every rank of the mesh (the whole world)."""
    box = [obj if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _all_gather(t: torch.Tensor, group, size: int) -> list[torch.Tensor]:
    """all_gather of one int32 tensor over a subgroup.  The tensor stays on
    its device under either backend: gloo takes CUDA tensors in all_gather
    (it copies through host memory itself; checked on an H100 with PyTorch
    2.11), so nothing here stages a collective."""
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


# ---------------------------------------------------------------------------
# Items over the points axis
# ---------------------------------------------------------------------------


def _pad_pow2(pts: torch.Tensor) -> torch.Tensor:
    """Pad dim -3 to a power of two with the identity."""
    m = pts.shape[-3]
    mp_ = 1 << (m - 1).bit_length()
    if mp_ == m:
        return pts
    pad = edwards.identity(device=pts.device).expand(*pts.shape[:-3], mp_ - m, 4, NLIMBS)
    return torch.cat([pts, pad], dim=-3)


def _sum_over_points(mesh: Mesh, partial: torch.Tensor) -> torch.Tensor:
    """[..., 4, NL] partial sums of this rank -> their group-law sum over the
    points axis, replicated on every rank of the bids row."""
    if mesh.points_group is None:
        return partial
    gathered = torch.stack(_all_gather(partial, mesh.points_group, mesh.points), dim=-3)
    return msm._tree_sum_points(_pad_pow2(gathered))


def sharded_msm(mesh: Mesh, points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """sum_i scalars[i] * points[i] with the items split over the points axis.

    points: [n, 4, NLIMBS]; scalars: [n, NLIMBS], the full arrays on every
    rank.  Each rank runs `msm.msm` on its contiguous slice (an empty slice
    gives the identity); the partials are gathered over the points axis and
    tree-added.  Returns [4, NLIMBS], replicated on every rank."""
    sl = _split(points.shape[-3], mesh.points, mesh.point_index)
    pts, scs = points[..., sl, :, :], scalars[..., sl, :]
    if pts.shape[-3]:
        partial = msm.msm(pts.to(mesh.device), scs.to(mesh.device))
    else:
        partial = edwards.identity(device=mesh.device)
    return _sum_over_points(mesh, partial)


def sharded_bucket_step(mesh: Mesh, points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Batched bucket accumulation, the batch split over bids and the items
    over points: points [B, m, 4, NL], digits [B, m] in [0, D_BUCKETS).  Each
    rank runs `msm.bucket_msm` on its block, the partials are tree-added over
    points and the rows gathered over bids: returns [B, 4, NL] on every rank."""
    rows = bid_rows(mesh, points.shape[0])
    items = _split(points.shape[1], mesh.points, mesh.point_index)
    pts = points[rows, items].to(mesh.device)
    digs = digits[rows, items].to(mesh.device)
    if pts.shape[0] and pts.shape[1]:
        partial = msm.bucket_msm(pts, digs)
    else:
        partial = edwards.identity((pts.shape[0],), device=mesh.device)
    return gather_rows(mesh, _sum_over_points(mesh, partial))


# ---------------------------------------------------------------------------
# The multi-device dry run
# ---------------------------------------------------------------------------


def _same_point(a, b) -> bool:
    from ..utils.curve_host import P

    return (a.X * b.Z - b.X * a.Z) % P == 0 and (a.Y * b.Z - b.Y * a.Z) % P == 0


def dryrun_multichip(mesh: Mesh) -> None:
    """One sharded prover step on tiny shapes, checked on every rank against
    host-integer sums; raises AssertionError on a mismatch.

      * bids axis: `phase_a` (the A_I1 / A_O1 / S1 vector commitments) at
        cap 8 on this rank's rows of a batch of 2 per bids index, the rows
        gathered, every row against host Pedersen sums;
      * points axis: `sharded_bucket_step` on basepoint items, every row
        against (sum of its digits) * B."""
    from ..models.bulletproofs import generator_tables, phase_a
    from ..utils import curve_host as host
    from ..utils.generators import PedersenGens, cached_bp_gens

    dev = mesh.device
    cap, n_pad = 8, 2
    B = mesh.bids * 2
    rng = np.random.default_rng(3)

    def rand_scalars(shape):
        vals = [int(x) for x in rng.integers(1, 1 << 60, size=int(np.prod(shape)))]
        return limb.ints_to_limbs_fast(vals, shape)

    aL, aR, aO, sL, sR = (rand_scalars((B, n_pad)) for _ in range(5))
    blinds = rand_scalars((B, 3))
    tables = generator_tables(cap, dev)
    local = [torch.from_numpy(shard_batch_over_bids(mesh, x)).to(dev)
             for x in (aL, aR, aO, sL, sR, blinds)]
    if local[0].shape[0]:
        comp = phase_a(tables, *local)
    else:
        comp = torch.zeros((0, 3, 4, NLIMBS), dtype=torch.int32, device=dev)
    comp = gather_rows(mesh, comp)  # [B, 3, 4, NL]

    G, H = cached_bp_gens(cap).share(0)
    pc = PedersenGens.default()

    def host_commit(gs, hs, blind):
        acc = pc.B_blinding.scalar_mul(blind)
        for g, v in zip(G, gs):
            acc = acc + g.scalar_mul(v)
        for h, v in zip(H, hs):
            acc = acc + h.scalar_mul(v)
        return acc

    def ints(rows):
        return [limb.limbs_to_int(r) for r in rows]

    for i in range(B):
        want = [
            host_commit(ints(aL[i]), ints(aR[i]), limb.limbs_to_int(blinds[i, 0])),
            host_commit(ints(aO[i]), [0] * n_pad, limb.limbs_to_int(blinds[i, 1])),
            host_commit(ints(sL[i]), ints(sR[i]), limb.limbs_to_int(blinds[i, 2])),
        ]
        got = edwards.to_host(comp[i])
        assert all(_same_point(g, w) for g, w in zip(got, want)), f"phase_a row {i} mismatch"

    n_items = mesh.points * 4
    base = edwards.from_host(host.ED25519_BASEPOINT, device=dev)
    pts = base.expand(B, n_items, 4, NLIMBS)
    digits = rng.integers(0, msm.D_BUCKETS, size=(B, n_items)).astype(np.int32)
    out = edwards.to_host(sharded_bucket_step(mesh, pts, torch.from_numpy(digits).to(dev)))
    for i in range(B):
        want = host.ED25519_BASEPOINT.scalar_mul(int(digits[i].sum()))
        assert _same_point(out[i], want), f"sharded_bucket_step row {i} mismatch"


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------


def default_backend(device, world_size: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def _rank_main(rank, fn, world_size, device, backend, tmp, timeout, args):
    os.environ["LOCAL_RANK"] = str(rank)
    dev = mesh_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(dev, *args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(result, fh)
    os.replace(path + ".tmp", path)


def spawn(fn, world_size: int, *, device, backend: str | None = None, args=(),
          timeout: float = SPAWN_TIMEOUT) -> list:
    """Run `fn(rank_device, *args)` in `world_size` processes joined in one
    default process group; returns the ranks' return values in rank order.

    `fn` must be importable by name (a module-level function).  A rank that
    raises or exits non-zero makes this raise (the other ranks are ended);
    so does a job that outlasts `timeout` seconds."""
    backend = backend or default_backend(device, world_size)
    if backend == "nccl" and len({mesh_device(device, r) for r in range(world_size)}) < world_size:
        raise ValueError("NCCL needs a card of its own for every rank")
    tmp = tempfile.mkdtemp(prefix="bbmesh")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, device, backend, tmp, timeout, tuple(args)),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {world_size} ranks did not end within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
