"""Process groups and collectives over ``torch.distributed`` (port of
``aniportrait_tpu/parallel/mesh.py``).

Where the JAX package lays one program over a device mesh and lets GSPMD
insert the collectives, the port runs one process per rank (``torchrun``, or
:func:`parallel.launch.spawn`) and each rank calls the kernels on its local
tensors; the collectives are explicit:

* training is data-parallel: each rank takes ``train_bs / world`` rows,
  gradients are averaged by ``all_reduce`` and the optimizer state is
  sharded by whole parameters (``parallel/zero.py``, the counterpart of
  ``shard_opt_state``);
* the sampler shards context windows over the ranks (exact windowed path)
  or CFG halves x frame blocks (whole-clip and window-fused paths, the JAX
  pipeline's 2-D ``cfg x frames`` view); the motion modules turn frame
  shards into spatial-position shards by an ``all_to_all``
  (:func:`frames_to_positions`).

Only ``all_reduce``, ``all_gather``, ``all_to_all`` and ``broadcast`` are
used, which gloo has too.  Two ranks that share one card talk over gloo
(NCCL refuses two ranks on one device), which takes CUDA tensors and stages
them through pinned host memory itself: as fast as staging them here
(``chip_smoke.py``'s multi phase on an H100 80GB HBM3 at 700 W, 1 GiB:
all-reduce 0.63 against 0.65 GB/s, broadcast 1.42 against 1.44, one timed
call each).  NCCL is the default backend on CUDA, and nothing falls back
from it.

    from aniportrait_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed()          # under torchrun; a no-op without its env
    mesh = make_mesh()
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# bytes per bucket when many tensors are broadcast or reduced together
BUCKET_BYTES = 256 << 20
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def init_distributed(backend: Optional[str] = None) -> bool:
    """Join the process group ``torchrun`` describes (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); returns True
    iff a multi-process group is up.  Without that environment it is a strict
    no-op and returns False, as the JAX ``init_distributed`` is without a
    coordinator.

    ``backend``: ``nccl`` (the default with a card) or ``gloo`` (the default
    without one; pass it explicitly for ranks that share a card).  With a
    card, rank ``LOCAL_RANK`` takes device ``LOCAL_RANK`` (under gloo,
    ``LOCAL_RANK`` modulo the cards, so ranks may share one)."""
    if any(k not in os.environ for k in _TORCHRUN_ENV):
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        if backend == "nccl" and local >= count:
            raise RuntimeError(f"LOCAL_RANK {local} has no card of its own ({count} "
                               "visible); NCCL needs one card a rank")
        torch.cuda.set_device(local % count)
    dist.init_process_group(backend, rank=rank, world_size=world)
    return world > 1


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view (data movement is
    then independent of the dtype: gloo lacks some, e.g. bool)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


@dataclass(frozen=True)
class Group:
    """One process group from this rank's side: ``pg`` (None: the default
    group), its ``size`` and this rank's ``index`` in it.  A group of size 1
    makes every collective the identity."""

    pg: Any
    size: int
    index: int
    backend: str

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group in place; returns it."""
        if self.size > 1:
            dist.all_reduce(t, group=self.pg)
        return t

    def broadcast_(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Overwrite ``t`` (contiguous) with member ``src``'s, in place."""
        if self.size > 1:
            dist.broadcast(_as_bytes(t), group_src(self, src), group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor, rows: Sequence[int]) -> List[torch.Tensor]:
        """Every member's ``t``, whose leading dims are ``rows`` (one per
        member; the rest of the shape and the dtype are shared)."""
        if self.size == 1:
            return [t]
        most = max(rows)
        pad = torch.zeros((most - t.shape[0], *t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        flat = _as_bytes(torch.cat([t, pad]))
        parts = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(parts, flat, group=self.pg)
        return [p.view(t.dtype).reshape(most, *t.shape[1:])[:n] for p, n in zip(parts, rows)]

    def all_to_all(self, send: Sequence[torch.Tensor], recv_numel: Sequence[int]
                   ) -> List[torch.Tensor]:
        """``send[i]`` goes to member ``i``; returns, flat, what each member
        sent here (``recv_numel`` elements from member ``i``, in
        ``send``'s dtype)."""
        dtype, device = send[0].dtype, send[0].device
        if self.size == 1:
            return [send[0].reshape(-1)]
        size = dtype.itemsize
        inp = torch.cat([_as_bytes(s) for s in send])
        out = torch.empty(sum(recv_numel) * size, dtype=torch.uint8, device=device)
        dist.all_to_all_single(out, inp, [n * size for n in recv_numel],
                               [s.numel() * size for s in send], group=self.pg)
        return list(out.view(dtype).split(list(recv_numel)))


def group_src(group: Group, member: int) -> int:
    """The global rank of ``group``'s member ``member``."""
    if group.pg is None:
        return member
    return dist.get_global_rank(group.pg, member)


@dataclass(frozen=True)
class Mesh:
    """The ranks of one job: ``world`` (every rank) and the 2-D ``cfg x
    frames`` view of the JAX pipeline's canonical mesh
    (``aniportrait_tpu/pipelines/pose2vid.py:140-168``): with an even world,
    rank ``r`` holds CFG half ``r // (world / 2)`` and frame block ``r %
    (world / 2)``, and ``frames`` is the group of the ranks of its half
    (the whole world when the world is odd)."""

    world: Group
    frames: Group
    cfg_ways: int

    @property
    def rank(self) -> int:
        return self.world.index

    @property
    def size(self) -> int:
        return self.world.size

    @property
    def cfg_index(self) -> int:
        return self.rank // self.frames.size if self.cfg_ways == 2 else 0


def make_mesh() -> Mesh:
    """The mesh of the current process group (a one-rank mesh without
    one).  Every rank must call it: it creates the ``frames`` subgroups."""
    if not dist.is_initialized():
        one = Group(None, 1, 0, "none")
        return Mesh(one, one, 1)
    backend = dist.get_backend()
    rank, size = dist.get_rank(), dist.get_world_size()
    world = Group(None, size, rank, backend)
    cfg_ways = 2 if size % 2 == 0 else 1
    if cfg_ways == 1:
        return Mesh(world, world, 1)
    half = size // 2
    pgs = [dist.new_group(list(range(c * half, (c + 1) * half))) for c in range(2)]
    frames = Group(pgs[rank // half], half, rank % half, backend)
    return Mesh(world, frames, 2)


def shard_rows(n: int, parts: int, index: int) -> slice:
    """Rows ``[index * n / parts, (index + 1) * n / parts)`` of ``n``."""
    return slice(index * n // parts, (index + 1) * n // parts)


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch (arrays or tensors): the JAX
    ``shard_batch`` gives each device a block of rows; here each rank keeps
    its own.  The rows must divide by the world."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % mesh.size:
            raise ValueError(f"{k}: {n} rows do not divide over {mesh.size} ranks")
        out[k] = v[shard_rows(n, mesh.size, mesh.rank)]
    return out


def _buckets(tensors: Iterable[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Tensors grouped by (device, dtype) into buckets of at most
    ``BUCKET_BYTES`` (a larger tensor is a bucket of its own)."""
    by_kind: Dict[tuple, List[List[torch.Tensor]]] = {}
    for t in tensors:
        lists = by_kind.setdefault((t.device, t.dtype), [[]])
        cur = lists[-1]
        if cur and sum(x.numel() for x in cur) * t.element_size() + t.nbytes > BUCKET_BYTES:
            lists.append(cur := [])
        cur.append(t)
    return [b for lists in by_kind.values() for b in lists]


@torch.no_grad()
def broadcast_tensors_(tensors: Iterable[torch.Tensor], group: Group, src: int = 0) -> None:
    """Overwrite every tensor with member ``src``'s, a bucket at a time."""
    if group.size == 1:
        return
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        group.broadcast_(flat, src)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group: Group) -> None:
    """Average every tensor over the group in place, in float32, a bucket
    at a time (one ``all_reduce`` a bucket)."""
    if group.size == 1:
        return
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        group.all_reduce_(flat).div_(group.size)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def replicate(modules, mesh: Mesh) -> None:
    """Make every rank's weights and buffers rank 0's (the JAX
    ``replicate`` puts one copy of the parameters on every device).
    ``modules``: one ``nn.Module`` or an iterable of them."""
    if isinstance(modules, torch.nn.Module):
        modules = [modules]
    tensors = [t for m in modules for t in [*m.parameters(), *m.buffers()]]
    broadcast_tensors_(tensors, mesh.world, 0)


class AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over ``group``, differentiable: the gradient of each
    rank's input is the sum of every rank's output gradient (what a batch
    statistic over the global batch needs)."""

    @staticmethod
    def forward(ctx, x, group: Group):
        ctx.group = group
        return group.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce_(grad.contiguous().clone()), None


# ------------------------------------------------ frame-block sharding
@dataclass(frozen=True)
class FrameShard:
    """A clip's frames split over ``group``: member ``i`` holds frames
    ``[offsets[i], offsets[i + 1])``.  The motion modules take it and attend
    over every frame at their share of the spatial positions."""

    group: Group
    sizes: tuple

    @property
    def frames(self) -> int:
        return sum(self.sizes)

    @property
    def block(self) -> slice:
        start = sum(self.sizes[:self.group.index])
        return slice(start, start + self.sizes[self.group.index])


def frame_sizes(frames: int, parts: int) -> tuple:
    """Block sizes of ``frames`` split as evenly as possible, the larger
    first (``np.array_split``'s rule)."""
    return tuple(len(a) for a in np.array_split(np.arange(frames), parts))


def frames_to_positions(hid: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    """(b, f_local, s, c) frame block -> (b, frames, s_local, c): every frame
    at this rank's block of the ``s`` spatial positions, by one
    ``all_to_all`` over the shard's group."""
    b, f, s, c = hid.shape
    g = shard.group
    pos = frame_sizes(s, g.size)
    send = [p.contiguous() for p in hid.split(pos, dim=2)]
    mine = pos[g.index]
    recv = g.all_to_all(send, [b * n * mine * c for n in shard.sizes])
    return torch.cat([r.view(b, n, mine, c) for r, n in zip(recv, shard.sizes)], dim=1)


def positions_to_frames(hid: torch.Tensor, shard: FrameShard, s: int) -> torch.Tensor:
    """Inverse of :func:`frames_to_positions`: (b, frames, s_local, c) ->
    (b, f_local, s, c)."""
    b, _, mine, c = hid.shape
    g = shard.group
    pos = frame_sizes(s, g.size)
    f = shard.sizes[g.index]
    send = [p.contiguous() for p in hid.split(list(shard.sizes), dim=1)]
    recv = g.all_to_all(send, [b * f * n * c for n in pos])
    return torch.cat([r.view(b, f, n, c) for r, n in zip(recv, pos)], dim=2)
