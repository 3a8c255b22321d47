"""ZeRO-1 optimizer-state sharding over data-parallel ranks (the port of the
JAX ``shard_opt_state``, ``aniportrait_tpu/parallel/mesh.py:115-146``).

Each rank keeps the optimizer state of a disjoint set of whole parameters
and steps only those; after its step every parameter is broadcast from its
owner, so all ranks hold the same weights.  Owners are assigned by the
longest-first greedy rule over each parameter's state bytes, so a rank holds
at most ``total / world`` plus the largest parameter's state.  The update is
the wrapped optimizer's own per-parameter math on the all-reduced gradients,
so it equals the unsharded step; 8-bit AdamW's blocks are per parameter and
do not move.  A checkpoint gathers the state to rank 0 a bucket at a time
(:meth:`Zero1.gather_state`).

``torch.distributed.optim.ZeroRedundancyOptimizer`` partitions and
broadcasts the same way, but its ``consolidate_state_dict`` moves each
rank's whole state as one pickled object, broadcast to every rank (~7 GiB a
rank for full-size float32 AdamW, on top of the training peak), so the port
keeps this wrapper.

    opt = Zero1(params, lambda ps: torch.optim.AdamW(ps, lr=1e-5), mesh,
                state_nbytes=adamw_state_nbytes)
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

from aniportrait_tpu_torch.parallel.mesh import BUCKET_BYTES, Mesh, _as_bytes, broadcast_tensors_


def adamw_state_nbytes(p: torch.Tensor) -> int:
    """``torch.optim.AdamW``'s state of ``p``: two float32 moments and a
    float32 step."""
    return 8 * p.numel() + 4


def assign_owners(costs: Sequence[int], world: int) -> List[int]:
    """Owner rank of each item: largest first, each to the least loaded rank
    (ties to the lowest rank)."""
    heap = [(0, r) for r in range(world)]
    owners = [0] * len(costs)
    for i in sorted(range(len(costs)), key=lambda i: (-costs[i], i)):
        load, r = heapq.heappop(heap)
        owners[i] = r
        heapq.heappush(heap, (load + costs[i], r))
    return owners


class Zero1:
    """An optimizer over ``params`` whose state lives with each parameter's
    owner.  ``make_optimizer(owned params)`` builds the rank's local
    optimizer (None where it owns nothing); ``state_nbytes(p)`` is what its
    state of ``p`` weighs, for the assignment.

    ``param_groups`` lists every parameter (the train step fills and clips
    their gradients), ``state`` is the local optimizer's, ``step()`` steps
    the local parameters and then broadcasts each parameter from its owner,
    a bucket at a time."""

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 make_optimizer: Callable[[List[torch.nn.Parameter]], torch.optim.Optimizer],
                 mesh: Mesh, state_nbytes: Callable[[torch.Tensor], int] = adamw_state_nbytes):
        self.params = list(params)
        self.mesh = mesh
        self.owners = assign_owners([state_nbytes(p) for p in self.params], mesh.size)
        mine = [p for p, r in zip(self.params, self.owners) if r == mesh.rank]
        self.local = make_optimizer(mine) if mine else None
        self.param_groups = [{"params": self.params}]
        self._index = {p: i for i, p in enumerate(self.params)}

    @property
    def state(self) -> Dict[torch.Tensor, dict]:
        return self.local.state if self.local is not None else {}

    def owns(self, p: torch.Tensor) -> bool:
        return self.owners[self._index[p]] == self.mesh.rank

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Drop every gradient (the train step asks for ``set_to_none``)."""
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        if self.local is not None:
            self.local.step()
        for owner in range(self.mesh.size):
            broadcast_tensors_([p for p, r in zip(self.params, self.owners) if r == owner],
                               self.mesh.world, owner)

    def gather_state(self) -> Dict[torch.Tensor, dict]:
        """On rank 0, every parameter's state on the host, gathered from the
        owners (an empty dict on the other ranks).  Every rank must call
        it.  Only the layout (shapes, dtypes) goes as one small object; the
        tensors go a bucket of at most ``BUCKET_BYTES`` at a time, each
        broadcast from its owner, so no rank holds more than one bucket
        beyond its own state."""
        mesh, rank = self.mesh, self.mesh.rank
        mine = {i: self.state[p] for i, p in enumerate(self.params) if p in self.state}
        host = {i: {k: v.detach().cpu() if torch.is_tensor(v) else v for k, v in st.items()}
                for i, st in mine.items()} if rank == 0 else {}
        if mesh.size == 1:
            return {self.params[i]: st for i, st in host.items()}
        layout = {i: {k: _Meta(tuple(v.shape), v.dtype) if torch.is_tensor(v) else v
                      for k, v in st.items()} for i, st in mine.items()}
        layouts = [None] * mesh.size
        dist.all_gather_object(layouts, layout)
        device = torch.device("cuda", torch.cuda.current_device()) \
            if mesh.world.backend == "nccl" else torch.device("cpu")
        for owner in range(1, mesh.size):  # rank 0's own state is here already
            entries = [(i, k, m.shape, m.dtype) for i, st in sorted(layouts[owner].items())
                       for k, m in sorted(st.items()) if isinstance(m, _Meta)]
            if rank == 0:
                for i, st in layouts[owner].items():
                    host[i] = {k: m for k, m in st.items() if not isinstance(m, _Meta)}
            for bucket in _byte_buckets(entries):
                sizes = [math.prod(shape) * dtype.itemsize for _, _, shape, dtype in bucket]
                if rank == owner:
                    flat = torch.cat([_as_bytes(mine[i][k]).to(device) for i, k, _, _ in bucket])
                else:
                    flat = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
                mesh.world.broadcast_(flat, owner)
                if rank == 0:
                    for (i, k, shape, dtype), part in zip(bucket, flat.cpu().split(sizes)):
                        host[i][k] = part.view(dtype).reshape(shape).clone()
                del flat
        return {self.params[i]: st for i, st in host.items()}


@dataclass(frozen=True)
class _Meta:
    """A state tensor's layout, sent ahead of its bytes."""
    shape: tuple
    dtype: torch.dtype


def _byte_buckets(entries: List[tuple]) -> List[List[tuple]]:
    """``(index, key, shape, dtype)`` entries in runs of at most
    ``BUCKET_BYTES`` (a larger tensor is a run of its own)."""
    runs: List[List[tuple]] = [[]]
    used = 0
    for e in entries:
        n = math.prod(e[2]) * e[3].itemsize
        if runs[-1] and used + n > BUCKET_BYTES:
            runs.append([])
            used = 0
        runs[-1].append(e)
        used += n
    return [r for r in runs if r]
