"""Run a function on ``world`` ranks in fresh processes, as ``torchrun``
would start them, and collect what each rank returns.

    from aniportrait_tpu_torch.parallel.launch import spawn
    results = spawn(fn, 2, args=(...,))   # [rank 0's, rank 1's]

``fn(mesh, *args)`` runs in every rank after :func:`parallel.mesh.
init_distributed` has joined the group (``MASTER_ADDR`` localhost, a free
port): over NCCL when there is a card for every rank (rank r on card r),
else over gloo (ranks on the CPU, or sharing a card, which NCCL refuses).  It
must be importable by name (a module-level function), and its arguments
and result picklable; a script that calls :func:`spawn` does so under its
``if __name__ == "__main__"`` guard, since every rank imports the main
module.  The ranks are ``torch.multiprocessing.spawn``'s: one that raises
ends the others and :func:`spawn` raises with its traceback; ranks still
running at ``timeout`` are killed.  Each rank runs with ``OMP_NUM_THREADS``
and its intra-op threads set to ``threads``.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time
from typing import Any, Callable, List, Sequence


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world: int, port: int, backend: str, threads: int,
               args, outdir: str) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    import torch
    import torch.distributed as dist

    from aniportrait_tpu_torch.parallel.mesh import init_distributed, make_mesh

    torch.set_num_threads(threads)
    init_distributed(backend)
    try:
        out = fn(make_mesh(), *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), timeout: float = 900.0,
          threads: int = 1) -> List[Any]:
    """``[fn(mesh, *args) of rank r for r in range(world)]``; see the
    module doc."""
    import torch
    import torch.multiprocessing as mp

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if cards >= world else "gloo"
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(threads)  # the ranks inherit it at start
    with tempfile.TemporaryDirectory(prefix="spawn-") as outdir:
        try:
            ctx = mp.spawn(_rank_main, nprocs=world, join=False,
                           args=(fn, world, free_port(), backend, threads, tuple(args), outdir))
        finally:
            if saved is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = saved
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"spawn({getattr(fn, '__name__', fn)}): timed out "
                                   f"after {timeout} s")
        out = []
        for r in range(world):
            with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
