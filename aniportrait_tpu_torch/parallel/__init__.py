"""Multi-process sampling and data-parallel training over
``torch.distributed`` (port of ``aniportrait_tpu/parallel``)."""

from .mesh import (
    FrameShard,
    Mesh,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
from .zero import Zero1

__all__ = ["FrameShard", "Mesh", "Zero1", "init_distributed", "make_mesh",
           "replicate", "shard_batch"]
