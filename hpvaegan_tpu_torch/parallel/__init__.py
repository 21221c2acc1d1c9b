"""Training over a (data, spatial) mesh of ``torch.distributed`` ranks
(port of ``hpvaegan_tpu/parallel/``): the process group and its
collectives (``distributed``), the mesh, its blocks and operators
(``mesh``), and the multi-process helpers (``multihost``)."""
from . import multihost
from .distributed import maybe_initialize
from .mesh import (Mesh, attach, block_rows, default_mesh_shape, make_mesh,
                   parse_mesh_shape, replicate, shard, shard_batch,
                   shard_gvars)

__all__ = ["Mesh", "attach", "block_rows", "default_mesh_shape",
           "make_mesh", "parse_mesh_shape", "replicate", "shard",
           "shard_batch", "shard_gvars", "maybe_initialize", "multihost"]
