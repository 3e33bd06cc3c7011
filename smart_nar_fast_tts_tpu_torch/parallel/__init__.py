"""Device-mesh parallelism over ``torch.distributed``: one process per card
under torchrun, the ranks laid out on named axes (``mesh.py``), and ring
attention over the frame axis (``sequence.py``)."""

from .mesh import (Mesh, all_reduce, all_reduce_sum, batch_sharding,
                   init_distributed, make_mesh, reduce_over_mesh, replicated,
                   trivial)
from .sequence import (ring_self_attention,
                       sequence_parallel_self_attention)

__all__ = ["Mesh", "all_reduce", "all_reduce_sum", "batch_sharding",
           "init_distributed", "make_mesh", "reduce_over_mesh",
           "replicated", "trivial", "ring_self_attention",
           "sequence_parallel_self_attention"]
