"""Single-host scale-out on ``torch.distributed`` (the JAX package's
``parallel/``, without its multi-host part: ROADMAP.md queue 1, item
12d)."""
from .dist import (EDGE_AXIS, FEAT_AXIS, GspmdExecutor, Mesh,
                   graph_shardings, make_distributed_eval,
                   make_distributed_train_step, make_eval_raw, make_mesh,
                   make_train_step_raw, param_shardings, place_state,
                   shard_graph)
from .halo import (HaloExecutor, HaloPartition, build_halo_partition,
                   halo_spmm)
from .partition import pad_graph
from .ring import RingExecutor, RingPartition, build_ring_partition, ring_spmm
