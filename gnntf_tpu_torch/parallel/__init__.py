"""Scale-out on ``torch.distributed`` (the JAX package's ``parallel/``):
one host or several, the gspmd, halo (flat or hierarchical) and ring
executors."""
from .dist import (EDGE_AXIS, FEAT_AXIS, GspmdExecutor, Mesh,
                   graph_shardings, make_distributed_eval,
                   make_distributed_train_step, make_eval_raw, make_mesh,
                   make_train_step_raw, param_shardings, place_state,
                   shard_graph)
from .halo import (HaloExecutor, HaloPartition, build_halo_partition,
                   halo_spmm)
from .hier_halo import (HierHaloPartition, build_hier_halo_partition,
                        hier_halo_spmm)
from .multihost import (EDGE_HOST_AXIS, free_port, launch_distributed,
                        make_pod_mesh, shard_graph_local,
                        shutdown_distributed)
from .partition import pad_graph
from .ring import RingExecutor, RingPartition, build_ring_partition, ring_spmm
