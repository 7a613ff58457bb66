"""gnntf_tpu_torch — the gnntf_tpu graph neural network framework in
PyTorch, for NVIDIA Hopper.

Module layout and public names follow the JAX package ``gnntf_tpu``, so
each part has an obvious counterpart there.  Entry points take a ``device``
argument that defaults to ``"cuda"`` and raise when no GPU is available;
pass ``device="cpu"`` to run on the CPU, where the hand-written kernels are
replaced by their plain PyTorch versions.
"""
import torch

# float32 means float32: no TF32 in matrix products or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import measures  # noqa: E402
from .graph import (Graph, add_self_loops, bandwidth, from_edges,  # noqa: E402
                    graph2adj, graph2indices, permute_graph, rcm_order)
from .interop import params_from_jax  # noqa: E402
from .measures import acc, next_seed, set_seed  # noqa: E402
from .models import APPNP, GNN, PPRIteration  # noqa: E402
from .nn import Dense, Dropout, Forward, Layer, Network, ParamSpec  # noqa: E402
from .ops import (dropout, edge_dot, normalize_adjacency,  # noqa: E402
                  sddmm, set_spmm_impl, spmm, spmm_impl)
from .tasks import NodeClassification, Predictor  # noqa: E402
from .train import Trainable, fit, keras_adam  # noqa: E402

__version__ = "0.1.0"
