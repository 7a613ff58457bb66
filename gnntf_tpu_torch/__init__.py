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
from .graph import (Graph, add_self_loops, adj2graph,  # noqa: E402
                    bandwidth, create_nx_graph, from_edges, graph2adj,
                    graph2indices, permute_graph, rcm_order)
from .interop import params_from_jax  # noqa: E402
from .measures import (acc, auc, avprec, bootstrap_ci, f1,  # noqa: E402
                       next_seed, prec, rec, set_seed)
from .models import (APPNP, APPNP2, GAT, GCN, GCNII, GIN,  # noqa: E402
                     GNN, MLP, NGCF, APPNPReg, APPNPThrough, FastReg,
                     GATLayer, GCNIILayer, GCNIIReg,
                     GCNIISpectralPreservingLayer, GCNLayer,
                     GCNSpectralPreservingLayer, GINLayer, GraphSAGE,
                     NGCFLayer, PPRIteration, PPRSweep, SAGELayer,
                     StableIteration, Structural)
from .nn import (LSTM, Activation, Branch, Concatenate, Dense,  # noqa: E402
                 Dropout, Forward, Layer, Network, ParamSpec, Resume,
                 Tradeoff, Wrap, batches)
from .ops import (dropout, edge_dot, normalize_adjacency,  # noqa: E402
                  sddmm, segment_softmax, set_spmm_impl, spmm, spmm_impl)
from .tasks import (LinkPrediction, MeanLinkPrediction,  # noqa: E402
                    NodeClassification, Predictor, negative_sampling,
                    recommend_all)
from .train import Trainable, fit, keras_adam  # noqa: E402

# the reference's class names (layered.py / variables.py): the builder
# Network plays both roles
Layered = Network
VariableGenerator = Network
metrics = measures  # the reference exposes its measures module as `metrics`

__version__ = "0.1.0"
