from .appnp import APPNP
from .experimental import (APPNP2, APPNPReg, APPNPThrough, FastReg, GCNIIReg,
                           PPRSweep, StableIteration)
from .gat import GAT, GATLayer
from .gcn import GCN, GCNII, NGCF
from .gnn import GNN, Structural
from .layers import (GCNIILayer, GCNIISpectralPreservingLayer, GCNLayer,
                     GCNSpectralPreservingLayer, NGCFLayer, PPRIteration)
from .mlp import MLP
from .sage import GIN, GINLayer, GraphSAGE, SAGELayer
