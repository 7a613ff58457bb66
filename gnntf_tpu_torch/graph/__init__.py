from .coo import Graph, add_self_loops, from_edges
from .nx_interop import adj2graph, create_nx_graph, graph2adj, graph2indices
from .reorder import bandwidth, permute_graph, rcm_order
