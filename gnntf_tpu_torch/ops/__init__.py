from .blocked import (BlockedCOO, BlockedSpMM, EdgeList, block_coo,
                      blocked_spmm, blocked_spmm_plain, scatter_values,
                      spmm_pallas)
from .dropout import dropout
from .ell_gather import (ell_edge_list, ell_gather, ell_gather_list,
                         ell_gather_plain, ell_list)
from .normalize import edge_dropout, normalize_adjacency
from .spmm import (PreparedSpMM, build_ell, build_hybrid, prepare,
                   set_spmm_impl, spmm, spmm_impl, spmm_segment)
