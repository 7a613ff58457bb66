from .attention import (AttnGrids, AttnLists, attn_aggregate,
                        attn_aggregate_plain, attn_bwd_cols,
                        attn_bwd_cols_plain, attn_bwd_rows,
                        attn_bwd_rows_plain, attn_chain, attn_lists,
                        attn_softmax_aggregate,
                        attn_softmax_aggregate_plain, attn_stats,
                        attn_stats_plain, build_attn_grids, gat_attention)
from .blocked import (BlockedCOO, BlockedSpMM, EdgeList, block_coo,
                      blocked_spmm, blocked_spmm_bf16,
                      blocked_spmm_bf16_plain, blocked_spmm_plain,
                      scatter_values, spmm_pallas)
from .dropout import dropout
from .ell_gather import (ell_degree_masked, ell_degree_masked_plain,
                         ell_edge_list, ell_gather, ell_gather_list,
                         ell_gather_masked, ell_gather_masked_plain,
                         ell_gather_plain, ell_gather_scaled,
                         ell_gather_scaled_backward,
                         ell_gather_scaled_backward_plain,
                         ell_gather_scaled_plain, ell_list, whole_list)
from .normalize import edge_dropout, normalize_adjacency
from .segment import segment_softmax
from .spmm import (PreparedSpMM, build_ell, build_hybrid, edge_dot, prepare,
                   prepare_spmm, sddmm, set_spmm_executor, set_spmm_impl,
                   spmm, spmm_ell, spmm_executor, spmm_hybrid, spmm_impl,
                   spmm_segment)
from .stochastic import (TrainGrids, build_train_grids, grid_value_dtype,
                         grids_eligible, min_edges, min_edges_scope,
                         stochastic_degree, stochastic_spmm, train_grids)
