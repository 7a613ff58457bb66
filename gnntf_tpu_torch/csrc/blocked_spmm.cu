// K2: the blocked-COO SpMM, as an edge-balanced walk over per-edge lists.
//
// Replaces the TPU kernel gnntf_tpu/ops/pallas/spmm.py::_kernel (driven by
// _spmm_blocked and spmm_pallas), and runs the backward's A^T dy as well.
// Over one CSR list (ptr, idx, eid) of n rows, built on the host from the
// BlockedCOO layout (gnntf_tpu_torch/ops/blocked.py::edge_lists):
//
//     out[r] = sum_{ptr[r] <= e < ptr[r+1]} val[eid[e]] * x[idx[e]]
//
// with eid[e] = e when eid is null.  The forward list holds A (rows are
// destinations, idx the sources); the transposed list holds A^T.  `val` is
// the graph's (E,) float32 values in its own edge order.  The TPU kernel's
// one-hot gather and scatter matmuls exist only because its compiler offers
// no gather from fast memory; here each edge is gathered directly, and the
// layout's padding slots never reach the card.
//
// Bound.  Two flops per edge and feature are far below the card's fp32
// rate, so memory bounds the kernel.  The compulsory bytes are the list
// (ptr, 4 B a row; idx and val, 8 B an edge; eid, 4 B more, only where it
// is read), the referenced x rows read once and out written once.  On the
// RCM-reordered bench graph's forward list at F = 40 (2,332,478 edges, N =
// 169,343): 0.7 + 18.7 + 27.1 + 27.1 MB = 73.5 MB, 21.9 us at 3.35 TB/s.
// x (27 MB at F = 40) fits in the 50 MB L2, so the 373 MB of row gathers
// are mostly L2 hits.
//
// Design.  The edge-balanced walk of edge_walk.cuh in store mode, with no
// row ids: every row of the list is stored once (rows without edges as
// zeros), so out is never zero-filled.  One bench row holds 27% of the
// edges; it is cut into pieces of about 128 items that the walk sums apart
// and the fix-up adds in a fixed order.
#include "edge_walk.cuh"

namespace {

using edge_walk::Args;

template <typename T>
__global__ void __launch_bounds__(edge_walk::kThreads, edge_walk::kMinBlocks)
    blocked_spmm_walk(const Args a) {
  edge_walk::walk<T, false>(a);
}

template <typename T>
__global__ void __launch_bounds__(32) blocked_spmm_parts(const Args a) {
  edge_walk::parts<T>(a);
}

template <typename T>
__global__ void __launch_bounds__(32) blocked_spmm_fixup(const Args a) {
  edge_walk::fixup<T, false>(a);
}

}  // namespace

// out (n, f) float32 needs no zero-fill; carry (n_units + n_split * parts,
// f) float32 is scratch, needed only when n_split > 0; eid may be null (the
// identity); rows is ignored (K2 stores row r at r); part_item holds the
// fix-up's n_part_items items.  vec is 4 (float4 loads; f % 4 == 0, x
// 16-byte aligned) or 1; group is the lanes per unit, min(32, f / vec);
// parts is the number of parts a split row's pieces are summed in.
// Launches on `stream` and returns a CUDA error code (0 on success).
extern "C" int gnntf_blocked_spmm(
    const void* ptr, const void* idx, const void* eid, const void* rows,
    const void* unit_row, const void* unit_edge, const void* split,
    const void* part_item, const void* val, const void* x, void* out,
    void* carry, int n_units, int n_split, int n_part_items, int f,
    int vec, int group, int parts, void* stream) {
  (void)rows;
  const Args a = edge_walk::make_args(
      ptr, idx, eid, nullptr, unit_row, unit_edge, split, part_item, val, x,
      out, carry, n_units, n_split, n_part_items, f, vec, group, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return edge_walk::launch(blocked_spmm_walk<float4>,
                             blocked_spmm_parts<float4>,
                             blocked_spmm_fixup<float4>, a, s);
  return edge_walk::launch(blocked_spmm_walk<float>, blocked_spmm_parts<float>,
                           blocked_spmm_fixup<float>, a, s);
}

extern "C" const char* gnntf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
