// K1: the ELL gather-reduce with the virtual-row combine fused in, added into
// a base.
//
// Replaces the TPU kernel gnntf_tpu/ops/pallas/dma_gather.py::_kernel and the
// segment_sum over vrow_row that its caller runs after it; together they are
// the computation of _ell_compute (gnntf_tpu/ops/spmm.py), whose result
// PreparedSpMM adds to the hub slice's product:
//
//     out[r] = base[r] + sum_{v : vrow_row[v] == r} sum_{j < k} vals[v, j] *
//                        x[idx[v, j]]
//
// The kernel does not walk the (V, k) grid.  The host keeps its live slots
// in grid order (virtual row, then slot) as a CSR list over the rows that
// have a slot: rows (R,), ptr (R + 1,), idx and val (E,)
// (gnntf_tpu_torch/ops/ell_gather.py::ell_list).  Pad slots and rows
// without a slot never reach the card.
//
// Bound.  Two flops per live slot and feature are far below the card's fp32
// rate, so memory bounds the kernel.  The compulsory bytes are the list
// (ptr and rows, 8 B a held row; idx and val, 8 B a live slot), the
// referenced x rows read once, and the held rows of out read and written
// once.  On the rest ELL of the bench graph at F = 40 (R = 11,857 held rows
// of N = 169,343, 618,044 live slots, 168,912 referenced x rows): 0.1 + 4.9
// + 27.0 + 3.8 MB = 35,859,372 B, 10.7 us at 3.35 TB/s.
//
// Design.  The edge-balanced walk of edge_walk.cuh, with row ids, in
// accumulate mode: each held row's sum is added to out once, with a plain
// load and store, and rows the list does not hold are not touched; so out
// (the hub slice's product, or zeros) needs no zero-fill, there are no
// atomics and no separate add pass.  Of the bench's 11,857 held rows, 110
// hold 85% of the slots and the heaviest 164,744; units of `items` items
// (ops/ell_gather.py::_UNIT_ITEMS, smaller than K2's, as the list is a
// quarter of K2's) spread them over the card, and the fix-up adds a split
// row's pieces in the same fixed order as K2's.
//
// The scaled walk (ell_gather_scaled_walk, the design of scaled_walk.cuh)
// is the prepared operator's whole product on the H100 (ops/spmm.py::
// PreparedSpMM under `auto`), where the JAX package runs ell + dense @
// x[hubs] and the scales around it.  The dense hub slice existed for the
// TPU, whose SpMM is bound by its gather unit's issue rate; the H100 has no
// such limit, and its fp32 matmul over a slice stored at 1.4% density cost
// more than the walk.  So one walk takes every live slot of the hub-free
// ELL, as a CSR list over all N rows (ops/ell_gather.py::whole_list), in
// store mode, and finishes a normalized graph's product in its store:
// out[r] = rs[r] * sum_e val[e] * (cs[c] * x[c]) + w * x[r], the JAX order,
// each product and sum rounded apart.  Every row is written, rows without a
// slot as rs[r] * 0 + w * x[r], so out is neither zero-filled nor read, and
// a split row is finished inside the launch.
// Bound, bytes: the list (ptr 4 B a row; idx and val 8 B a live slot), x
// read once (gathers and identity), rs and cs once, out written once.  On
// the symmetric normalized bench graph at F = 40 (N = 169,343 rows,
// 1,219,880 live slots, no identity): 65,952,920 B, 19.7 us at 3.35 TB/s
// (chip_smoke.py phase 2's scaled_bound).  Units of
// ops/ell_gather.py::_WHOLE_ITEMS items split its 168 longest rows.
// The prepared operator's backward, dx = cs * (A^T (rs * dy)) + w * dy, is
// the same walk (ell_gather_scaled_bwd_walk) over the transposed list, eid
// read, the scales swapped; its bound adds eid's 4 B a slot.
//
// Two more walks carry the training step under the default implementation
// (ops/stochastic.py::TrainGrids, the counterpart of the JAX package's
// TrainGrids.core and stochastic_degree), over the row list (A) or the
// column list (A^T) of every edge, ptr over all N rows, in store mode:
//
// * ell_gather_masked_walk (drop_walk.cuh: a warp stages a tile's kept
//   edges in shared memory, then sums them): out[r] = sum_e w(eid[e]) *
//   x[idx[e]], w the edge's dropped value, hashed in the walk from its id;
//   the step's
//   forward over the row list, its dx = A^T dy over the column list.  Only
//   kept edges' x rows are read, unless pass 0 finds an inf or a NaN in x
//   (then pass 1, ell_gather_masked_nonfinite, walks again reading every
//   edge's, as JAX's product does).
//   Bound: the list (ptr; idx and val of the kept edges; eid of every edge
//   where it is read), the x rows of kept edges once, out once: at F = 40
//   on the bench graph's row list with half of its 2,332,478 edges kept,
//   63,357,536 B, 18.9 us at 3.35 TB/s (chip_smoke.py phase 2c).  The hash
//   is ~21 integer operations an edge, far below the card's rate.
//   It adds a split row's pieces after the walk with edge_walk's parts and
//   fix-up kernels (ell_gather_masked_parts/_fixup).
// * ell_degree_share_walk (degree_walk.cuh: equal shares of the list's
//   edges, a segmented sum): deg[r] = sum_e w(eid[e]), no x: the dropped
//   graph's column (or row) sums, with no atomics, the values streamed in
//   list order; ell_degree_share_fold folds the sums of a row that crosses
//   a block's end.  Bound on the bench graph's column list: ptr, eid of
//   every edge, val of the kept ones and deg, 15,352,020 B, 4.6 us.
// Each walk is built for float base values and for bfloat16 ones (V; the
// entry points gnntf_ell_gather_masked_bf16 and gnntf_ell_degree_bf16: the
// training grids of GNNTF_GRID_VALUE_DTYPE=bfloat16, the counterpart of the
// JAX package's bfloat16 value grids), which halve the values' bytes: 2 B
// of the kept edges' 8 and of the degree walk's values.
#include "degree_walk.cuh"
#include "drop_walk.cuh"
#include "edge_walk.cuh"
#include "scaled_walk.cuh"

namespace {

using drop_walk::Mask;
using drop_walk::Pass;
using drop_walk::Tiles;
using edge_walk::Args;
using scaled_walk::Scale;

template <typename T>
__global__ void __launch_bounds__(edge_walk::kThreads, edge_walk::kMinBlocks)
    ell_gather_walk(const Args a) {
  edge_walk::walk<T, true>(a);
}

template <typename T>
__global__ void __launch_bounds__(32) ell_gather_parts(const Args a) {
  edge_walk::parts<T>(a);
}

template <typename T>
__global__ void __launch_bounds__(32) ell_gather_fixup(const Args a) {
  edge_walk::fixup<T, true>(a);
}

// The scaled walk (scaled_walk.cuh), and its twin for the prepared
// operator's backward, the same code under a name of its own so a profile
// tells them apart.
template <typename T>
__global__ void __launch_bounds__(scaled_walk::kThreads,
                                  scaled_walk::kMinBlocks)
    ell_gather_scaled_walk(const Args a, const Scale sc, int* counters) {
  scaled_walk::walk<T>(a, sc, counters);
}

template <typename T>
__global__ void __launch_bounds__(scaled_walk::kThreads,
                                  scaled_walk::kMinBlocks)
    ell_gather_scaled_bwd_walk(const Args a, const Scale sc, int* counters) {
  scaled_walk::walk<T>(a, sc, counters);
}

// The scaled walk (the backward's, with kBwd) on `stream`; returns a CUDA
// error code (0 on success).
template <bool kBwd>
int launch_scaled(const Args& a, const Scale& sc, int* counters, int vec,
                  cudaStream_t stream) {
  if (vec == 4)
    return scaled_walk::launch(kBwd ? ell_gather_scaled_bwd_walk<float4>
                                    : ell_gather_scaled_walk<float4>,
                               a, sc, counters, stream);
  return scaled_walk::launch(kBwd ? ell_gather_scaled_bwd_walk<float>
                                  : ell_gather_scaled_walk<float>,
                             a, sc, counters, stream);
}

template <typename T, typename V>
__global__ void __launch_bounds__(drop_walk::kThreads, drop_walk::kMinBlocks)
    ell_gather_masked_walk(const Args a, const Tiles t, const Mask m,
                           const Pass p) {
  drop_walk::walk<T, V>(a, t, m, p);
}

// pass 1 of the masked walk: returns at once unless pass 0 found an inf or
// a NaN in x
template <typename T, typename V>
__global__ void __launch_bounds__(drop_walk::kThreads, drop_walk::kMinBlocks)
    ell_gather_masked_nonfinite(const Args a, const Tiles t, const Mask m,
                                const Pass p) {
  drop_walk::walk<T, V>(a, t, m, p);
}

template <typename T>
__global__ void __launch_bounds__(32) ell_gather_masked_parts(const Args a) {
  edge_walk::parts<T>(a);
}

template <typename T>
__global__ void __launch_bounds__(32) ell_gather_masked_fixup(const Args a) {
  edge_walk::fixup<T, false>(a);
}

template <typename V>
__global__ void __launch_bounds__(degree_walk::kLanes)
    ell_degree_share_walk(const degree_walk::Args a, const Mask m) {
  degree_walk::walk<V>(a, m);
}

__global__ void __launch_bounds__(32 * degree_walk::kFoldWarps)
    ell_degree_share_fold(const degree_walk::Args a) {
  degree_walk::fold(a);
}

}  // namespace

// out (n_out, f) float32 holds the base and gets each held row's sum added;
// rows (R,) are the held rows' ids in out; eid may be null (the identity).
// carry, part_item, vec, group and parts are as gnntf_blocked_spmm's,
// with vec 4 only where x and out are 16-byte aligned.  Launches on `stream`
// and returns a CUDA error code (0 on success).
extern "C" int gnntf_ell_gather(
    const void* ptr, const void* idx, const void* eid, const void* rows,
    const void* unit_row, const void* unit_edge, const void* split,
    const void* part_item, const void* val, const void* x, void* out,
    void* carry, int n_units, int n_split, int n_part_items, int f,
    int vec, int group, int parts, void* stream) {
  const Args a = edge_walk::make_args(
      ptr, idx, eid, rows, unit_row, unit_edge, split, part_item, val, x,
      out, carry, n_units, n_split, n_part_items, f, vec, group, parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return edge_walk::launch(ell_gather_walk<float4>, ell_gather_parts<float4>,
                             ell_gather_fixup<float4>, a, s);
  return edge_walk::launch(ell_gather_walk<float>, ell_gather_parts<float>,
                           ell_gather_fixup<float>, a, s);
}

// The scaled walk in store mode over a list of all n rows: out (n, f)
// float32 gets rs[r] * sum + w * x[r] in every row and needs no zero-fill;
// rs and cs are (n,) float32 or null (a scale of one), w the identity's
// weight; x (n, f) is gathered scaled by cs.  counters (in the place of
// gnntf_ell_gather's rows, which this list has none of) is a set of the
// list's n_split * (parts + 1) int32 counters, zero, which the walk leaves
// zero (null where no row is split), and which no launch running at the
// same time shares: with them a split row is finished inside the walk's
// launch.  The other arguments are as gnntf_ell_gather's.
// gnntf_ell_gather_scaled_t is the same function under the backward's
// kernel name (ell_gather_scaled_bwd_walk, over the transposed list with
// the scales swapped).
#define GNNTF_SCALED_ENTRY(NAME, BWD)                                        \
  extern "C" int NAME(                                                       \
      const void* ptr, const void* idx, const void* eid, void* counters,     \
      const void* unit_row, const void* unit_edge, const void* split,        \
      const void* part_item, const void* val, const void* x, void* out,      \
      void* carry, int n_units, int n_split, int n_part_items, int f,        \
      int vec, int group, int parts, const void* rs, const void* cs,         \
      float w, void* stream) {                                               \
    const Args a = edge_walk::make_args(                                     \
        ptr, idx, eid, nullptr, unit_row, unit_edge, split, part_item, val,  \
        x, out, carry, n_units, n_split, n_part_items, f, vec, group,        \
        parts);                                                              \
    Scale sc;                                                                \
    sc.rs = static_cast<const float*>(rs);                                   \
    sc.cs = static_cast<const float*>(cs);                                   \
    sc.w = w;                                                                \
    return launch_scaled<BWD>(a, sc, static_cast<int*>(counters), vec,      \
                              static_cast<cudaStream_t>(stream));            \
  }
GNNTF_SCALED_ENTRY(gnntf_ell_gather_scaled, false)
GNNTF_SCALED_ENTRY(gnntf_ell_gather_scaled_t, true)

namespace {

// The masked walk over base values of type V (gnntf_ell_gather_masked*).
template <typename V>
int masked(const void* ptr, const void* idx, const void* eid,
           const void* unit_row, const void* unit_edge, const void* split,
           const void* part_item, const void* val, const void* x, void* out,
           void* carry, int n_units, int n_split, int n_part_items, int f,
           int vec, int group, int parts, const Tiles& t, const Mask& m,
           void* flag, long long n_floats, cudaStream_t s) {
  if (flag == nullptr) return (int)cudaErrorInvalidValue;
  const Args a = edge_walk::make_args(
      ptr, idx, eid, nullptr, unit_row, unit_edge, split, part_item, val, x,
      out, carry, n_units, n_split, n_part_items, f, vec, group, parts);
  const long long n_x = n_floats / vec;  // x's T's (float4 or float)
  int* fl = static_cast<int*>(flag);
  if (vec == 4)
    return drop_walk::launch(
        ell_gather_masked_walk<float4, V>,
        ell_gather_masked_nonfinite<float4, V>,
        ell_gather_masked_parts<float4>, ell_gather_masked_fixup<float4>, a,
        t, m, fl, n_x, s);
  return drop_walk::launch(
      ell_gather_masked_walk<float, V>, ell_gather_masked_nonfinite<float, V>,
      ell_gather_masked_parts<float>, ell_gather_masked_fixup<float>, a, t,
      m, fl, n_x, s);
}

}  // namespace

// The masked walk in store mode: out (n, f) float32 needs no zero-fill
// (rows is ignored); val holds the graph's E base values as float (the _bf16
// entry: as bfloat16), read at eid; the tiles (tile_seg, tile_edge,
// seg_end, seg_out, n_tiles, cap_edges, cap_segs) are drop_walk.cuh's
// Tiles; salt (a (2,) int64 device buffer), thresh, n_drop, id_base and
// scale are the draw (drop_walk.cuh, Mask); flag is one int32 of scratch
// on the card and n_floats x's size; carry holds the pieces' and parts'
// sums as gnntf_ell_gather's; the other arguments are as
// gnntf_ell_gather's.
#define GNNTF_MASKED_ENTRY(NAME, V)                                          \
  extern "C" int NAME(                                                       \
      const void* ptr, const void* idx, const void* eid, const void* rows,   \
      const void* unit_row, const void* unit_edge, const void* split,        \
      const void* part_item, const void* val, const void* x, void* out,      \
      void* carry, int n_units, int n_split, int n_part_items, int f,        \
      int vec, int group, int parts, const void* tile_seg,                   \
      const void* tile_edge, const void* seg_end, const void* seg_out,       \
      int n_tiles, int cap_edges, int cap_segs, const void* salt,            \
      unsigned thresh, unsigned n_drop, unsigned id_base, float scale,       \
      void* flag, long long n_floats, void* stream) {                        \
    (void)rows;                                                              \
    return masked<V>(                                                        \
        ptr, idx, eid, unit_row, unit_edge, split, part_item, val, x, out,   \
        carry, n_units, n_split, n_part_items, f, vec, group, parts,         \
        drop_walk::make_tiles(tile_seg, tile_edge, seg_end, seg_out,         \
                              n_tiles, cap_edges, cap_segs),                 \
        drop_walk::make_mask(salt, thresh, n_drop, id_base, scale), flag,    \
        n_floats, static_cast<cudaStream_t>(stream));                        \
  }
GNNTF_MASKED_ENTRY(gnntf_ell_gather_masked, float)
GNNTF_MASKED_ENTRY(gnntf_ell_gather_masked_bf16, __nv_bfloat16)

// The degree walk: out (n_rows,) float32, each list row's sum of its
// dropped weights, needs no zero-fill; ptr (n_rows + 1,) and eid (n_edges,)
// (null: the identity) int32 are the list's; val holds its n_edges base
// values in list order as float (the _bf16 entry: as bfloat16); carry_in,
// carry_out and col_in are (n_blocks,) float32, float32 and int32 scratch
// of this call, n_blocks = max(1, ceil(n_edges / (lanes * edges))); lanes
// and edges must be degree_walk.cuh's; folds says whether a row crosses a
// block's end (then the fold kernel runs after the walk); salt, thresh,
// n_drop, id_base and scale are the draw (drop_walk.cuh, Mask).  Launches
// on `stream` and returns a CUDA error code (0 on success).
#define GNNTF_DEGREE_ENTRY(NAME, V)                                          \
  extern "C" int NAME(const void* ptr, const void* eid, const void* val,     \
                      void* out, void* carry_in, void* carry_out,            \
                      void* col_in, int n_rows, int n_edges, int n_blocks,   \
                      int lanes, int edges, int folds, const void* salt,     \
                      unsigned thresh, unsigned n_drop, unsigned id_base,    \
                      float scale, void* stream) {                           \
    using degree_walk::kShare;                                               \
    const long long want = ((long long)n_edges + kShare - 1) / kShare;      \
    if (lanes != degree_walk::kLanes || edges != degree_walk::kEdges ||      \
        n_rows < 0 || n_edges < 0 ||                                         \
        n_blocks != (want > 1 ? want : 1))                                   \
      return (int)cudaErrorInvalidValue;                                     \
    degree_walk::Args a;                                                     \
    a.ptr = static_cast<const int32_t*>(ptr);                                \
    a.eid = static_cast<const int32_t*>(eid);                                \
    a.val = val;                                                             \
    a.out = static_cast<float*>(out);                                        \
    a.carry_in = static_cast<float*>(carry_in);                              \
    a.carry_out = static_cast<float*>(carry_out);                            \
    a.col_in = static_cast<int32_t*>(col_in);                                \
    a.n_rows = n_rows;                                                       \
    a.n_edges = n_edges;                                                     \
    a.n_blocks = n_blocks;                                                   \
    a.vec = (uintptr_t)val % 16 == 0 && (uintptr_t)eid % 16 == 0;           \
    return degree_walk::launch(                                              \
        ell_degree_share_walk<V>, ell_degree_share_fold, a,                  \
        drop_walk::make_mask(salt, thresh, n_drop, id_base, scale),          \
        folds != 0, static_cast<cudaStream_t>(stream));                      \
  }
GNNTF_DEGREE_ENTRY(gnntf_ell_degree, float)
GNNTF_DEGREE_ENTRY(gnntf_ell_degree_bf16, __nv_bfloat16)

// Whether `stream` is capturing a CUDA graph (*active) and, if it is, the
// capture's id (*id; else 0): the host keys a list's counters on them
// (ops/blocked.py::Counters).  Returns a CUDA error code (0 on success).
extern "C" int gnntf_stream_capture(void* stream, int* active,
                                    unsigned long long* id) {
  cudaStreamCaptureStatus status;
  unsigned long long capture = 0;
  const cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &capture);
  *active = err == cudaSuccess && status == cudaStreamCaptureStatusActive;
  *id = *active ? capture : 0;
  return (int)err;
}

extern "C" const char* gnntf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
