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
// and the fix-up adds in a fixed order.  The host sizes a list's units
// from its item count (ops/blocked.py::unit_items): a small list gets small
// units, so that its walk spreads over the SMs.
//
// Narrow rows.  Where a group would have fewer than kNarrowLanes lanes
// (fewer than 8 vectors a row: the degree walk's F = 1, F = 7 classes),
// edge_walk's walk leaves most of a warp idle and chains a unit's loads a
// few edges at a time (one edge at a time at F = 1).  blocked_spmm_walk_narrow
// takes those widths instead: a warp a unit, its lanes over edges as well
// as elements, so a batch of 32 edges' gathers are all in flight at once.
// It sums each row in edge order with the same roundings, so its result is
// bit for bit the wide walk's and the plain version's.  At Cora's scale
// (10,556 edges) neither bound holds it: the bytes take 0.04-0.4 us at
// 3.35 TB/s, while a launch and a warp's chain of dependent loads (the
// unit, its edges, their x rows) take ~4-6 us; small units keep that chain
// to one batch.
//
// bfloat16 mode (the TPU kernel's bf16=True, spmm_pallas(bf16=True)).  x
// comes as bfloat16 (the wrapper casts it once a call) and each term is
//
//     fp32(bf16_rn(fp32(val[e] * fp32(x[idx[e]])))),
//
// the JAX package's G * vals in float32 rounded to bfloat16, added to the
// row's float sum in edge order; out, the pieces and the fix-up stay float,
// so a row's sum is the plain version's (ops/blocked.py::
// blocked_spmm_bf16_plain) bit for bit.  Bound at F = 40 on the RCM bench
// graph's forward list: ptr 0.68 MB, idx and val 18.66 MB, bfloat16 x 13.55
// MB, float out 27.09 MB: 59.98 MB, 17.9 us at 3.35 TB/s (the cast before
// it, 27.09 MB read and 13.55 MB written, 12.1 us, is a pass of its own).
// Three walks take it; the host picks by width, alignment and the list's
// edges (ops/blocked.py::bf16_plan):
//
// - the staged walk (gnntf_blocked_spmm_bf16_staged; bf16_walk.cuh): a
//   group of F / 4 lanes a unit, its x rows copied by 16-byte cp.async
//   copies into a ring of batches in shared memory, spread over several
//   edges an instruction, and summed out of it in edge order, two terms a
//   packed conversion.  It takes F % 8 == 0, 16 <= F <= 40, x and out
//   16-byte aligned, and the host gives it lists large enough for it to
//   win;
// - the share walk (gnntf_blocked_spmm_bf16_share; share_walk.cuh): equal
//   shares of the list's edges, a group of F / 8 lanes a run of
//   consecutive edges, each lane one 16-byte load of 8 bfloat16 an edge,
//   split rows folded across blocks by a second kernel in a fixed order.
//   It takes F % 8 == 0, 64 <= F <= 256, x and out 16-byte aligned, on the
//   lists where it measured faster than the generic walk;
// - the generic walk (gnntf_blocked_spmm_bf16; edge_walk.cuh's walk over
//   loads of X): a lane loads vec bfloat16 at once (2, 4 or 8, or 1) and
//   keeps vec float sums (T); rows of fewer than kNarrowLanes loads take
//   the narrow walk, as in the float walk.  It takes the rest.  Its
//   gathers hit L2 at F = 40 and wait on their chain (0.1049 ms of device
//   time, 17% of the bound; PERF.md), which is what the staged walk was
//   designed against.

#include "bf16_walk.cuh"
#include "edge_walk.cuh"
#include "share_walk.cuh"

namespace {

using edge_walk::Args;
using edge_walk::add_into;
using edge_walk::bf16x4;
using edge_walk::bf16x8;
using edge_walk::float8;
using edge_walk::set_zero;

// groups of fewer lanes than this take the narrow walk
constexpr int kNarrowLanes = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T, typename X = T>
__global__ void __launch_bounds__(edge_walk::kThreads, edge_walk::kMinBlocks)
    blocked_spmm_walk(const Args a) {
  edge_walk::walk<T, false, X>(a);
}

template <typename T>
__global__ void __launch_bounds__(32) blocked_spmm_parts(const Args a) {
  edge_walk::parts<T>(a);
}

template <typename T>
__global__ void __launch_bounds__(32) blocked_spmm_fixup(const Args a) {
  edge_walk::fixup<T, false>(a);
}

__device__ __forceinline__ float product(float w, float v) {
  return __fmul_rn(w, v);
}
__device__ __forceinline__ float4 product(float w, float4 v) {
  return make_float4(__fmul_rn(w, v.x), __fmul_rn(w, v.y), __fmul_rn(w, v.z),
                     __fmul_rn(w, v.w));
}
// the bfloat16 mode's terms (edge_walk::term)
template <typename X>
__device__ __forceinline__ auto product(float w, const X& v) {
  return edge_walk::term(w, v);
}

__device__ __forceinline__ float shuffle(float v, int from) {
  return __shfl_sync(kFull, v, from);
}
__device__ __forceinline__ float4 shuffle(float4 v, int from) {
  return make_float4(shuffle(v.x, from), shuffle(v.y, from),
                     shuffle(v.z, from), shuffle(v.w, from));
}
__device__ __forceinline__ float2 shuffle(float2 v, int from) {
  return make_float2(shuffle(v.x, from), shuffle(v.y, from));
}
__device__ __forceinline__ float8 shuffle(const float8& v, int from) {
  return float8{shuffle(v.lo, from), shuffle(v.hi, from)};
}

// The narrow walk over rows of FV < kNarrowLanes elements of T (float or
// float4; in the bfloat16 mode T is float, float2, float4 or float8 and x
// holds X, its loads), a warp a unit (a run of whole rows, or a piece of a
// split row; ops/blocked.py::work_units).  Lane l loads the idx/val of edge
// l of a batch of 32, then the batch's x rows are gathered in kRounds
// rounds: in round r lane l takes element l % FV of edge r * kEdges + l /
// FV, rounds the product w * x (__fmul_rn; the bfloat16 mode's term) and
// keeps it.  All of a batch's gathers are issued
// before its sum, and the next batch's idx/val load meanwhile.  The products
// then pass through __shfl_sync in edge order to every lane of their element,
// which adds each to its row sum (__fadd_rn), so the sum of a row, or of a
// piece, has the roundings of edge_walk's mul_add in edge order: the plain
// version's.  The unit's row ends are loaded 32 at a time, one a lane, and
// read through __shfl_sync as the walk passes rows.  Lanes 0..FV-1 store a
// row; the rows without edges after the unit's last edge are stored as zeros
// by the warp's lanes, kEdges rows at a time.  All control flow that
// reaches a __shfl_sync is the same over the warp (n, row and row_end are).
template <typename T, int FV, typename X = T>
__global__ void __launch_bounds__(edge_walk::kThreads, edge_walk::kMinBlocks)
    blocked_spmm_walk_narrow(const Args a) {
  constexpr int kEdges = 32 / FV;                      // edges a round
  constexpr int kRounds = (32 + kEdges - 1) / kEdges;  // rounds a batch
  const long long unit =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (unit >= a.n_units) return;
  const int lane = threadIdx.x & 31;
  const int j = lane % FV, q = lane / FV;
  const X* __restrict__ x = static_cast<const X*>(a.x);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int32_t* __restrict__ idx = a.idx;
  const int32_t* __restrict__ eid = a.eid;
  const float* __restrict__ val = a.val;
  const int head = a.unit_row[unit];
  const bool piece = head < 0;
  int r1 = a.unit_row[unit + 1];
  r1 = r1 < 0 ? ~r1 : r1;
  const int e0 = a.unit_edge[unit], e1 = a.unit_edge[unit + 1];
  int row = piece ? ~head : head;
  // lane l holds the end of row first + l (rows of this unit only)
  int first = row;
  int ends = INT_MAX;
  if (!piece && row + lane < r1) ends = a.ptr[row + lane + 1];
  int row_end = piece ? INT_MAX : __shfl_sync(kFull, ends, 0);
  T acc;
  set_zero(acc);
  int next_src = 0;
  float next_w = 0.f;
  if (e0 + lane < e1) {
    next_src = idx[e0 + lane];
    next_w = val[eid ? eid[e0 + lane] : e0 + lane];
  }
  for (int b = e0; b < e1; b += 32) {
    const int n = min(32, e1 - b);
    const int my_src = next_src;
    const float my_w = next_w;
    const int pe = b + 32 + lane;
    if (pe < e1) {
      next_src = idx[pe];
      next_w = val[eid ? eid[pe] : pe];
    }
    T p[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int k = r * kEdges + q;  // the batch's edge this lane gathers
      const int from = min(k, 31);
      const int s = __shfl_sync(kFull, my_src, from);
      const float w = __shfl_sync(kFull, my_w, from);
      set_zero(p[r]);
      if (q < kEdges && k < n) p[r] = product(w, x[(long long)s * FV + j]);
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
#pragma unroll
      for (int t = 0; t < kEdges; ++t) {
        const int k = r * kEdges + t;
        if (k < 32 && k < n) {
          const T v = shuffle(p[r], t * FV + j);
          while (b + k >= row_end) {  // rows ending before edge b + k
            if (lane < FV) out[(long long)row * FV + j] = acc;
            set_zero(acc);
            ++row;
            if (row - first == 32) {
              first = row;
              ends = row + lane < r1 ? a.ptr[row + lane + 1] : INT_MAX;
            }
            row_end = __shfl_sync(kFull, ends, row - first);
          }
          add_into(acc, v);
        }
      }
    }
  }
  if (piece) {
    if (lane < FV) static_cast<T*>(a.carry)[unit * FV + j] = acc;
    return;
  }
  // the last row, then the rows without edges after it
  if (lane < FV) out[(long long)row * FV + j] = acc;
  if (q < kEdges) {
    T zero;
    set_zero(zero);
    for (int r = row + 1 + q; r < r1; r += kEdges)
      out[(long long)r * FV + j] = zero;
  }
}

// The narrow walk at FV, then edge_walk's parts and fix-up (their groups of
// a.group = FV lanes), on `stream`.
template <typename T, int FV, typename X>
int launch_narrow(const Args& a, cudaStream_t stream) {
  blocked_spmm_walk_narrow<T, FV, X>
      <<<edge_walk::group_blocks(a.n_units, 32, edge_walk::kThreads),
         edge_walk::kThreads, 0, stream>>>(a);
  return edge_walk::finish(blocked_spmm_parts<T>, blocked_spmm_fixup<T>, a,
                           stream);
}

template <typename T, typename X = T>
int narrow(const Args& a, cudaStream_t stream) {
  static_assert(kNarrowLanes == 8, "one case a width below kNarrowLanes");
  switch (a.fv) {
    case 1: return launch_narrow<T, 1, X>(a, stream);
    case 2: return launch_narrow<T, 2, X>(a, stream);
    case 3: return launch_narrow<T, 3, X>(a, stream);
    case 4: return launch_narrow<T, 4, X>(a, stream);
    case 5: return launch_narrow<T, 5, X>(a, stream);
    case 6: return launch_narrow<T, 6, X>(a, stream);
    case 7: return launch_narrow<T, 7, X>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 mode's generic walk at sums of T over loads of X: the narrow
// walk below kNarrowLanes lanes, else the wide walk.
template <typename T, typename X>
int generic_walk(const Args& a, cudaStream_t stream) {
  if (a.group < kNarrowLanes) return narrow<T, X>(a, stream);
  return edge_walk::launch(blocked_spmm_walk<T, X>, blocked_spmm_parts<T>,
                           blocked_spmm_fixup<T>, a, stream);
}

// The staged walk (bf16_walk.cuh): kDepth batches of `rows` edges in its
// ring.
template <int kDepth>
__global__ void __launch_bounds__(bf16_walk::kThreads)
    blocked_spmm_bf16_walk(const Args a, int f, int rows) {
  bf16_walk::walk<kDepth>(a, f, rows);
}

// The staged walk, then edge_walk's parts and fix-up over float4 sums.
int staged(const Args& a, int f, int depth, int rows, cudaStream_t s) {
  const long long smem = bf16_walk::smem_bytes(f, depth, rows);
  if (f % 8 || f < bf16_walk::kMinF || f > bf16_walk::kMaxF ||
      a.fv != f / 4 || a.group != bf16_walk::pair_lanes(f) || rows < 1 ||
      rows > bf16_walk::kEdges * bf16_walk::pair_lanes(f) ||
      (depth * rows) % 4 || smem > bf16_walk::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int rc;
  switch (depth) {
    case 2:
      rc = bf16_walk::launch_walk(blocked_spmm_bf16_walk<2>, a, f, rows,
                                  smem, s);
      break;
    case 3:
      rc = bf16_walk::launch_walk(blocked_spmm_bf16_walk<3>, a, f, rows,
                                  smem, s);
      break;
    case 4:
      rc = bf16_walk::launch_walk(blocked_spmm_bf16_walk<4>, a, f, rows,
                                  smem, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return edge_walk::finish(blocked_spmm_parts<float4>,
                           blocked_spmm_fixup<float4>, a, s);
}

// The share walk (share_walk.cuh) at groups of L lanes, and its fold of
// the rows that cross a block's end.
template <int L>
__global__ void __launch_bounds__(share_walk::kThreads,
                                  share_walk::kMinBlocks)
    blocked_spmm_bf16_share_walk(const share_walk::Args a) {
  share_walk::walk<L>(a);
}

__global__ void __launch_bounds__(32 * share_walk::kFoldWarps)
    blocked_spmm_bf16_share_fold(const share_walk::Args a) {
  share_walk::fold(a);
}

const share_walk::Kernel kShareWalks[3] = {blocked_spmm_bf16_share_walk<8>,
                                           blocked_spmm_bf16_share_walk<16>,
                                           blocked_spmm_bf16_share_walk<32>};

}  // namespace

// out (n, f) float32 needs no zero-fill; carry (n_units + n_split * parts,
// f) float32 is scratch, needed only when n_split > 0; eid may be null (the
// identity); rows is ignored (K2 stores row r at r); part_item holds the
// fix-up's n_part_items items.  vec is 4 (float4 loads; f % 4 == 0, x
// 16-byte aligned) or 1; group is the lanes per unit, min(32, f / vec), and
// below kNarrowLanes selects the narrow walk (a warp a unit); parts is the
// number of parts a split row's pieces are summed in.  Launches on `stream`
// and returns a CUDA error code (0 on success).
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
  if (group < kNarrowLanes)
    return vec == 4 ? narrow<float4>(a, s) : narrow<float>(a, s);
  if (vec == 4)
    return edge_walk::launch(blocked_spmm_walk<float4>,
                             blocked_spmm_parts<float4>,
                             blocked_spmm_fixup<float4>, a, s);
  return edge_walk::launch(blocked_spmm_walk<float>, blocked_spmm_parts<float>,
                           blocked_spmm_fixup<float>, a, s);
}

// K2's bfloat16 mode's generic walk: x (n, f) bfloat16, out (n, f)
// float32; vec is 8, 4 or 2 (loads of that many bfloat16: f % vec == 0, x
// aligned to 2 * vec bytes and out to 4 * vec, 16 at most) or 1; group is
// min(32, f / vec), below kNarrowLanes the narrow walk; the other arguments
// are as gnntf_blocked_spmm's.
extern "C" int gnntf_blocked_spmm_bf16(
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
  switch (vec) {
    case 8: return generic_walk<float8, bf16x8>(a, s);
    case 4: return generic_walk<float4, bf16x4>(a, s);
    case 2: return generic_walk<float2, __nv_bfloat162>(a, s);
    case 1: return generic_walk<float, __nv_bfloat16>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K2's bfloat16 mode's staged walk: x (n, f) bfloat16 and out (n, f)
// float32, both 16-byte aligned, f % 8 == 0 and 16 <= f <= 40; vec is 4 and
// group f / 4 (a lane's float4 of sums and the lanes a unit, in the walk
// and in the parts and fix-up); depth is the batches in the ring (2, 3 or
// 4) and rows the edges a batch (1 to 8 * f / 4, depth * rows a multiple
// of 4, the block's rings within 48 KB); the other arguments are as
// gnntf_blocked_spmm's.
extern "C" int gnntf_blocked_spmm_bf16_staged(
    const void* ptr, const void* idx, const void* eid, const void* rows,
    const void* unit_row, const void* unit_edge, const void* split,
    const void* part_item, const void* val, const void* x, void* out,
    void* carry, int n_units, int n_split, int n_part_items, int f,
    int vec, int group, int parts, int depth, int rows_a_batch,
    void* stream) {
  (void)rows;
  if (vec != 4) return (int)cudaErrorInvalidValue;
  const Args a = edge_walk::make_args(
      ptr, idx, eid, nullptr, unit_row, unit_edge, split, part_item, val, x,
      out, carry, n_units, n_split, n_part_items, f, vec, group, parts);
  return staged(a, f, depth, rows_a_batch, static_cast<cudaStream_t>(stream));
}

// K2's bfloat16 mode's share walk: x (n_in, f) bfloat16 and out (n_rows,
// f) float32, both 16-byte aligned, f % 8 == 0 and 64 <= f <= 256; val the
// values by edge id, eid may be null (the identity); carry_in and carry_out
// (n_blocks, f) float32 and col_in (n_blocks,) int32 are scratch, n_blocks
// = max(1, ceil(n_edges / share)); share and fold_range are the host's
// constants, checked against the kernel's; folds says whether a row
// crosses a block's share (else the fold is not launched).  Launches on
// `stream` and returns a CUDA error code (0 on success).
extern "C" int gnntf_blocked_spmm_bf16_share(
    const void* ptr, const void* idx, const void* eid, const void* val,
    const void* x, void* out, void* carry_in, void* carry_out, void* col_in,
    int n_rows, int n_edges, int n_blocks, int f, int share, int fold_range,
    int folds, void* stream) {
  return share_walk::launch(
      kShareWalks, blocked_spmm_bf16_share_fold, ptr, idx, eid, val, x, out,
      carry_in, carry_out, col_in, n_rows, n_edges, n_blocks, f, share,
      fold_range, folds != 0, static_cast<cudaStream_t>(stream));
}

extern "C" const char* gnntf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
