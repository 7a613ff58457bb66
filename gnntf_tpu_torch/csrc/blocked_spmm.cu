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
// Design.  Work is balanced by edges, not by rows: one bench row holds 27% of
// the edges.  The host cuts each list into units of about `items` items (an
// edge or a row end): a run of whole rows, or a piece of at most `items`
// edges of a longer row (ops/blocked.py::work_units).  A group of `group`
// lanes (F / 4 lanes with float4 loads at F = 40, so 3 groups a warp and 2
// lanes idle; 32 lanes at F >= 128) takes one unit.  It loads a batch of
// idx/val with one coalesced load, one edge a lane, passes the entries out
// with __shfl_sync, and keeps kUnroll gathers of x rows in flight; the lanes
// span the features with 16-byte loads.  Row sums stay in fp32 registers and
// each row of a run is written once, with a plain store, when its end is
// reached; rows without edges are written as zeros, so out is never
// zero-filled.  There are no atomics, no shared memory and no block syncs in
// the edge loop.  A piece writes its sum to `carry`.  A split row's pieces
// are then summed in `parts` parts: a second kernel gives each (split row,
// part) a group of lanes, which sums pieces g, g + parts, ... in turn, so
// the hub row's pieces spread over the card; a third adds each row's parts
// in order and stores the row.  The caller fixes `parts`
// (ops/blocked.py::_FIXUP_PARTS) and the plain version repeats that order;
// the launch geometry does not change it, so the result is the same from
// launch to launch and on the CPU.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// gathers of x rows a group keeps in flight (k2_sweep.py builds others)
#ifndef K2_UNROLL
#define K2_UNROLL 4
#endif
constexpr int kUnroll = K2_UNROLL;
// loads in flight in the fix-up's sums
constexpr int kSumLoads = 16;

__device__ __forceinline__ void set_zero(float& a) { a = 0.f; }
__device__ __forceinline__ void set_zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}

// acc += w * v, rounding the product and the sum apart (no fused
// multiply-add), as the plain version's index_add_ does: a row summed in one
// unit is then bit-equal to the plain version's sum in edge order.
__device__ __forceinline__ void mul_add(float& acc, float w, float v) {
  acc = __fadd_rn(acc, __fmul_rn(w, v));
}
__device__ __forceinline__ void mul_add(float4& acc, float w, float4 v) {
  mul_add(acc.x, w, v.x);
  mul_add(acc.y, w, v.y);
  mul_add(acc.z, w, v.z);
  mul_add(acc.w, w, v.w);
}

__device__ __forceinline__ void add_into(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add_into(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// p[0] + p[stride] + ... + p[(n-1) * stride], added in that order, with
// kSumLoads loads in flight.
template <typename T>
__device__ __forceinline__ T ordered_sum(const T* __restrict__ p,
                                         long long stride, int n) {
  T acc;
  set_zero(acc);
  for (int k = 0; k < n; k += kSumLoads) {
    T v[kSumLoads];
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u)
      if (k + u < n) v[u] = p[(long long)(k + u) * stride];
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u)
      if (k + u < n) add_into(acc, v[u]);
  }
  return acc;
}

// The group of lanes of this thread and its item (unit, part or split row),
// as blocked_spmm_walk maps them: `group` lanes an item, 32 / group items a
// warp.  Returns -1 for idle lanes and lanes past the last item.
__device__ __forceinline__ long long group_item(int group, long long n_items,
                                                int& lane) {
  const int per_warp = 32 / group;
  const int wl = threadIdx.x & 31;
  const int sub = wl / group;
  lane = wl - sub * group;
  const long long item =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32 * per_warp +
      sub;
  return sub < per_warp && item < n_items ? item : -1;
}

// T is float or float4; fv = F / (floats in T).  Unit u holds edges
// unit_edge[u] .. unit_edge[u+1]; unit_row[u] is its first row, or ~row for a
// piece of a split row.
template <typename T>
__global__ void __launch_bounds__(kThreads) blocked_spmm_walk(
    const int32_t* __restrict__ ptr, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ eid, const float* __restrict__ val,
    const int32_t* __restrict__ unit_row,
    const int32_t* __restrict__ unit_edge, const T* __restrict__ x,
    T* __restrict__ out, T* __restrict__ carry, int n_units, int fv,
    int group) {
  int lane;
  const long long unit = group_item(group, n_units, lane);
  if (unit < 0) return;
  const int lane0 = (threadIdx.x & 31) - lane;
  const unsigned mask =
      group == 32 ? 0xffffffffu : ((1u << group) - 1u) << lane0;
  const int head = unit_row[unit];
  const bool piece = head < 0;
  int r1 = unit_row[unit + 1];
  r1 = r1 < 0 ? ~r1 : r1;
  const int e0 = unit_edge[unit], e1 = unit_edge[unit + 1];

  for (int j0 = 0; j0 < fv; j0 += group) {
    const int j = j0 + lane;
    const bool on = j < fv;
    T acc;
    set_zero(acc);
    int row = piece ? ~head : head;
    int row_end = piece ? INT_MAX : ptr[row + 1];
    // one batch of `group` edges, one a lane: the next batch's idx/val are
    // loaded while this one's x rows are gathered
    int next_src = 0;
    float next_w = 0.f;
    if (e0 + lane < e1) {
      next_src = idx[e0 + lane];
      next_w = val[eid ? eid[e0 + lane] : e0 + lane];
    }
    for (int b = e0; b < e1; b += group) {
      const int n = min(group, e1 - b);
      const int my_src = next_src;
      const float my_w = next_w;
      const int pe = b + group + lane;
      if (pe < e1) {
        next_src = idx[pe];
        next_w = val[eid ? eid[pe] : pe];
      }
      for (int k = 0; k < n; k += kUnroll) {
        T a[kUnroll];
        float w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int from = lane0 + min(k + u, n - 1);
          const int s = __shfl_sync(mask, my_src, from);
          w[u] = __shfl_sync(mask, my_w, from);
          set_zero(a[u]);
          if (on && k + u < n) a[u] = x[(long long)s * fv + j];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k + u < n) {
            const int e = b + k + u;
            while (e >= row_end) {  // rows ending before edge e
              if (on) out[(long long)row * fv + j] = acc;
              set_zero(acc);
              ++row;
              row_end = ptr[row + 1];
            }
            mul_add(acc, w[u], a[u]);
          }
        }
      }
    }
    if (piece) {
      if (on) carry[unit * fv + j] = acc;
    } else {
      for (; row < r1; ++row) {  // the last row, then rows without edges
        if (on) out[(long long)row * fv + j] = acc;
        set_zero(acc);
      }
    }
  }
}

// Item g * n_split + s: part g of split row s, the sum of its pieces g, g
// + parts, ... in turn (the pieces are the units split[3s+1] ..
// split[3s+1] + split[3s+2] - 1), into part_sum[s * parts + g].  Items are
// part-major, so the parts of the hub row fall in blocks far apart, on
// many SMs.
template <typename T>
__global__ void __launch_bounds__(kThreads) blocked_spmm_parts(
    const int32_t* __restrict__ split, const T* __restrict__ carry,
    T* __restrict__ part_sum, int n_split, int fv, int group, int parts) {
  int lane;
  const long long item =
      group_item(group, (long long)n_split * parts, lane);
  if (item < 0) return;
  const int g = (int)(item / n_split);
  const long long s = item - (long long)g * n_split;
  const long long first = split[3 * s + 1];
  const int count = split[3 * s + 2];
  const int n = count > g ? (count - g + parts - 1) / parts : 0;
  for (int j = lane; j < fv; j += group)
    part_sum[(s * parts + g) * fv + j] = ordered_sum(
        carry + (first + g) * fv + j, (long long)parts * fv, n);
}

// Item s: split row split[3s], its parts added in order and stored.
// Launched in blocks of one warp, so the rows spread over the SMs.
template <typename T>
__global__ void __launch_bounds__(32) blocked_spmm_fixup(
    const int32_t* __restrict__ split, const T* __restrict__ part_sum,
    T* __restrict__ out, int n_split, int fv, int group, int parts) {
  int lane;
  const long long s = group_item(group, n_split, lane);
  if (s < 0) return;
  const long long row = split[3 * s];
  for (int j = lane; j < fv; j += group)
    out[row * fv + j] = ordered_sum(part_sum + s * parts * fv + j, fv, parts);
}

// blocks of `threads` for n_items items of `group` lanes
unsigned group_blocks(long long n_items, int group, int threads) {
  const int per_warp = 32 / group;
  const long long warps = (n_items + per_warp - 1) / per_warp;
  return (unsigned)((warps * 32 + threads - 1) / threads);
}

template <typename T>
int launch(const void* ptr, const void* idx, const void* eid,
           const void* val, const void* unit_row, const void* unit_edge,
           const void* split, const void* x, void* out, void* carry,
           int n_units, int n_split, int fv, int group, int parts,
           cudaStream_t stream) {
  blocked_spmm_walk<T><<<group_blocks(n_units, group, kThreads), kThreads, 0,
                         stream>>>(
      static_cast<const int32_t*>(ptr), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(eid), static_cast<const float*>(val),
      static_cast<const int32_t*>(unit_row),
      static_cast<const int32_t*>(unit_edge), static_cast<const T*>(x),
      static_cast<T*>(out), static_cast<T*>(carry), n_units, fv, group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 0) return (int)err;
  if (parts < 1) return (int)cudaErrorInvalidValue;
  const int32_t* sp = static_cast<const int32_t*>(split);
  T* part_sum = static_cast<T*>(carry) + (long long)n_units * fv;
  blocked_spmm_parts<T><<<group_blocks((long long)n_split * parts, group,
                                       kThreads), kThreads, 0, stream>>>(
      sp, static_cast<const T*>(carry), part_sum, n_split, fv, group, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blocked_spmm_fixup<T><<<group_blocks(n_split, group, 32), 32, 0, stream>>>(
      sp, part_sum, static_cast<T*>(out), n_split, fv, group, parts);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n, f) float32 needs no zero-fill; carry (n_units + n_split * parts,
// f) float32 is scratch, needed only when n_split > 0; eid may be null (the
// identity).
// vec is 4 (float4 loads; f % 4 == 0, x 16-byte aligned) or 1; group is
// the lanes per unit, min(32, f / vec); parts is the number of parts a
// split row's pieces are summed in.  Launches on `stream` and returns a
// CUDA error code (0 on success).
extern "C" int gnntf_blocked_spmm(const void* ptr, const void* idx,
                                  const void* eid, const void* val,
                                  const void* unit_row, const void* unit_edge,
                                  const void* split, const void* x, void* out,
                                  void* carry, int n_units, int n_split,
                                  int f, int vec, int group, int parts,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return launch<float4>(ptr, idx, eid, val, unit_row, unit_edge, split, x,
                          out, carry, n_units, n_split, f / 4, group, parts,
                          s);
  return launch<float>(ptr, idx, eid, val, unit_row, unit_edge, split, x, out,
                       carry, n_units, n_split, f, group, parts, s);
}

extern "C" const char* gnntf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
