// K1's scaled walk on the H100 (ell_gather.cu's ell_gather_scaled_walk and,
// for the prepared operator's backward, ell_gather_scaled_bwd_walk; entries
// gnntf_ell_gather_scaled and gnntf_ell_gather_scaled_t).
//
// Over a CSR list (ptr, idx, eid) of all n rows, in store mode:
//
//     out[r] = rs[r] * sum_e val[eid[e]] * (cs[idx[e]] * x[idx[e]]) + w * x[r]
//
// each product and sum rounded apart, in the JAX package's order
// (gnntf_tpu/ops/spmm.py, the prepared operator's rs * (A @ (cs * x)) + w *
// x): cs * x, then val * that, the row's terms added in edge order from +0,
// then rs * the sum, then + w * x[r].  A null rs or cs scales by one, w ==
// 0 adds nothing.  The forward walks ops/ell_gather.py::whole_list (A)
// with rs and cs; the backward's dx = cs * (A^T (rs * dy)) + w * dy is the
// same function over the transposed list (ell_transposed_list, values read
// through eid) with the scales swapped: rs gathered, cs stored.  So the
// backward is one launch, where it was a walk and three elementwise passes.
//
// Units, pieces and split rows are edge_walk.cuh's: a group of lanes takes a
// unit (ops/blocked.py::work_units), a piece's sum goes to carry, and a
// split row's pieces are summed in `parts` parts (part g: pieces g, g +
// parts, ... in turn, from +0), then the parts in order, then the epilogue.
// So the result is the plain version's (ops/ell_gather.py::
// ell_gather_scaled_plain) bit for bit, whatever the launch geometry.
//
// The walk is edge_walk.cuh's (a group of F / 4 lanes a unit, a batch of
// `group` slots loaded one a lane and passed out by __shfl_sync, kUnroll x
// rows in flight, a row's end and scale loaded as the sum reaches it), in
// store mode with the scales in its gathers and its store.  Each slot's cs
// is loaded once, by the lane that holds the slot, as its batch begins,
// and passed out with the slot after the batch's gathers are issued (the
// walk it replaced loaded it beside each gathered row, in every lane of
// the group: 10 loads of the same 4 bytes a slot at F = 40).  A split row is
// finished inside the walk's launch, with the list's counters: the group that writes the last piece of a part (a counter a
// (split row, part), incremented once a piece after its carry is written
// and fenced) sums that part's pieces in order; the group that writes the
// last part of the row (a counter a split row) sums the parts in order and
// writes the row.  Nothing is added atomically but the counts; each count's
// last arriver sets it back to zero, so the next launch, and a replay of a
// captured CUDA graph, finds zeros.  Two launches that run at the same time
// must not share a set of counters: the host hands each CUDA stream, and
// each graph capture, a set of its own (ops/blocked.py::Counters).
//
// What was built and measured against it (k2_sweep.py --kernels k1; NVIDIA
// H100 80GB HBM3, 700 W, PERF.md): a unit's metadata staged in shared
// memory by cp.async, with x rows in registers or in a cp.async ring, and a
// row window held in the group's lanes (ends and scales read by
// __shfl_sync) instead of loads at each row's end, were all slower (a row's
// end and scale are L1 hits); split rows finished by two more launches
// (edge_walk's parts and a fix-up) were as fast or slower at every width.
//
// All control flow that reaches a __shfl_sync is the same over the group,
// whose lanes the mask names.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_walk.cuh"

namespace scaled_walk {

using edge_walk::Args;
using edge_walk::add_into;
using edge_walk::mul_add;
using edge_walk::scaled;
using edge_walk::set_zero;

// x rows in flight a group, the least resident blocks an SM (2 and 8 rows,
// 3 blocks, were measured slower but at F = 16: PERF.md)
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMinBlocks = 4;
// loads in flight in a part's and a row's ordered sums
constexpr int kSumLoads = 8;

// The epilogue's scales: out[r] = rs[r] * sum + w * x[r], the gathered x[c]
// scaled by cs[c]; a null rs or cs scales by one, w == 0 adds nothing.
struct Scale {
  const float* rs;
  const float* cs;
  float w;
};

// p[0] + p[stride] + ... + p[(n-1) * stride] in that order, from +0, read
// past L1 (other SMs wrote them in this launch), kSumLoads loads in flight.
template <typename T>
__device__ __forceinline__ T ordered_sum_cg(const T* __restrict__ p,
                                            long long stride, int n) {
  T acc;
  set_zero(acc);
  for (int k = 0; k < n; k += kSumLoads) {
    T v[kSumLoads];
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u)
      if (k + u < n) v[u] = __ldcg(p + (long long)(k + u) * stride);
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u)
      if (k + u < n) add_into(acc, v[u]);
  }
  return acc;
}

// rs * sum + w * self, rounded apart
template <typename T>
__device__ __forceinline__ T epilogue(float rs, T sum, float w, T self) {
  T v = scaled(rs, sum);
  if (w != 0.f) add_into(v, scaled(w, self));
  return v;
}

// The split row of piece `unit`: the s with split[3s+1] <= unit < split[3s+1]
// + split[3s+2] (the table is in unit order).
__device__ __forceinline__ int split_of(const int32_t* __restrict__ split,
                                        int n_split, long long unit) {
  int lo = 0, hi = n_split - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (split[3 * mid + 1] <= unit)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// After a piece's carry is written by every lane of the group: count it in
// its part; the last piece of the part sums the part, and the last part of
// the row sums the row and writes it.  `counters` holds n_split * parts
// part counts, then n_split row counts, all zero on entry and on exit.
template <typename T>
__device__ __forceinline__ void finish_piece(
    const int32_t* __restrict__ split, int n_split, int parts,
    long long n_units, int fv, int group, const T* __restrict__ x,
    T* __restrict__ out, T* __restrict__ carry, const float* __restrict__ rs,
    float w, int* __restrict__ counters, long long unit, int lane, int lane0,
    unsigned mask) {
  T* __restrict__ part_sum = carry + n_units * fv;
  __threadfence();
  __syncwarp(mask);
  const int s = split_of(split, n_split, unit);
  const int first = split[3 * s + 1], count = split[3 * s + 2];
  const int g = (int)(unit - first) % parts;
  const int n = (count - g + parts - 1) / parts;  // pieces of part g
  int* const part_count = counters + (long long)s * parts + g;
  int seen = 0;
  if (lane == 0) seen = atomicAdd(part_count, 1);
  seen = __shfl_sync(mask, seen, lane0);
  if (seen != n - 1) return;
  __threadfence();
  if (lane == 0) *part_count = 0;
  for (int j = lane; j < fv; j += group)
    part_sum[((long long)s * parts + g) * fv + j] = ordered_sum_cg(
        carry + (long long)(first + g) * fv + j, (long long)parts * fv, n);
  __threadfence();
  __syncwarp(mask);
  const int n_parts = min(parts, count);
  int* const row_count = counters + (long long)n_split * parts + s;
  if (lane == 0) seen = atomicAdd(row_count, 1);
  seen = __shfl_sync(mask, seen, lane0);
  if (seen != n_parts - 1) return;
  __threadfence();
  if (lane == 0) *row_count = 0;
  const int row = split[3 * s];
  const float r = rs ? rs[row] : 1.f;
  for (int j = lane; j < fv; j += group) {
    T self;
    set_zero(self);
    if (w != 0.f) self = x[(long long)row * fv + j];
    out[(long long)row * fv + j] = epilogue(
        r, ordered_sum_cg(part_sum + (long long)s * parts * fv + j, fv,
                          n_parts),
        w, self);
  }
}

// Stores list row `row`'s sum: rs[row] * sum + w * x[row].
template <typename T>
__device__ __forceinline__ void put(const Args& a, const Scale& sc, int row,
                                    int j, T acc) {
  const long long at = (long long)row * a.fv + j;
  T self;
  set_zero(self);
  if (sc.w != 0.f) self = static_cast<const T*>(a.x)[at];
  static_cast<T*>(a.out)[at] =
      epilogue(sc.rs ? sc.rs[row] : 1.f, acc, sc.w, self);
}

// Unit u holds slots unit_edge[u] .. unit_edge[u+1]; unit_row[u] is its
// first row, or ~row for a piece of a split row.  A group of a.group lanes
// a unit, 32 / group units a warp; x, out and carry hold T, a.fv of them a
// row.
template <typename T>
__device__ __forceinline__ void walk(const Args& a, const Scale& sc,
                                     int* __restrict__ counters) {
  int lane;
  const long long unit = edge_walk::group_item(a.group, a.n_units, lane);
  if (unit < 0) return;
  const int group = a.group, fv = a.fv;
  const int lane0 = (threadIdx.x & 31) - lane;
  const unsigned mask =
      group == 32 ? 0xffffffffu : ((1u << group) - 1u) << lane0;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const int32_t* __restrict__ ptr = a.ptr;
  const int32_t* __restrict__ idx = a.idx;
  const int32_t* __restrict__ eid = a.eid;
  const float* __restrict__ val = a.val;
  const float* __restrict__ cs = sc.cs;
  const int head = a.unit_row[unit];
  const bool piece = head < 0;
  int r1 = a.unit_row[unit + 1];
  r1 = r1 < 0 ? ~r1 : r1;
  const int e0 = a.unit_edge[unit], e1 = a.unit_edge[unit + 1];

  for (int j0 = 0; j0 < fv; j0 += group) {
    const int j = j0 + lane;
    const bool on = j < fv;
    T acc;
    set_zero(acc);
    int row = piece ? ~head : head;
    int row_end = piece ? INT_MAX : ptr[row + 1];
    // one batch of `group` slots, one a lane: the next batch's idx/val are
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
      // the lane's slot's cs, passed out after the gathers are issued
      const float my_c = cs && b + lane < e1 ? cs[my_src] : 1.f;
      const int pe = b + group + lane;
      if (pe < e1) {
        next_src = idx[pe];
        next_w = val[eid ? eid[pe] : pe];
      }
      for (int k = 0; k < n; k += kUnroll) {
        T g[kUnroll];
        float w[kUnroll];
        float c[kUnroll];  // cs of the gathered rows
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int from = lane0 + min(k + u, n - 1);
          w[u] = __shfl_sync(mask, my_w, from);
          set_zero(g[u]);
          const int s = __shfl_sync(mask, my_src, from);
          if (on && k + u < n) g[u] = x[(long long)s * fv + j];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          c[u] = __shfl_sync(mask, my_c, lane0 + min(k + u, n - 1));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k + u < n) {
            while (b + k + u >= row_end) {  // rows ending before the slot
              if (on) put(a, sc, row, j, acc);
              set_zero(acc);
              ++row;
              row_end = ptr[row + 1];
            }
            mul_add(acc, w[u], scaled(c[u], g[u]));
          }
        }
      }
    }
    if (piece) {
      if (on) static_cast<T*>(a.carry)[unit * fv + j] = acc;
    } else {
      // the last row, then the rows without slots after it
      for (; row < r1; ++row) {
        if (on) put(a, sc, row, j, acc);
        set_zero(acc);
      }
    }
  }
  if (piece)
    finish_piece<T>(a.split, a.n_split, a.parts, a.n_units, fv, group, x,
                    static_cast<T*>(a.out), static_cast<T*>(a.carry), sc.rs,
                    sc.w, counters, unit, lane, lane0, mask);
}

typedef void (*Walk)(Args, Scale, int*);

// The walk for a's units on `stream`.  Returns a CUDA error code (0 on
// success).
inline int launch(Walk walk_k, const Args& a, const Scale& sc, int* counters,
                  cudaStream_t stream) {
  if (a.n_split && (a.parts < 1 || !counters))
    return (int)cudaErrorInvalidValue;
  walk_k<<<edge_walk::group_blocks(a.n_units, a.group, kThreads), kThreads,
           0, stream>>>(a, sc, counters);
  return (int)cudaGetLastError();
}

}  // namespace scaled_walk
