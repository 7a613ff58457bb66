// The edge-balanced walk over a CSR list, shared by K1 (ell_gather.cu) and
// K2 (blocked_spmm.cu).  Over a list (ptr, idx, eid, rows) of n rows:
//
//     out[rows[r]] (+)= sum_{ptr[r] <= e < ptr[r+1]} val[eid[e]] * x[idx[e]]
//
// with eid[e] = e where eid is null.  In store mode (K2) each row's sum is
// stored at its own row r (rows is not read); in accumulate mode (K1) it is
// added to what out row rows[r] holds, one rounded addition an element, and
// rows the list does not hold are left untouched.
//
// Work is balanced by edges, not by rows.  The host cuts the list into units
// of about `items` items (an edge or a row end): a run of whole rows, or a
// piece of at most `items` edges of a longer row
// (gnntf_tpu_torch/ops/blocked.py::work_units).  A group of `group` lanes
// (F / 4 lanes with float4 loads, so 3 groups a warp at F = 40; 32 lanes at
// F >= 128) takes one unit.  It loads a batch of idx/val with one coalesced
// load, one edge a lane, passes the entries out with __shfl_sync, and keeps
// kUnroll gathers of x rows in flight; the lanes span the features with
// 16-byte loads.  Row sums stay in fp32 registers and each row of a run is
// written once, with a plain store, when its end is reached; in store mode
// rows without edges are written as zeros, so out is never zero-filled.  In
// accumulate mode a row's value in out (and its row id) is loaded when the
// walk enters the row, so the load is in flight while the row's gathers are
// and the row's end does not wait for it.
// There are no atomics, no shared memory and no block syncs in the edge
// loop.  A piece writes its sum to `carry`.  A split row's pieces are then
// summed in `parts` parts: a second kernel gives each (split row, part) that
// holds a piece (part_item, ops/blocked.py::part_items) a group of lanes,
// which sums pieces g, g + parts, ... in turn, so the hub row's pieces
// spread over the card; a third adds each row's parts in order and writes
// the row.  A part without a piece would add +0 to a sum that starts at +0
// and so never is -0: leaving it out changes no bit.  The caller fixes `parts` (ops/blocked.py::
// _FIXUP_PARTS) and the plain version repeats that order; the launch
// geometry does not change it, so the result is the same from launch to
// launch and on the CPU.
//
// K1's scaled walk (the prepared operator's whole product) has a design of
// its own, scaled_walk.cuh, which takes this header's parts.
//
// In K2's bfloat16 mode (blocked_spmm.cu, gnntf_blocked_spmm_bf16) x holds
// bfloat16 (X: 2, 4 or 8 of them a lane's load, or one) while the sums,
// out and carry stay float (T: float, float2, float4 or float8); each term
// is then rounded to bfloat16 before it is added (mul_add over an X), the
// JAX package's order.  Elsewhere X is T and nothing of it is compiled.
//
// K1's masked walk has a design of its own, drop_walk.cuh, which takes this
// header's parts and fix-up; its degree walk another, degree_walk.cuh.
//
// Each source that includes this header defines its own __global__ kernels,
// thin wrappers named after it and its mode (so a profile tells them
// apart), over walk(), parts() and fixup() below, and launches them with
// launch().
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace edge_walk {

constexpr int kThreads = 256;
// gathers of x rows a group keeps in flight (k2_sweep.py builds others)
#ifndef WALK_UNROLL
#define WALK_UNROLL 4
#endif
constexpr int kUnroll = WALK_UNROLL;
// least resident blocks of the walk an SM, as __launch_bounds__ asks the
// compiler for (k2_sweep.py builds others)
#ifndef WALK_MIN_BLOCKS
#define WALK_MIN_BLOCKS 4
#endif
constexpr int kMinBlocks = WALK_MIN_BLOCKS;
// loads in flight in the fix-up's sums
constexpr int kSumLoads = 16;

// One launch's arguments, as the C entry points take them.  x, out and
// carry hold T (float or float4; the bfloat16 mode's x holds X); fv = F /
// (floats in T).
struct Args {
  const int32_t* ptr;
  const int32_t* idx;
  const int32_t* eid;   // null: the identity
  const int32_t* rows;  // read in accumulate mode only
  const float* val;
  const int32_t* unit_row;
  const int32_t* unit_edge;
  const int32_t* split;
  const int32_t* part_item;
  const void* x;
  void* out;
  void* carry;
  int n_units, n_split, n_part_items, fv, group, parts;
};

// murmur3's 32-bit finalizer
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Eight floats, a lane's sums at the bfloat16 mode's 16-byte loads; four
// and eight bfloat16, its 8- and 16-byte loads.
struct __align__(16) float8 {
  float4 lo, hi;
};
struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};
struct __align__(16) bf16x8 {
  __nv_bfloat162 a, b, c, d;
};

__device__ __forceinline__ void set_zero(float& a) { a = 0.f; }
__device__ __forceinline__ void set_zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
// float2, float8 and the bfloat16 loads: all bits zero
template <typename V>
__device__ __forceinline__ void set_zero(V& a) {
  a = V{};
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

// The bfloat16 mode's term, fp32(bf16_rn(w * fp32(v))): the JAX package's
// G * vals in float32, then G.astype(bfloat16), each rounded apart.
__device__ __forceinline__ float term(float w, __nv_bfloat16 v) {
  return __bfloat162float(
      __float2bfloat16_rn(__fmul_rn(w, __bfloat162float(v))));
}
__device__ __forceinline__ float2 term(float w, __nv_bfloat162 v) {
  return make_float2(term(w, v.x), term(w, v.y));
}
__device__ __forceinline__ float4 term(float w, bf16x4 v) {
  const float2 lo = term(w, v.lo), hi = term(w, v.hi);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float8 term(float w, bf16x8 v) {
  const float2 a = term(w, v.a), b = term(w, v.b), c = term(w, v.c),
               d = term(w, v.d);
  return float8{make_float4(a.x, a.y, b.x, b.y),
                make_float4(c.x, c.y, d.x, d.y)};
}

__device__ __forceinline__ float scaled(float s, float v) {
  return __fmul_rn(s, v);
}
__device__ __forceinline__ float4 scaled(float s, float4 v) {
  return make_float4(__fmul_rn(s, v.x), __fmul_rn(s, v.y), __fmul_rn(s, v.z),
                     __fmul_rn(s, v.w));
}

__device__ __forceinline__ void add_into(float& acc, float v) {
  acc = __fadd_rn(acc, v);
}
__device__ __forceinline__ void add_into(float4& acc, float4 v) {
  add_into(acc.x, v.x);
  add_into(acc.y, v.y);
  add_into(acc.z, v.z);
  add_into(acc.w, v.w);
}
__device__ __forceinline__ void add_into(float2& acc, float2 v) {
  add_into(acc.x, v.x);
  add_into(acc.y, v.y);
}
__device__ __forceinline__ void add_into(float8& acc, const float8& v) {
  add_into(acc.lo, v.lo);
  add_into(acc.hi, v.hi);
}

// acc += the bfloat16 mode's term of each element of v, one rounded
// addition an element.
template <typename T, typename X>
__device__ __forceinline__ void mul_add(T& acc, float w, const X& v) {
  add_into(acc, term(w, v));
}

// The element of out that list row `row` writes: out row rows[row] in
// accumulate mode, else out row `row`.
template <bool kAdd, typename T>
__device__ __forceinline__ T* row_at(T* __restrict__ out,
                                     const int32_t* __restrict__ rows,
                                     int row, int fv, int j) {
  return out + (long long)(kAdd ? rows[row] : row) * fv + j;
}

// Writes list row `row`'s sum: stores it, or, with kAdd, adds it to `base`,
// the row's value in out, as the plain version's index_add_ into its base
// does.
template <bool kAdd, typename T>
__device__ __forceinline__ void put_row(T* __restrict__ out,
                                        const int32_t* __restrict__ rows,
                                        int row, int fv, int j, T acc,
                                        T base) {
  if (kAdd) add_into(acc, base);
  *row_at<kAdd>(out, rows, row, fv, j) = acc;
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

// The group of lanes of this thread and its item (unit, part or split row):
// `group` lanes an item, 32 / group items a warp.  Returns -1 for idle lanes
// and lanes past the last item.
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

// Unit u holds edges unit_edge[u] .. unit_edge[u+1]; unit_row[u] is its
// first row, or ~row for a piece of a split row.  x holds X (T, or the
// bfloat16 mode's loads).
template <typename T, bool kAdd, typename X = T>
__device__ __forceinline__ void walk_units(
    const int32_t* __restrict__ ptr, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ eid, const int32_t* __restrict__ rows,
    const float* __restrict__ val, const int32_t* __restrict__ unit_row,
    const int32_t* __restrict__ unit_edge, const X* __restrict__ x,
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
    T acc, base;
    set_zero(acc);
    set_zero(base);
    int row = piece ? ~head : head;
    int row_end = piece ? INT_MAX : ptr[row + 1];
    if (kAdd && on && !piece) base = *row_at<kAdd>(out, rows, row, fv, j);
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
        X a[kUnroll];
        float w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int from = lane0 + min(k + u, n - 1);
          w[u] = __shfl_sync(mask, my_w, from);
          set_zero(a[u]);
          const int s = __shfl_sync(mask, my_src, from);
          if (on && k + u < n) a[u] = x[(long long)s * fv + j];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (k + u < n) {
            const int e = b + k + u;
            while (e >= row_end) {  // rows ending before edge e
              if (on) put_row<kAdd>(out, rows, row, fv, j, acc, base);
              set_zero(acc);
              ++row;
              row_end = ptr[row + 1];
              if (kAdd && on) base = *row_at<kAdd>(out, rows, row, fv, j);
            }
            mul_add(acc, w[u], a[u]);
          }
        }
      }
    }
    if (piece) {
      if (on) carry[unit * fv + j] = acc;
    } else {
      // the last row, then rows without edges
      for (; row < r1; ++row) {
        if (on) put_row<kAdd>(out, rows, row, fv, j, acc, base);
        set_zero(acc);
        if (kAdd && on && row + 1 < r1)
          base = *row_at<kAdd>(out, rows, row + 1, fv, j);
      }
    }
  }
}

template <typename T, bool kAdd, typename X = T>
__device__ __forceinline__ void walk(const Args& a) {
  walk_units<T, kAdd, X>(
      a.ptr, a.idx, a.eid, a.rows, a.val, a.unit_row, a.unit_edge,
      static_cast<const X*>(a.x), static_cast<T*>(a.out),
      static_cast<T*>(a.carry), a.n_units, a.fv, a.group);
}

// Item i, part_item[i] = s * parts + g: part g of split row s, the sum of
// its pieces g, g + parts, ... in turn (the pieces are the units
// split[3s+1] .. split[3s+1] + split[3s+2] - 1), into part_sum[s * parts +
// g].  Items are part-major, so the parts of the hub row fall in blocks far
// apart, on many SMs.
template <typename T>
__device__ __forceinline__ void sum_parts(
    const int32_t* __restrict__ split, const int32_t* __restrict__ part_item,
    const T* __restrict__ carry, T* __restrict__ part_sum, int n_part_items,
    int fv, int group, int parts) {
  int lane;
  const long long item = group_item(group, n_part_items, lane);
  if (item < 0) return;
  const int v = part_item[item];
  const long long s = v / parts;
  const int g = v - (int)s * parts;
  const long long first = split[3 * s + 1];
  const int count = split[3 * s + 2];
  const int n = (count - g + parts - 1) / parts;
  for (int j = lane; j < fv; j += group)
    part_sum[(s * parts + g) * fv + j] = ordered_sum(
        carry + (first + g) * fv + j, (long long)parts * fv, n);
}

template <typename T>
__device__ __forceinline__ void parts(const Args& a) {
  const T* carry = static_cast<const T*>(a.carry);
  sum_parts<T>(a.split, a.part_item, carry,
               static_cast<T*>(a.carry) + (long long)a.n_units * a.fv,
               a.n_part_items, a.fv, a.group, a.parts);
}

// Item s: split row split[3s], its parts that hold a piece added in order
// and written.
template <typename T, bool kAdd>
__device__ __forceinline__ void fix_rows(const int32_t* __restrict__ split,
                                         const int32_t* __restrict__ rows,
                                         const T* __restrict__ part_sum,
                                         T* __restrict__ out, int n_split,
                                         int fv, int group, int parts) {
  int lane;
  const long long s = group_item(group, n_split, lane);
  if (s < 0) return;
  const int row = split[3 * s];
  const int n = min(parts, split[3 * s + 2]);
  for (int j = lane; j < fv; j += group) {
    T base;
    set_zero(base);
    if (kAdd) base = *row_at<kAdd>(out, rows, row, fv, j);
    put_row<kAdd>(out, rows, row, fv, j,
                  ordered_sum(part_sum + s * parts * fv + j, fv, n), base);
  }
}

template <typename T, bool kAdd>
__device__ __forceinline__ void fixup(const Args& a) {
  fix_rows<T, kAdd>(
      a.split, a.rows,
      static_cast<const T*>(a.carry) + (long long)a.n_units * a.fv,
      static_cast<T*>(a.out), a.n_split, a.fv, a.group, a.parts);
}

// blocks of `threads` for n_items items of `group` lanes
inline unsigned group_blocks(long long n_items, int group, int threads) {
  const int per_warp = 32 / group;
  const long long warps = (n_items + per_warp - 1) / per_warp;
  return (unsigned)((warps * 32 + threads - 1) / threads);
}

typedef void (*Kernel)(Args);

// After the walk's launch: (only where a row is split) the parts and the
// fix-up, on `stream`; both run in blocks of one warp, so their items spread
// over the SMs.  Returns a CUDA error code (0 on success).
inline int finish(Kernel parts_k, Kernel fixup_k, const Args& a,
                  cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 0) return (int)err;
  if (a.parts < 1) return (int)cudaErrorInvalidValue;
  parts_k<<<group_blocks(a.n_part_items, a.group, 32), 32, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fixup_k<<<group_blocks(a.n_split, a.group, 32), 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The walk, then finish(), on `stream`.
inline int launch(Kernel walk_k, Kernel parts_k, Kernel fixup_k,
                  const Args& a, cudaStream_t stream) {
  walk_k<<<group_blocks(a.n_units, a.group, kThreads), kThreads, 0,
           stream>>>(a);
  return finish(parts_k, fixup_k, a, stream);
}

// The Args of an entry point's C arguments; vec is the floats in T (4:
// float4, or 1; the bfloat16 mode's 1, 2, 4 or 8).
inline Args make_args(const void* ptr, const void* idx, const void* eid,
                      const void* rows, const void* unit_row,
                      const void* unit_edge, const void* split,
                      const void* part_item, const void* val, const void* x,
                      void* out, void* carry, int n_units, int n_split,
                      int n_part_items, int f, int vec, int group,
                      int parts) {
  Args a;
  a.ptr = static_cast<const int32_t*>(ptr);
  a.idx = static_cast<const int32_t*>(idx);
  a.eid = static_cast<const int32_t*>(eid);
  a.rows = static_cast<const int32_t*>(rows);
  a.val = static_cast<const float*>(val);
  a.unit_row = static_cast<const int32_t*>(unit_row);
  a.unit_edge = static_cast<const int32_t*>(unit_edge);
  a.split = static_cast<const int32_t*>(split);
  a.part_item = static_cast<const int32_t*>(part_item);
  a.x = x;
  a.out = out;
  a.carry = carry;
  a.n_units = n_units;
  a.n_split = n_split;
  a.n_part_items = n_part_items;
  a.fv = f / vec;
  a.group = group;
  a.parts = parts;
  return a;
}

}  // namespace edge_walk
