// K1's degree walk (ell_gather.cu): over a training grid's list (ptr over
// all n rows, eid; ops/stochastic.py::TrainGrids), each row's sum of its
// edges' dropped values,
//
//     deg[r] = sum_{ptr[r] <= e < ptr[r+1]} w(eid[e]),
//
// w drop_walk.cuh's Mask: the edge's value times fp32(1 / keep) in one
// rounded product where the hash keeps it (or its id is at or past
// n_drop, unscaled), +0 where it drops it; a bfloat16 value is widened
// exactly first.  The values come in list order (val[e], the list's own
// copy of the base values, ops/ell_gather.py::list_values), so the walk
// streams eid and val side by side and gathers nothing (reading them
// through eid measured slower: PERF.md); the mask is hashed at id_base +
// eid[e].
//
// A sum of width one over a list whose largest row holds a quarter of its
// edges (the bench graph's column list: 619,773 of 2,332,478) is a
// segmented sum, so the walk takes equal shares of edges wherever the rows
// begin and end.  Block b takes edges b * kShare .. (b + 1) * kShare - 1;
// its lane t takes the kEdges consecutive edges from b * kShare + t *
// kEdges, loading their ids and values with 16-byte loads.  A hub row is
// then just so many blocks' worth of ordinary shares, and the work needs
// no host-built units, pieces or tiles: the block finds its first row with
// a search over ptr (a warp, 32 probes a round), and each lane its own
// within the block's rows.
//
// The order of the sums, which depends only on the list and kShare, never
// on timing, and which ops/ell_gather.py::ell_degree_masked_plain repeats:
//
// 1. A lane sums its run of each row in list order, from +0.
// 2. A row that spans lanes of a block is the left fold, in lane order, of
//    those lanes' sums: the lane that holds its last edge folds them from
//    shared memory after the block's barrier (a row held by one lane is
//    written by it at once).
// 3. A row that spans blocks is the left fold, in block order, of the
//    blocks' sums (each the fold of 2.).  Each block writes at most two:
//    carry_in[b], its sum of the row that comes in from block b - 1, and
//    carry_out[b], its sum of the row that goes on to block b + 1 where
//    that row starts in block b (a block inside one row writes carry_in);
//    col_in[b] names the row that comes in (-1: none).  A second kernel,
//    fold(), gives each row that crosses a block's end a warp, which
//    folds carry_out of its first block and carry_in of the others, in
//    block order, and writes the row.
//
// A sum that starts at +0 is never -0, so none of the partial sums is, and
// a fold that starts at its first partial is the fold that starts at +0.
// Every row is written once: by the lane that ends it, by a fold() warp
// (a row crossing a block's end), or, empty, as +0 by the block that owns
// its place (rows r whose end ptr[r + 1] lies in (b * kShare, (b + 1) *
// kShare], block 0 also those before its first edge, the last block those
// at the list's end).  So out needs no zero-fill, there are no atomics and
// no counters, and the scratch (carry_in, carry_out, col_in: one a block)
// is the caller's, allocated for each call, so two launches never share
// it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "drop_walk.cuh"
#include "edge_walk.cuh"

namespace degree_walk {

using drop_walk::Mask;

// lanes a block, edges a lane, and a block's share of the list (the
// host's ops/blocked.py::DEGREE_LANES, DEGREE_EDGES: the C entry checks)
constexpr int kLanes = 128;
constexpr int kEdges = 16;
constexpr int kShare = kLanes * kEdges;
// rows a lane checks for emptiness with its loads in flight at once
constexpr int kPeek = 4;
// warps a block of fold(), and the block sums a warp stages at once
constexpr int kFoldWarps = 8;
constexpr int kFoldChunk = 512;

static_assert(kEdges % 8 == 0, "a lane loads its edges 16 bytes at a time");
static_assert(kLanes % 32 == 0 && kLanes >= 64, "whole warps, two at least");

struct Args {
  const int32_t* ptr;  // (n_rows + 1,)
  const int32_t* eid;  // (n_edges,) edge ids; null: the identity
  const void* val;     // (n_edges,) V: the base values in list order
  float* out;          // (n_rows,)
  float* carry_in;     // (n_blocks,) scratch
  float* carry_out;    // (n_blocks,) scratch
  int32_t* col_in;     // (n_blocks,) scratch
  int n_rows, n_edges, n_blocks;
  bool vec;  // val and eid 16-byte aligned: a full share loads by 16 bytes
};

// The first row r in [lo, hi] with ptr[r + 1] > e, for an e whose row lies
// there (ptr is non-decreasing, so the rows before it end at or before e).
__device__ __forceinline__ int row_of(const int32_t* __restrict__ ptr, int lo,
                                      int hi, int e) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ptr + mid + 1) > e)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// row_of over all n rows by one warp, 32 probes a round; every lane
// returns it.  For e = n_edges it is n.
__device__ __forceinline__ int warp_row_of(const int32_t* __restrict__ ptr,
                                           int n, int e, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + (lane + 1) * step - 1;
    const bool ends = q < hi && __ldg(ptr + q + 1) <= e;
    const int k = __popc(__ballot_sync(0xffffffffu, ends));
    const int nlo = lo + k * step;
    hi = min(hi, nlo + step - 1);
    lo = nlo;
  }
  const bool ends = lo + lane < hi && __ldg(ptr + lo + lane + 1) <= e;
  return lo + __popc(__ballot_sync(0xffffffffu, ends));
}

// A lane's kEdges values as float (a bfloat16 widened exactly), from
// 16-byte loads where vec, else one at a time (the n that exist, zeros
// past them).
__device__ __forceinline__ void load_values(const float* __restrict__ v,
                                            long long e0, int n, bool vec,
                                            float (&x)[kEdges]) {
  if (vec) {
    const float4* p = reinterpret_cast<const float4*>(v + e0);
#pragma unroll
    for (int q = 0; q < kEdges / 4; ++q) {
      const float4 t = __ldg(p + q);
      x[4 * q] = t.x;
      x[4 * q + 1] = t.y;
      x[4 * q + 2] = t.z;
      x[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kEdges; ++i) x[i] = i < n ? __ldg(v + e0 + i) : 0.f;
  }
}

__device__ __forceinline__ void load_values(
    const __nv_bfloat16* __restrict__ v, long long e0, int n, bool vec,
    float (&x)[kEdges]) {
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(v + e0);
#pragma unroll
    for (int q = 0; q < kEdges / 8; ++q) {
      const uint4 t = __ldg(p + q);
      const uint32_t words[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // the lower address in the low half
        x[8 * q + 2 * j] = __uint_as_float(words[j] << 16);
        x[8 * q + 2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kEdges; ++i)
      x[i] = i < n ? __bfloat162float(v[e0 + i]) : 0.f;
  }
}

// A lane's kEdges edge ids (the identity where eid is null).
__device__ __forceinline__ void load_ids(const int32_t* __restrict__ eid,
                                         long long e0, int n, bool vec,
                                         uint32_t (&id)[kEdges]) {
  if (eid == nullptr) {
#pragma unroll
    for (int i = 0; i < kEdges; ++i) id[i] = (uint32_t)(e0 + i);
  } else if (vec) {
    const int4* p = reinterpret_cast<const int4*>(eid + e0);
#pragma unroll
    for (int q = 0; q < kEdges / 4; ++q) {
      const int4 t = __ldg(p + q);
      id[4 * q] = (uint32_t)t.x;
      id[4 * q + 1] = (uint32_t)t.y;
      id[4 * q + 2] = (uint32_t)t.z;
      id[4 * q + 3] = (uint32_t)t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kEdges; ++i)
      id[i] = i < n ? (uint32_t)__ldg(eid + e0 + i) : 0u;
  }
}

// The edge's dropped value: drop_walk.cuh's weight, bit for bit.
__device__ __forceinline__ float weight(uint32_t id, float v, const Mask& m,
                                        uint32_t s0, uint32_t s1) {
  const uint32_t u = id + m.id_base;
  const bool low = u < m.n_drop;
  const bool kept =
      !low ||
      (edge_walk::fmix32(edge_walk::fmix32(u ^ s0) ^ s1) >> 8) < m.thresh;
  return kept ? __fmul_rn(v, low ? m.scale : 1.f) : 0.f;
}

// The fold, in lane order, of a row's sums over lanes from..to of a block:
// from's last row's sum (or, for a row that came from the block before,
// lane 0's first row's), then each later lane's first row's.
__device__ __forceinline__ float fold_lanes(const float* first,
                                            const float* last, int from,
                                            bool came_in, int to) {
  float acc = came_in ? first[0] : last[from];
  for (int u = came_in ? 1 : from + 1; u <= to; ++u)
    acc = __fadd_rn(acc, first[u]);
  return acc;
}

template <typename V>
__device__ __forceinline__ void walk(const Args& a, const Mask& m) {
  __shared__ int bounds[2];
  __shared__ float first[kLanes], last[kLanes];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x;
  const int32_t* __restrict__ ptr = a.ptr;
  float* __restrict__ out = a.out;
  const long long e_block = (long long)b * kShare;
  const long long e_end = min((long long)a.n_edges, e_block + kShare);
  const long long e0 = e_block + (long long)t * kEdges;
  const int n = (int)max(0LL, min((long long)kEdges, e_end - e0));

  // the lane's ids and values, loaded before the searches wait on ptr
  uint32_t id[kEdges];
  float w[kEdges];
  const bool vec = a.vec && n == kEdges;
  load_ids(a.eid, e0, n, vec, id);
  load_values(static_cast<const V*>(a.val), e0, n, vec, w);

  // the block's rows: lo holds its first edge, hi is where its share ends
  if (warp < 2) {
    const int r = warp_row_of(ptr, a.n_rows, (int)(warp ? e_end : e_block),
                              lane);
    if (lane == 0) bounds[warp] = r;
  }
  const uint32_t s0 = (uint32_t)m.salt[0], s1 = (uint32_t)m.salt[1];
#pragma unroll
  for (int i = 0; i < kEdges; ++i) w[i] = weight(id[i], w[i], m, s0, s1);
  __syncthreads();
  const int lo = bounds[0], hi = bounds[1];

  // the empty rows whose place the block owns, as +0 (block 0 also those
  // before its first edge, all empty): the first kPeek rows a lane checks
  // loaded at once, which also brings the block's ptr into L1 for the
  // lanes' searches below
  if (b == 0)
    for (int r = t; r < lo; r += kLanes) out[r] = 0.f;
  {
    int at[kPeek], next[kPeek];
#pragma unroll
    for (int k = 0; k < kPeek; ++k) {
      const int r = lo + t + k * kLanes;
      at[k] = r < hi ? __ldg(ptr + r) : 0;
      next[k] = r < hi ? __ldg(ptr + r + 1) : 1;
    }
#pragma unroll
    for (int k = 0; k < kPeek; ++k)
      if (at[k] == next[k]) out[lo + t + k * kLanes] = 0.f;
  }
  for (int r = lo + t + kPeek * kLanes; r < hi; r += kLanes)
    if (__ldg(ptr + r) == __ldg(ptr + r + 1)) out[r] = 0.f;
  if (t == 0)
    a.col_in[b] = lo < a.n_rows && __ldg(ptr + lo) < e_block ? lo : -1;

  // 1. the lane's runs: a row ending inside the lane is written at once,
  // unless it came from an earlier lane
  int row = 0, row_start = 0, end = 0, head_row = 0, head_start = 0;
  float head = 0.f, acc = 0.f;
  bool ends_here = false;  // the lane's first row came in and ends here
  if (n > 0) {
    row = head_row = row_of(ptr, lo, hi, (int)e0);
    row_start = head_start = __ldg(ptr + row);
    end = __ldg(ptr + row + 1);
    const bool came = row_start < e0;
    bool first_row = true;
#pragma unroll
    for (int i = 0; i < kEdges; ++i) {
      if (i < n) {
        const int e = (int)e0 + i;
        if (e == end) {  // the row ends before edge e
          if (first_row) {
            head = acc;
            ends_here = came;
          }
          if (!(first_row && came)) out[row] = acc;
          first_row = false;
          ++row;
          if (__ldg(ptr + row + 1) <= e) row = row_of(ptr, row + 1, hi, e);
          row_start = __ldg(ptr + row);
          end = __ldg(ptr + row + 1);
          acc = 0.f;
        }
        acc = __fadd_rn(acc, w[i]);
      }
    }
    if (first_row) head = acc;
    if (end == (int)e0 + n) {  // the last row ends with the lane
      if (first_row) ends_here = came;
      if (!(first_row && came)) out[row] = acc;
    }
  }
  first[t] = head;
  last[t] = acc;
  __syncthreads();

  // 2. a row that came in and ends here: the fold of its lanes' sums
  if (ends_here) {
    const bool came_in = head_start < e_block;
    const float sum = fold_lanes(
        first, last, came_in ? 0 : (int)((head_start - e_block) / kEdges),
        came_in, t);
    if (came_in)
      a.carry_in[b] = sum;
    else
      out[head_row] = sum;
  }
  // the block's last row where it goes on to the next block
  if (n > 0 && e0 + n == e_end && end > e_end) {
    const bool came_in = row_start < e_block;
    const float sum = fold_lanes(
        first, last, came_in ? 0 : (int)((row_start - e_block) / kEdges),
        came_in, t);
    if (came_in)
      a.carry_in[b] = sum;
    else
      a.carry_out[b] = sum;
  }
}

// 3. The rows that cross a block's end: the warp of boundary b (between
// blocks b - 1 and b) takes the row that crosses it if the row starts in
// block b - 1, and folds its blocks' sums in block order.
__device__ __forceinline__ void fold(const Args& a) {
  __shared__ __align__(16) float stage[kFoldWarps][kFoldChunk];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kFoldWarps + warp + 1;
  if (b >= a.n_blocks) return;
  const int r = a.col_in[b];
  if (r < 0) return;
  // the row's bounds, the first block's sum and the first chunk of the
  // others' (loaded before the row is known to start in block b - 1)
  const long long start = __ldg(a.ptr + r);
  const int to = (__ldg(a.ptr + r + 1) - 1) / kShare;
  float acc = a.carry_out[b - 1];
  float v[kFoldChunk / 32];
#pragma unroll
  for (int j = 0; j < kFoldChunk / 32; ++j)
    v[j] = b + lane + 32 * j < a.n_blocks ? a.carry_in[b + lane + 32 * j]
                                          : 0.f;
  if (start < (long long)(b - 1) * kShare) return;  // not its first end
  float* s = stage[warp];
  for (int from = b; from <= to; from += kFoldChunk) {
    const int k = min(kFoldChunk, to - from + 1);
    if (from > b) {
#pragma unroll
      for (int j = 0; j < kFoldChunk / 32; ++j)
        v[j] = lane + 32 * j < k ? a.carry_in[from + lane + 32 * j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kFoldChunk / 32; ++j) s[lane + 32 * j] = v[j];
    __syncwarp();
    if (lane == 0) {  // four sums a load, in order
      const float4* s4 = reinterpret_cast<const float4*>(s);
      int i = 0;
#pragma unroll 4
      for (; i + 4 <= k; i += 4) {
        const float4 q = s4[i / 4];
        acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, q.x), q.y), q.z),
                        q.w);
      }
      for (; i < k; ++i) acc = __fadd_rn(acc, s[i]);
    }
    __syncwarp();
  }
  if (lane == 0) a.out[r] = acc;
}

// The walk, then fold() where `folds` (a row crosses a block's end), on
// `stream`.  Returns a CUDA error code (0 on success).
typedef void (*WalkKernel)(Args, Mask);
typedef void (*FoldKernel)(Args);

inline int launch(WalkKernel walk_k, FoldKernel fold_k, const Args& a,
                  const Mask& m, bool folds, cudaStream_t stream) {
  if (a.n_rows == 0) return (int)cudaSuccess;
  walk_k<<<a.n_blocks, kLanes, 0, stream>>>(a, m);
  if (!folds || a.n_blocks < 2) return (int)cudaGetLastError();
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = a.n_blocks - 1;
  fold_k<<<(warps + kFoldWarps - 1) / kFoldWarps, 32 * kFoldWarps, 0,
           stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace degree_walk
