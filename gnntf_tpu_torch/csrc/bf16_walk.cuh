// K2's bfloat16 mode on the H100: the staged walk (blocked_spmm.cu's
// blocked_spmm_bf16_walk, entry gnntf_blocked_spmm_bf16_staged).
//
// It computes what edge_walk.cuh's walk over loads of bfloat16 computes
// (ops/blocked.py::blocked_spmm_bf16_plain), bit for bit:
//
//     out[r] = sum_e fp32(bf16_rn(val[eid[e]] * fp32(xb[idx[e]])))
//
// over row r's edges in list order, xb being x rounded to bfloat16 (the
// host casts it first).  Units, pieces and split rows are edge_walk's: a
// group of lanes takes a unit (ops/blocked.py::work_units), a piece's sum
// goes to carry, and edge_walk's parts and fix-up (blocked_spmm_parts/_fixup
// over float4) add a split row's pieces in their order.
//
// Why a walk of its own.  x fits in the 50 MB L2 at the bench width (13.5
// MB in bfloat16 at F = 40), so the generic walk waits on the count and the
// chain of its gathers, not on bytes: with a group of F / vec lanes a unit
// (10 at F = 40 with loads of 4), a gather instruction of a warp fetches 3
// rows, kUnroll = 4 rows a group are in flight, and each element's term is
// a chain of three conversions.  Here a group of pair_lanes(F) = F / 4
// lanes takes a unit (10 at F = 40: 3 units a warp), each lane two pairs
// of elements, and:
//
// 1. Gathers apart from the sum.  The group loads a batch of `rows` edges'
//    sources and value ids (up to kEdges a lane), puts the sources in
//    shared memory, and copies their x rows as raw bytes into a ring of
//    kDepth batches in shared memory with 16-byte cp.async copies (through
//    L1: copy16), one commit group a batch.  Copy c of a batch (c = lane +
//    group * i) takes 16 bytes `c % chunks` of the row of edge `c /
//    chunks` (chunks = F / 8, a row's 16-byte pieces): every lane of the
//    group copies, over group / chunks edges an instruction.  Each edge's
//    value goes beside its row by a 4-byte copy.  The sources of the batch
//    after the next are loaded while a batch is summed, so a copy never
//    waits on its source's load past the first.
// 2. The sum, in edge order.  While the next batches' copies fly, the group
//    sums the oldest batch out of shared memory: lane l owns pairs 2l and
//    2l + 1 and, edge by edge, reads them with one 8-byte load, widens them
//    by shift (__bfloat1622float2), multiplies each element by the edge's
//    value (__fmul_rn), rounds the two products of a pair with one packed
//    conversion (__floats2bfloat162_rn: each to nearest even), widens them
//    and adds them to its float sums (__fadd_rn).  A row's sum therefore
//    has the plain version's roundings.  The row ends of the unit are
//    loaded `group` at a time, one a lane, the next window's while a
//    window is walked, and read through __shfl_sync as the sum passes rows;
//    each row is written once when its end is reached (16-byte stores),
//    rows without edges as zeros, so out is never zero-filled.
//
// Shared memory.  A group holds kDepth * rows * (2 F + 8) bytes; the host
// sizes `rows` from a budget a warp (ops/blocked.py::bf16_rows): 16 rows at
// F = 16, 20 at F = 40, so that a block of kWarps warps asks for at most
// kMaxSmem, the 48 KB a launch may take without opting in.  Rings past 48
// KB (up to 2 x 32 at F = 40) were measured no faster (PERF.md).
//
// Where it runs.  F % 8 == 0 and 16 <= F <= 40, the host giving it F = 32
// and 40 on any list, F = 24 from 150,000 edges and F = 16 from 1,000,000
// (ops/blocked.py::bf16_plan, _BF16_STAGED_EDGES).  On the RCM bench
// graph's forward list (PERF.md) it takes 0.087 ms at F = 40 against the
// generic walk's 0.106; at F = 16 and 24 on smaller lists (4 and 6 lanes a
// unit, against the generic walk's 8 and 12) it lost; at F = 64 and 128,
// where both walks wait on L2's bandwidth and this one moves each row
// through L1 and shared memory twice, it lost (4% and 20%).
//
// All control flow that reaches a __shfl_sync or a __syncwarp is the same
// over the group, whose lanes the mask names.
#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_walk.cuh"

namespace bf16_walk {

using edge_walk::Args;

// warps a block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// the widths the walk takes: F % 8 == 0 and kMinF <= F <= kMaxF
constexpr int kMinF = 16;
constexpr int kMaxF = 40;
// the most shared memory a block asks for: 48 KB, no opt-in
constexpr int kMaxSmem = 48 * 1024;
// the most edges of a batch a lane fetches: rows <= kEdges * pair_lanes(F)
constexpr int kEdges = 8;

// cp.async.ca: through L1.  The bench graph's hub is the source of 27% of
// its edges; with cp.async.cg every one of those copies went to the one L2
// slice that holds the hub's row, and the walk took 0.56 ms at F = 40
// (PERF.md); through L1 each SM fetches the row once.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc += the mode's two terms fp32(bf16_rn(w * v)), one rounded addition
// an element
__device__ __forceinline__ void add_terms(float2& acc, float w, float2 v) {
  const float2 t = __bfloat1622float2(
      __floats2bfloat162_rn(__fmul_rn(w, v.x), __fmul_rn(w, v.y)));
  acc.x = __fadd_rn(acc.x, t.x);
  acc.y = __fadd_rn(acc.y, t.y);
}

// The lanes a unit takes at F: two pairs of elements a lane.
__host__ __device__ inline int pair_lanes(int f) { return f / 4; }

// A group of pair_lanes(f) lanes takes unit `(blockIdx.x * kWarps + warp) *
// (32 / group) + group index` of the list, F = f, `rows` edges a batch,
// kDepth batches in its ring.
template <int kDepth>
__device__ __forceinline__ void walk(const Args& a, int f, int rows) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int group = pair_lanes(f), per_warp = 32 / group;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int sub = wl / group, lane = wl - sub * group, lane0 = sub * group;
  const long long unit =
      ((long long)blockIdx.x * kWarps + warp) * per_warp + sub;
  if (sub >= per_warp || unit >= a.n_units) return;
  const unsigned mask = ((1u << group) - 1u) << lane0;
  const int row_bytes = f * (int)sizeof(__nv_bfloat16);
  const int chunks = row_bytes / 16;
  // the group's ring: kDepth slots of `rows` x rows, then each slot's
  // values and sources
  unsigned char* const base =
      ring + (size_t)(warp * per_warp + sub) * kDepth * rows *
                 (row_bytes + 8);
  float* const w_ring =
      reinterpret_cast<float*>(base + (size_t)kDepth * rows * row_bytes);
  int* const s_ring = reinterpret_cast<int*>(w_ring + kDepth * rows);
  const unsigned char* __restrict__ x =
      static_cast<const unsigned char*>(a.x);
  float* __restrict__ out = static_cast<float*>(a.out);
  const int32_t* __restrict__ idx = a.idx;
  const int32_t* __restrict__ eid = a.eid;
  const float* __restrict__ val = a.val;

  const int head = a.unit_row[unit];
  const bool piece = head < 0;
  int r1 = a.unit_row[unit + 1];
  r1 = r1 < 0 ? ~r1 : r1;
  const int e0 = a.unit_edge[unit], e1 = a.unit_edge[unit + 1];
  const int n_batches = (e1 - e0 + rows - 1) / rows;
  int row = piece ? ~head : head;
  // lane l holds the end of row first + l, `group` rows a window, and the
  // next window's in `ahead`, loaded as the window is entered
  int first = row;
  auto end_of = [&](int r) {
    return !piece && r + lane < r1 ? a.ptr[r + lane + 1] : INT_MAX;
  };
  int ends = end_of(row), ahead = end_of(row + group);

  // the sources and value ids of edges e0 + b * rows + lane + group * t
  int src[kEdges], vid[kEdges];
  auto fetch = [&](int b) {
#pragma unroll
    for (int t = 0; t < kEdges; ++t) {
      const int j = lane + group * t, e = e0 + b * rows + j;
      if (j < rows && e < e1) {
        src[t] = idx[e];
        vid[t] = eid ? eid[e] : e;
      }
    }
  };
  // batch b's copies into slot b % kDepth: its sources to the slot (read
  // back after a __syncwarp), then copy c = lane + group * i takes 16
  // bytes `c % chunks` of the row of edge `c / chunks`; each value by a
  // 4-byte copy.  One commit group a call, empty past the last batch.
  const int rounds = (rows * chunks + group - 1) / group;
  const int dk = group / chunks, dp = group - dk * chunks;
  auto stage = [&](int b) {
    if (b < n_batches) {
      const int slot = b % kDepth;
      const int n = min(rows, e1 - e0 - b * rows);
      int* srcs = s_ring + slot * rows;
#pragma unroll
      for (int t = 0; t < kEdges; ++t) {
        const int j = lane + group * t;
        if (j < n) {
          srcs[j] = src[t];
          copy4(w_ring + slot * rows + j, val + vid[t]);
        }
      }
      __syncwarp(mask);
      unsigned char* dst = base + (size_t)slot * rows * row_bytes;
      int k = lane / chunks, part = lane - k * chunks;
      for (int i = 0; i < rounds; ++i) {
        if (k < n)
          copy16(dst + k * row_bytes + part * 16,
                 x + (long long)srcs[k] * row_bytes + part * 16);
        k += dk;
        part += dp;
        if (part >= chunks) {
          part -= chunks;
          ++k;
        }
      }
    }
    commit();
  };

  fetch(0);
  stage(0);
#pragma unroll
  for (int b = 1; b < kDepth; ++b) {
    fetch(b);
    stage(b);
  }
  fetch(kDepth);

  // lane l's sums: pairs 2l and 2l + 1
  float2 acc[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
  auto put = [&](float* to) {  // the sums (a 16-byte store), then zeros
    reinterpret_cast<float4*>(to)[lane] =
        make_float4(acc[0].x, acc[0].y, acc[1].x, acc[1].y);
    acc[0] = acc[1] = make_float2(0.f, 0.f);
  };
  int row_end = piece ? INT_MAX : __shfl_sync(mask, ends, lane0);

  for (int i = 0; i < n_batches; ++i) {
    wait_groups<kDepth - 1>();
    __syncwarp(mask);
    const int slot = i % kDepth;
    const int b0 = e0 + i * rows;
    const int n = min(rows, e1 - b0);
    const __nv_bfloat16* rb =
        reinterpret_cast<const __nv_bfloat16*>(base + (size_t)slot * rows *
                                               row_bytes) +
        lane * 4;
    const float* ws = w_ring + slot * rows;
    for (int k = 0; k < n;) {
      while (b0 + k >= row_end) {  // rows ending before edge b0 + k
        put(out + (long long)row * f);
        ++row;
        if (row - first == group) {
          first = row;
          ends = ahead;
          ahead = end_of(row + group);
        }
        row_end = __shfl_sync(mask, ends, lane0 + row - first);
      }
      // the run of this row's edges in the batch: no store, no shuffle
      const int stop = min(n, row_end - b0);
#pragma unroll 4
      for (; k < stop; ++k) {
        const float w = ws[k];
        __nv_bfloat162 v[2];
        *reinterpret_cast<uint2*>(v) =
            *reinterpret_cast<const uint2*>(rb + k * f);
        add_terms(acc[0], w, __bfloat1622float2(v[0]));
        add_terms(acc[1], w, __bfloat1622float2(v[1]));
      }
    }
    __syncwarp(mask);  // every lane has read the slot before it is refilled
    stage(i + kDepth);
    fetch(i + kDepth + 1);
  }
  wait_groups<0>();

  if (piece) {
    put(static_cast<float*>(a.carry) + unit * f);
    return;
  }
  // the last row, then the rows without edges after it
  for (; row < r1; ++row) put(out + (long long)row * f);
}

// The shared memory a block of the walk asks for: each group's ring.
inline long long smem_bytes(int f, int depth, int rows) {
  return (long long)kWarps * (32 / pair_lanes(f)) * depth * rows *
         (f * (int)sizeof(__nv_bfloat16) + 8);
}

// Launches kernel K (blocked_spmm.cu's thin wrapper over walk()) for a's
// units on `stream`, with its ring's shared memory.
template <typename K>
int launch_walk(K kernel, const Args& a, int f, int rows, long long smem,
                cudaStream_t stream) {
  const long long per_block = (long long)kWarps * (32 / pair_lanes(f));
  const unsigned blocks = (unsigned)((a.n_units + per_block - 1) / per_block);
  kernel<<<blocks, kThreads, (size_t)smem, stream>>>(a, f, rows);
  return (int)cudaGetLastError();
}

}  // namespace bf16_walk
