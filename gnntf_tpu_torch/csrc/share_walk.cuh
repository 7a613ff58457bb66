// K2's bfloat16 mode at F = 64-256 (blocked_spmm.cu,
// gnntf_blocked_spmm_bf16_share): over one CSR list (ptr, idx, eid) of n
// rows, with x (n_in, F) bfloat16 and out (n, F) float32,
//
//     out[r] = sum_{ptr[r] <= e < ptr[r+1]} fp32(bf16_rn(val[eid[e]] * fp32(x[idx[e]])))
//
// (eid[e] = e where eid is null), each term rounded to bfloat16 as the JAX
// package's G * vals is, the sums in float32.
//
// The walk takes equal shares of the list's edges wherever rows begin and
// end, as the degree walk (degree_walk.cuh) does for sums of width one.
// Block b (kThreads threads) takes edges b * kShare .. (b + 1) * kShare -
// 1.  A group of L lanes (L = 8 at F = 64, 16 up to F = 128, 32 up to 256:
// F / 8 of them hold 8 elements of a row each, one 16-byte load of 8
// bfloat16 and 8 float sums) takes a run of kShare * L / kThreads
// consecutive edges (32, 64 or 128).  It loads the run's idx and values
// (through eid) a batch of L edges at a time, one a lane, the next batch's
// while the current one's x rows are gathered, passes each edge's source
// and value out with __shfl_sync, and keeps kInFlight gathers of x in
// flight.  The x rows are read with __ldg, which L1 may keep: the bench
// graph's hub is a source of a quarter of the edges.  A hub row is just
// so many blocks' worth of ordinary shares, and the walk reads none of the
// list's units, pieces or parts.  The block finds its rows with a search
// over ptr (a warp, 32 probes a round), and each group its first row
// within the block's (L probes a round); a group keeps the ends of L rows
// in its lanes, one a lane.  Registers are held to 64 a thread, so that an
// SM holds 2,048 threads, as the generic walk's (edge_walk.cuh) do.
//
// The order of the sums depends only on the list, the run, kShare and
// kFoldRange, never on timing; ops/blocked.py::share_row_sums repeats it:
//
// 1. A group sums its run of each row in edge order, from +0.
// 2. A row that spans runs of a block is the left fold, in run order, of
//    those runs' sums: the group that holds its last edge folds them from
//    shared memory after the block's barrier (a row held by one run is
//    written by its group at once).
// 3. A row that spans blocks is the fold of its blocks' sums (each the
//    fold of 2.), in block order, by ranges: the sums of kFoldRange
//    consecutive blocks are each left-folded, then those range sums are
//    left-folded in order.  Each block writes at most two partials:
//    carry_in[b], its sum of the row that comes in from block b - 1, and
//    carry_out[b], its sum of the row that starts in it and goes on (a
//    block inside one row writes carry_in); col_in[b] names the row that
//    comes in (-1: none).  A second kernel, fold(), gives each row that
//    crosses a block's end a warp, and a row of more than one range (a
//    hub) its warp's whole block, whose warps sum its ranges.  The ranges
//    follow from the row's number of partials alone, so the launch
//    geometry does not change the result.
//
// A sum that starts at +0 is never -0, so no partial sum is, and a fold
// that starts at its first partial is the fold that starts at +0.  Every
// row is written once: by the group that ends it, by fold() (a row that
// crosses a block's end), or, empty, as +0 by block r / ceil(n / n_blocks)
// (the rows are dealt to the blocks in equal chunks, so a list whose rows
// past its last edge are empty spreads them over the card).  So out needs
// no zero-fill, there are no atomics and no counters, and the scratch
// (carry_in, carry_out: F floats a block; col_in: one a block) is the
// caller's, allocated for each call, so that two launches never share it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace share_walk {

// threads a block; edges a block's share (the host's ops/blocked.py::
// BF16_SHARE: the C entry checks); gathers of x a lane keeps in flight,
// and the least resident blocks an SM that __launch_bounds__ asks for
// (PERF.md §6 records the other builds measured)
constexpr int kThreads = 256;
constexpr int kShare = 1024;
constexpr int kInFlight = 4;
constexpr int kMinBlocks = 4;
// the widths the walk takes (F % 8 == 0)
constexpr int kMinF = 64;
constexpr int kMaxF = 256;
// the shared memory of a block's runs' partials: kThreads / L runs of F
// floats, kThreads * F / L <= 8 * kThreads floats at every width
constexpr int kPartials = 8 * kThreads;
// block sums a range of fold() (ops/blocked.py::BF16_FOLD_RANGE), and its
// warps
constexpr int kFoldRange = 32;
constexpr int kFoldWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kShare % kThreads == 0, "whole runs at every group size");

// lanes a group at F: 8, 16 or 32, the least power of two >= F / 8
inline int group_lanes(int f) { return f <= 64 ? 8 : f <= 128 ? 16 : 32; }

struct Args {
  const int32_t* ptr;  // (n_rows + 1,)
  const int32_t* idx;  // (n_edges,)
  const int32_t* eid;  // (n_edges,) edge ids; null: the identity
  const float* val;    // the values, by edge id
  const uint4* x;      // (n_in, F / 8): 8 bfloat16 each
  float* out;          // (n_rows, F)
  float* carry_in;     // (n_blocks, F) scratch
  float* carry_out;    // (n_blocks, F) scratch
  int32_t* col_in;     // (n_blocks,) scratch
  int n_rows, n_edges, n_blocks, f;
};

// The first row r in [lo, hi] with ptr[r + 1] > e, for an e whose row lies
// there, by `width` lanes of `mask` (lane: this one's place among them),
// `width` probes a round; every lane returns it.  For e = n_edges it is hi.
__device__ __forceinline__ int row_of(const int32_t* __restrict__ ptr, int lo,
                                      int hi, int e, int lane, int width,
                                      unsigned mask) {
  while (hi - lo > width) {
    const int step = (hi - lo + width - 1) / width;
    const int q = lo + (lane + 1) * step - 1;
    const bool ends = q < hi && __ldg(ptr + q + 1) <= e;
    const int k = __popc(__ballot_sync(mask, ends) & mask);
    const int nlo = lo + k * step;
    hi = min(hi, nlo + step - 1);
    lo = nlo;
  }
  const bool ends = lo + lane < hi && __ldg(ptr + lo + lane + 1) <= e;
  return lo + __popc(__ballot_sync(mask, ends) & mask);
}

// acc += the 8 terms fp32(bf16_rn(w * fp32(v))), one rounded addition an
// element; the lower address sits in a word's low half.
__device__ __forceinline__ void add_terms(float (&acc)[8], float w, uint4 v) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = __uint_as_float(words[j] << 16);
    const float hi = __uint_as_float(words[j] & 0xffff0000u);
    const __nv_bfloat162 t =
        __floats2bfloat162_rn(__fmul_rn(w, lo), __fmul_rn(w, hi));
    const uint32_t bits = *reinterpret_cast<const uint32_t*>(&t);
    acc[2 * j] = __fadd_rn(acc[2 * j], __uint_as_float(bits << 16));
    acc[2 * j + 1] =
        __fadd_rn(acc[2 * j + 1], __uint_as_float(bits & 0xffff0000u));
  }
}

__device__ __forceinline__ void put8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void get8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void add8(float (&acc)[8], const float* p) {
  float v[8];
  get8(p, v);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], v[j]);
}

// The fold, in run order, of a row's sums over runs from..to of a block
// (a lane's 8 elements at `at`): from's last row's sum (or, for a row that
// came from the block before, run 0's first row's), then each later run's
// first row's.
__device__ __forceinline__ void fold_runs(const float* first,
                                          const float* last, int f, int at,
                                          int from, bool came_in, int to,
                                          float (&acc)[8]) {
  get8((came_in ? first : last + from * f) + at, acc);
  for (int u = came_in ? 1 : from + 1; u <= to; ++u)
    add8(acc, first + u * f + at);
}

// The empty rows of block blockIdx.x's chunk of the rows (ceil(n / n_blocks)
// of them), as +0: kThreads rows at a time, listed in shared memory in row
// order by the warps' ballots, then written by the block's threads,
// consecutive threads on consecutive float4s.
__device__ __forceinline__ void zero_empty_rows(const Args& a, int t) {
  __shared__ int empty[kThreads];
  __shared__ int counts[kThreads / 32];
  const int f4 = a.f / 4, warp = t >> 5, wl = t & 31;
  const int chunk = (a.n_rows + a.n_blocks - 1) / a.n_blocks;
  const int start = blockIdx.x * chunk;
  const int end = min(a.n_rows, start + chunk);
  float4* __restrict__ out = reinterpret_cast<float4*>(a.out);
  for (int base = start; base < end; base += kThreads) {
    const int r = base + t;
    const bool is_empty =
        r < end && __ldg(a.ptr + r) == __ldg(a.ptr + r + 1);
    const unsigned votes = __ballot_sync(kFull, is_empty);
    if (wl == 0) counts[warp] = __popc(votes);
    __syncthreads();
    int at = 0, m = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      at += w < warp ? counts[w] : 0;
      m += counts[w];
    }
    if (is_empty) empty[at + __popc(votes & ((1u << wl) - 1u))] = r;
    __syncthreads();
    for (int i = t; i < m * f4; i += kThreads)
      out[(long long)empty[i / f4] * f4 + i % f4] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();  // the list is written again
  }
}

// The walk at groups of L lanes.
template <int L>
__device__ __forceinline__ void walk(const Args& a) {
  constexpr int kRun = kShare * L / kThreads;  // edges a run
  __shared__ __align__(16) float first[kPartials];  // a run's first row
  __shared__ __align__(16) float last[kPartials];   // a run's last row
  __shared__ int bounds[2];
  const int f = a.f, fv = f / 8;
  const int t = threadIdx.x, b = blockIdx.x;
  const int g = t / L, lane = t % L, lane0 = (t & 31) - lane;
  const unsigned mask = L == 32 ? kFull : ((1u << L) - 1u) << lane0;
  const bool on = lane < fv;  // the lane holds 8 elements of a row
  const int at = lane * 8;
  const int32_t* __restrict__ ptr = a.ptr;
  const int32_t* __restrict__ idx = a.idx;
  const int32_t* __restrict__ eid = a.eid;
  const float* __restrict__ val = a.val;
  const uint4* __restrict__ x = a.x;
  float* __restrict__ out = a.out;
  const int e_block = b * kShare;
  const int e_end = min(a.n_edges, e_block + kShare);
  const int r0 = e_block + g * kRun;
  const int n = max(0, min(kRun, e_end - r0));

  // the run's first batch: lane l holds edge r0 + l
  int next_src = 0;
  float next_w = 0.f;
  if (lane < n) {
    next_src = __ldg(idx + r0 + lane);
    next_w = __ldg(val + (eid ? __ldg(eid + r0 + lane) : r0 + lane));
  }

  // the block's rows: lo holds its first edge, hi is where its share ends
  const int warp = t >> 5;
  if (warp < 2) {
    const int r = row_of(ptr, 0, a.n_rows, warp ? e_end : e_block, t & 31,
                         32, kFull);
    if ((t & 31) == 0) bounds[warp] = r;
  }
  zero_empty_rows(a, t);
  __syncthreads();
  const int lo = bounds[0], hi = bounds[1];
  if (t == 0)
    a.col_in[b] = lo < a.n_rows && __ldg(ptr + lo) < e_block ? lo : -1;

  // 1. the group's run: a row ending inside it is written at once, unless
  // it came from an earlier run
  int row = 0, head_row = 0, head_start = 0, row_end = 0;
  bool first_row = true, ends_here = false;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  if (n > 0) {
    row = head_row = row_of(ptr, lo, hi, r0, lane, L, mask);
    // lane l holds the end of row window + l
    int window = row;
    int ends = row + 1 + lane <= a.n_rows ? __ldg(ptr + row + 1 + lane)
                                          : INT_MAX;
    head_start = __ldg(ptr + row);
    const bool came = head_start < r0;
    row_end = __shfl_sync(mask, ends, lane0);
    for (int base = 0; base < n; base += L) {
      const int m = min(L, n - base);
      const int my_src = next_src;
      const float my_w = next_w;
      const int pe = base + L + lane;
      if (pe < n) {
        next_src = __ldg(idx + r0 + pe);
        next_w = __ldg(val + (eid ? __ldg(eid + r0 + pe) : r0 + pe));
      }
      for (int k = 0; k < m; k += kInFlight) {
        uint4 v[kInFlight];
        float w[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int from = lane0 + min(k + u, m - 1);
          w[u] = __shfl_sync(mask, my_w, from);
          const int s = __shfl_sync(mask, my_src, from);
          v[u] = on && k + u < m ? __ldg(x + (long long)s * fv + lane)
                                 : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (k + u < m) {
            const int e = r0 + base + k + u;
            if (e >= row_end) {  // the row ends before edge e
              if (first_row) {
                if (on) put8(first + g * f + at, acc);
                ends_here = came;
              }
              if (on && !(first_row && came))
                put8(out + (long long)row * f + at, acc);
              first_row = false;
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[j] = 0.f;
              do {  // the next row with an edge: e's
                ++row;
                if (row - window == L) {
                  window = row;
                  ends = row + 1 + lane <= a.n_rows
                             ? __ldg(ptr + row + 1 + lane)
                             : INT_MAX;
                }
                row_end = __shfl_sync(mask, ends, lane0 + row - window);
              } while (row_end <= e);
            }
            if (on) add_terms(acc, w[u], v[u]);
          }
        }
      }
    }
    if (on) {
      if (first_row) put8(first + g * f + at, acc);
      put8(last + g * f + at, acc);
    }
    if (row_end == r0 + n) {  // the last row ends with the run
      if (first_row) ends_here = came;
      if (on && !(first_row && came)) put8(out + (long long)row * f + at, acc);
    }
  }
  __syncthreads();
  if (!on) return;

  // 2. a row that came in and ends here: the fold of its runs' sums
  if (ends_here) {
    const bool came_in = head_start < e_block;
    float sum[8];
    fold_runs(first, last, f, at, came_in ? 0 : (head_start - e_block) / kRun,
              came_in, g, sum);
    put8((came_in ? a.carry_in + (long long)b * f
                  : out + (long long)head_row * f) + at, sum);
  }
  // the block's last row where it goes on to the next block
  if (n > 0 && r0 + n == e_end && row_end > e_end) {
    const bool came_in = first_row && head_start < e_block;
    const int from = !first_row ? g
                     : came_in  ? 0
                                : (head_start - e_block) / kRun;
    float sum[8];
    fold_runs(first, last, f, at, from, came_in, g, sum);
    put8((came_in ? a.carry_in : a.carry_out) + (long long)b * f + at, sum);
  }
}

// 3. The rows that cross a block's end.  Warp w of fold()'s block k takes
// boundary b = k * kFoldWarps + w + 1 (between walk blocks b - 1 and b)
// and the row that crosses it, if the row starts in block b - 1.  The
// row's partials are p_0 = carry_out[b - 1] and p_j = carry_in[b - 1 + j];
// range q holds p_{q * kFoldRange} .. p_{(q + 1) * kFoldRange - 1}, each
// range is left-folded and then the ranges are, in order.  A row of one
// range (the common case: a row crossing one end) is folded by its warp,
// 4 elements a lane; a longer one (a hub) by the whole block, its warps
// each summing a range in turn, then its threads folding the ranges' sums
// in range order, 4 elements each.
__device__ __forceinline__ void fold(const Args& a) {
  __shared__ __align__(16) float4 sums[kFoldWarps][kMaxF / 4];
  __shared__ int long_row[kFoldWarps], long_n[kFoldWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b = blockIdx.x * kFoldWarps + warp + 1;
  const int f4 = a.f / 4;
  const float4* carry_out = reinterpret_cast<const float4*>(a.carry_out);
  const float4* carry_in = reinterpret_cast<const float4*>(a.carry_in);
  float4* out = reinterpret_cast<float4*>(a.out);
  int r = b < a.n_blocks ? a.col_in[b] : -1, n = 0;
  if (r >= 0) {
    if (__ldg(a.ptr + r) < (b - 1) * kShare)
      r = -1;  // not its first boundary
    else
      n = (__ldg(a.ptr + r + 1) - 1) / kShare - b + 2;
  }
  // the sum of partials k0 .. k1 - 1 of boundary at's row, 4 elements at c
  auto range = [&](int at, int k0, int k1, int c) {
    const float4* in_b = carry_in + (long long)(at - 1) * f4;
    float4 acc = k0 == 0 ? carry_out[(long long)(at - 1) * f4 + c]
                         : in_b[(long long)k0 * f4 + c];
    for (int k = k0 + 1; k < k1; k += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k + u < k1) v[u] = in_b[(long long)(k + u) * f4 + c];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k + u < k1) {
          acc.x = __fadd_rn(acc.x, v[u].x);
          acc.y = __fadd_rn(acc.y, v[u].y);
          acc.z = __fadd_rn(acc.z, v[u].z);
          acc.w = __fadd_rn(acc.w, v[u].w);
        }
    }
    return acc;
  };
  if (r >= 0 && n <= kFoldRange)
    for (int c = lane; c < f4; c += 32)
      out[(long long)r * f4 + c] = range(b, 0, n, c);
  if (lane == 0) {
    long_row[warp] = n > kFoldRange ? r : -1;
    long_n[warp] = n;
  }
  __syncthreads();
  for (int w = 0; w < kFoldWarps; ++w) {
    const int row = long_row[w], rn = long_n[w];
    if (row < 0) continue;  // the same for the whole block
    const int rb = blockIdx.x * kFoldWarps + w + 1;
    const int n_ranges = (rn + kFoldRange - 1) / kFoldRange;
    float4 total = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = 0; base < n_ranges; base += kFoldWarps) {
      const int q = base + warp;
      if (q < n_ranges)
        for (int c = lane; c < f4; c += 32)
          sums[warp][c] = range(rb, q * kFoldRange,
                                min(rn, (q + 1) * kFoldRange), c);
      __syncthreads();
      if (t < f4) {
        const int m = min(kFoldWarps, n_ranges - base);
        for (int u = 0; u < m; ++u) {
          const float4 s = sums[u][t];
          if (base == 0 && u == 0) {
            total = s;
          } else {
            total.x = __fadd_rn(total.x, s.x);
            total.y = __fadd_rn(total.y, s.y);
            total.z = __fadd_rn(total.z, s.z);
            total.w = __fadd_rn(total.w, s.w);
          }
        }
      }
      __syncthreads();
    }
    if (t < f4) out[(long long)row * f4 + t] = total;
  }
}

typedef void (*Kernel)(Args);

// The walk over a list of n_rows rows and n_edges edges in n_blocks shares
// (checked: max(1, ceil(n_edges / kShare))), its kernel for F's group of
// lanes (walk_k: at L = 8, 16, 32), then fold() where `folds` (a row
// crosses a block's end), on `stream`, after checking the host's constants
// (share, fold_range), F and the alignments.  Returns a CUDA error code (0
// on success).
inline int launch(const Kernel (&walk_k)[3], Kernel fold_k, const void* ptr,
                  const void* idx, const void* eid, const void* val,
                  const void* x, void* out, void* carry_in, void* carry_out,
                  void* col_in, int n_rows, int n_edges, int n_blocks, int f,
                  int share, int fold_range, bool folds,
                  cudaStream_t stream) {
  const int want = n_edges > 0 ? (n_edges - 1) / kShare + 1 : 1;
  if (share != kShare || fold_range != kFoldRange || f % 8 || f < kMinF ||
      f > kMaxF || n_blocks != want ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  Args a;
  a.ptr = static_cast<const int32_t*>(ptr);
  a.idx = static_cast<const int32_t*>(idx);
  a.eid = static_cast<const int32_t*>(eid);
  a.val = static_cast<const float*>(val);
  a.x = static_cast<const uint4*>(x);
  a.out = static_cast<float*>(out);
  a.carry_in = static_cast<float*>(carry_in);
  a.carry_out = static_cast<float*>(carry_out);
  a.col_in = static_cast<int32_t*>(col_in);
  a.n_rows = n_rows;
  a.n_edges = n_edges;
  a.n_blocks = n_blocks;
  a.f = f;
  const int lanes = group_lanes(f);
  walk_k[lanes == 8 ? 0 : lanes == 16 ? 1 : 2]<<<n_blocks, kThreads, 0,
                                                  stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !folds || n_blocks < 2) return (int)err;
  fold_k<<<(n_blocks - 1 + kFoldWarps - 1) / kFoldWarps, 32 * kFoldWarps, 0,
           stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace share_walk
