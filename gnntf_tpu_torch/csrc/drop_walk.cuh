// K1's masked walk over a training grid's list (ell_gather.cu), out[r] =
// sum_e w(eid[e]) * x[idx[e]] over row r's edges, where w(id) is the edge's
// dropped value under the draw (Mask):
//
//     w = keep(id) ? val[id] * scale(id) : +0,
//     keep(id) = fmix32(fmix32(g ^ s0) ^ s1) >> 8 < thresh  or  g >= n_drop,
//     scale(id) = fp32(1 / keep) below n_drop, else 1,   g = id + id_base,
//
// in uint32 arithmetic, one rounded product, bit-equal to the host's
// dropped_values.  val holds float or __nv_bfloat16 (V: the training grids
// of GNNTF_GRID_VALUE_DTYPE=bfloat16, ops/stochastic.py); a bfloat16 value
// is widened exactly (__bfloat162float) before the product, so the weight
// is the float walk's over the rounded value, and each read moves half the
// bytes.  val is read at id, the mask hashed at the global id g:
// a rank that holds a slice of a larger edge list (id_base its offset)
// reads its own values and draws the whole list's mask.
//
// The order of the sums is edge_walk.cuh's: a row, or a piece of a split row
// (the units of ops/blocked.py::work_units), in list order, then a split
// row's pieces in `parts` parts (part g sums pieces g, g + parts, ... in
// turn) and the parts in order.  What differs is how a warp gets there.
// The host groups the list into segments (a whole row, or a piece, written
// to out[row] or to the piece's carry) and tiles of consecutive segments of
// about `items` items (ops/blocked.py::drop_tiles).  One warp takes a tile:
//
// 1. Stage.  The warp loads the tile's segment ends and outputs, and every
//    edge's id (and source), 32 * kBatches of each at once with coalesced
//    loads; hashes each edge; loads val for the kept edges only (over a
//    list without eid, with the ids, as the loads are coalesced anyway);
//    and, with a ballot, writes the kept edges in list order to shared
//    memory (their weight and source), with each segment's end in that kept
//    list.  The next tile's bounds are loaded while this one is summed.
//    That is one or two rounds of loads a chunk of 32 * kBatches edges,
//    where edge_walk.cuh's walk chains one a batch of `group` edges and
//    one a row end.
// 2. Sum.  The warp's lanes form 32 / group sub-groups of `group` lanes
//    (F / 4 with float4 rows); the tile's segments are shared out to them
//    in runs of about equal kept counts, and each sub-group sums its run in
//    list order, kRing x rows in flight, the lanes spanning the features;
//    only kept edges' rows are gathered.
// A piece's sum goes to its carry, and edge_walk's parts and fix-up
// kernels add a split row's pieces after the walk, as for K1 and K2.
// (Finishing split rows inside the walk's launch measured slower on the
// card each way it was built: the last piece of a part summing the part
// behind a counter, in the tile loop, whose registers the sums' code then
// took; and warps summing the split rows once every tile was claimed from
// a counter, which left a tail after the last tile.  So did the next
// tile's loads issued before this tile's sum: PERF.md.)  The degree walk,
// a sum of width one, has a design of its own (degree_walk.cuh).
//
// Leaving a dropped edge out adds nothing that changes a bit: its term is
// +0 * x = +-0 for a finite x, and a sum that starts at +0 is never -0, so
// adding +-0 leaves it as it is.  Where x holds an inf or a NaN, +0 * x is
// NaN, which JAX's product keeps.  So each warp of the masked walk also
// checks a slice of x (a few loads with each tile's, the rest after its
// last tile) and sets a flag where it finds an inf or a NaN; a second
// launch of the walk (pass 1) returns at once unless the flag is set, and
// then walks again staging every edge, the dropped ones with weight +0, so
// their +0 * x terms are added as the plain version adds them.  The flag
// is device memory, zeroed before pass 0, so a CUDA graph replay takes each
// replay's x.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_walk.cuh"

namespace drop_walk {

using edge_walk::Args;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// batches of 32 edges whose loads a warp issues together when it stages
// (k2_sweep.py builds others)
#ifndef DROP_BATCHES
#define DROP_BATCHES 4
#endif
constexpr int kBatches = DROP_BATCHES;
// x rows a sub-group keeps in flight (k2_sweep.py builds others)
#ifndef DROP_RING
#define DROP_RING 8
#endif
constexpr int kRing = DROP_RING;
// least resident blocks of a walk an SM, as __launch_bounds__ asks
// (k2_sweep.py builds others)
#ifndef DROP_MIN_BLOCKS
#define DROP_MIN_BLOCKS 3
#endif
constexpr int kMinBlocks = DROP_MIN_BLOCKS;
// loads of x a lane issues with each tile's loads, and after its last tile,
// when it checks its slice
constexpr int kCheckLoads = 2;
constexpr int kCheckTail = 4;

// The draw.  The salt pair is read from device memory, once a thread at the
// kernel's start, so a launch captured in a CUDA graph takes the draw that
// the buffer holds at each replay; the rest is fixed for a layer over a run
// and comes as kernel scalars (ops/stochastic.py::draw_scalars).
struct Mask {
  const int64_t* salt;  // (2,) int64 holding the draw's two uint32 salts
  uint32_t thresh;      // round(keep * 2^24), at most 2^24
  uint32_t n_drop;      // global ids at or past it are always kept, unscaled
  uint32_t id_base;     // added to an id to give the global id hashed
  float scale;          // fp32(1 / keep)
};

// The tiles of a list (ops/blocked.py::drop_tiles): tile t holds segments
// tile_seg[t] .. tile_seg[t+1] - 1 and edges tile_edge[t] .. tile_edge[t+1]
// - 1; segment s ends at edge seg_end[s] (it starts where s - 1 ends) and is
// written to out row seg_out[s], or, for a piece of a split row, to carry
// slot ~seg_out[s] (its unit).  cap_edges and cap_segs bound a tile's.
struct Tiles {
  const int32_t* tile_seg;
  const int32_t* tile_edge;
  const int32_t* seg_end;
  const int32_t* seg_out;
  int n_tiles, cap_edges, cap_segs;
};

// A pass of the masked walk: pass 0 checks x (n_x T's) and sets *flag where
// it holds an inf or a NaN; pass 1 runs only where *flag is set.
struct Pass {
  int* flag;
  long long n_x;
  int pass;
};

// A warp's words of shared memory: each edge's place in the kept list (and
// the count at the end), the kept edges' sources and weights, each
// segment's end in the kept list and its output, and the sub-groups' first
// segments.
__host__ __device__ inline int stage_words(int cap_edges, int cap_segs) {
  return (cap_edges + 1) + 2 * cap_edges + 2 * cap_segs + 33;
}

template <typename T>
__device__ __forceinline__ void put(T* __restrict__ out,
                                    T* __restrict__ carry, int to, int fv,
                                    int j, const T& acc) {
  if (to >= 0)
    out[(long long)to * fv + j] = acc;
  else
    carry[(long long)(~to) * fv + j] = acc;
}

// A base value as float: a bfloat16 value widened exactly.
__device__ __forceinline__ float value(float v) { return v; }
__device__ __forceinline__ float value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ bool nonfinite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}
__device__ __forceinline__ bool nonfinite(float4 v) {
  return nonfinite(v.x) | nonfinite(v.y) | nonfinite(v.z) | nonfinite(v.w);
}

// Loads kLoads T's of x at i, i + 32, ... below end (zeros past it) into v
// and advances i past them: a lane's share of its warp's slice of x, which
// pass 0 checks for an inf or a NaN a few loads a tile.
template <int kLoads, typename T>
__device__ __forceinline__ void load_slice(const T* __restrict__ x,
                                           long long& i, long long end,
                                           T (&v)[kLoads]) {
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    edge_walk::set_zero(v[u]);
    if (i + 32 * u < end) v[u] = x[i + 32 * u];
  }
  i += 32 * kLoads;
}

// The sub-group that sums segment k: segments go to the ng sub-groups in
// runs, by the kept edges before them.
__device__ __forceinline__ int share(const int* seg, int k, int n_kept,
                                     int ng) {
  if (k == 0 || n_kept == 0) return 0;
  return min(ng - 1, seg[k - 1] * ng / n_kept);
}

// T: a row's float or float4 (out and x hold fv of them a row); V: the
// base values' type.
template <typename T, typename V>
__device__ __forceinline__ void walk(const Args& a, const Tiles& t,
                                     const Mask& m, const Pass& p) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  // pass 0 stages kept edges only and checks this warp's slice of x (n_x
  // T's cut over every warp of the grid) from ci to ci_end; pass 1 (x holds
  // an inf or a NaN) stages every edge
  bool all = false, bad = false;
  long long ci = 0, ci_end = 0;
  if (p.pass == 1) {
    if (*p.flag == 0) return;
    all = true;
  } else {
    const long long warps = (long long)gridDim.x * kWarps;
    const long long per = (p.n_x + warps - 1) / warps;
    const long long at = ((long long)blockIdx.x * kWarps + warp) * per;
    ci = at + lane;
    ci_end = min(p.n_x, at + per);
  }
  int* kpos = smem + warp * stage_words(t.cap_edges, t.cap_segs);
  int* src = kpos + t.cap_edges + 1;
  float* w = reinterpret_cast<float*>(src + t.cap_edges);
  int* seg = reinterpret_cast<int*>(w + t.cap_edges);
  int* dst = seg + t.cap_segs;
  int* first = dst + t.cap_segs;

  const int32_t* __restrict__ eid = a.eid;
  const int32_t* __restrict__ idx = a.idx;
  const V* __restrict__ val = reinterpret_cast<const V*>(a.val);
  T* __restrict__ out = static_cast<T*>(a.out);
  T* __restrict__ carry = static_cast<T*>(a.carry);
  const int fv = a.fv;
  const uint32_t s0 = (uint32_t)m.salt[0], s1 = (uint32_t)m.salt[1];
  const unsigned below = (1u << lane) - 1u;

  long long tile = (long long)blockIdx.x * kWarps + warp;
  const long long stride = (long long)gridDim.x * kWarps;
  // the tile's bounds, loaded a tile ahead
  int bounds[4] = {0, 0, 0, 0};
  if (tile < t.n_tiles) {
    bounds[0] = t.tile_seg[tile];
    bounds[1] = t.tile_seg[tile + 1];
    bounds[2] = t.tile_edge[tile];
    bounds[3] = t.tile_edge[tile + 1];
  }
  for (; tile < t.n_tiles; tile += stride) {
    // 1. stage: the tile's segments and edges
    const int g0 = bounds[0], n_seg = bounds[1] - g0;
    const int e0 = bounds[2], n_edge = bounds[3] - e0;
    if (tile + stride < t.n_tiles) {
      bounds[0] = t.tile_seg[tile + stride];
      bounds[1] = t.tile_seg[tile + stride + 1];
      bounds[2] = t.tile_edge[tile + stride];
      bounds[3] = t.tile_edge[tile + stride + 1];
    }
    // the first 64 segments' ends and outputs, and a few T's of x's slice
    // (pass 0), loaded with the first chunk of edges
    int end[2], to[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      end[q] = 0;
      to[q] = 0;
      if (32 * q + lane < n_seg) {
        end[q] = t.seg_end[g0 + 32 * q + lane];
        to[q] = t.seg_out[g0 + 32 * q + lane];
      }
    }
    T cv[kCheckLoads];
    load_slice(x, ci, ci_end, cv);
    int n_kept = 0;
    for (int c = 0; c < n_edge; c += 32 * kBatches) {
      int id[kBatches], from[kBatches];
      float v0[kBatches];  // val at the id, over a list without eid
#pragma unroll
      for (int b = 0; b < kBatches; ++b) {
        const int i = c + 32 * b + lane;
        id[b] = 0;
        from[b] = 0;
        v0[b] = 0.f;
        if (i < n_edge) {
          id[b] = eid ? eid[e0 + i] : e0 + i;
          if (!eid) v0[b] = value(val[e0 + i]);
          from[b] = idx[e0 + i];
        }
      }
      bool kept[kBatches];
      float wt[kBatches];
#pragma unroll
      for (int b = 0; b < kBatches; ++b) {
        const uint32_t u = (uint32_t)id[b] + m.id_base;
        const bool low = u < m.n_drop;
        kept[b] = c + 32 * b + lane < n_edge &&
                  (!low || (edge_walk::fmix32(edge_walk::fmix32(u ^ s0) ^
                                              s1) >> 8) < m.thresh);
        wt[b] = 0.f;
        if (kept[b])
          wt[b] = __fmul_rn(eid ? value(val[id[b]]) : v0[b],
                            low ? m.scale : 1.f);
      }
#pragma unroll
      for (int b = 0; b < kBatches; ++b) {
        const int i = c + 32 * b + lane;
        const bool take = kept[b] || (all && i < n_edge);
        const unsigned ballot = __ballot_sync(0xffffffffu, take);
        const int pos = n_kept + __popc(ballot & below);
        if (i < n_edge) kpos[i] = pos;
        if (take) {
          src[pos] = from[b];
          w[pos] = wt[b];
        }
        n_kept += __popc(ballot);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (32 * q + lane < n_seg) {
        seg[32 * q + lane] = end[q] - e0;
        dst[32 * q + lane] = to[q];
      }
    }
    for (int k = 64 + lane; k < n_seg; k += 32) {
      seg[k] = t.seg_end[g0 + k] - e0;
      dst[k] = t.seg_out[g0 + k];
    }
#pragma unroll
    for (int u = 0; u < kCheckLoads; ++u) bad |= nonfinite(cv[u]);
    if (lane == 0) kpos[n_edge] = n_kept;
    __syncwarp();
    for (int k = lane; k < n_seg; k += 32) seg[k] = kpos[seg[k]];
    __syncwarp();

    // 2. sum: seg[k] is now where segment k ends in the kept list
    const int group = a.group, ng = 32 / group;
    for (int k = lane; k <= n_seg; k += 32) {
      const int hi = k == n_seg ? ng : share(seg, k, n_kept, ng);
      const int lo = k == 0 ? -1 : share(seg, k - 1, n_kept, ng);
      for (int h = lo + 1; h <= hi; ++h) first[h] = k;
    }
    __syncwarp();
    const int g = lane / group;
    const int k0 = g < ng ? first[g] : 0, k1 = g < ng ? first[g + 1] : 0;
    for (int j0 = 0; k0 < k1 && j0 < fv; j0 += group) {
      const int j = j0 + lane - g * group;
      const bool on = j < fv;
      int k = k0, stop = seg[k0];
      const int i_end = seg[k1 - 1];
      T acc;
      edge_walk::set_zero(acc);
      for (int i = k0 ? seg[k0 - 1] : 0; i < i_end; i += kRing) {
        T v[kRing];
#pragma unroll
        for (int u = 0; u < kRing; ++u) {
          edge_walk::set_zero(v[u]);
          if (on && i + u < i_end) v[u] = x[(long long)src[i + u] * fv + j];
        }
#pragma unroll
        for (int u = 0; u < kRing; ++u) {
          if (i + u < i_end) {
            while (i + u >= stop) {  // segments ending before kept i + u
              if (on) put(out, carry, dst[k], fv, j, acc);
              edge_walk::set_zero(acc);
              stop = seg[++k];
            }
            edge_walk::mul_add(acc, w[i + u], v[u]);
          }
        }
      }
      for (; k < k1; ++k) {  // the last segment, then empty ones
        if (on) put(out, carry, dst[k], fv, j, acc);
        edge_walk::set_zero(acc);
      }
    }

    __syncwarp();  // the next tile overwrites the stage
  }
  if (p.pass == 0) {  // the rest of this warp's slice of x
    while (ci < ci_end) {
      T cv[kCheckTail];
      load_slice(x, ci, ci_end, cv);
#pragma unroll
      for (int u = 0; u < kCheckTail; ++u) bad |= nonfinite(cv[u]);
    }
    if (__any_sync(0xffffffffu, bad) && lane == 0) *p.flag = 1;
  }
}

typedef void (*Kernel)(Args, Tiles, Mask, Pass);

// The walk's grid: at most as many blocks as fit on the card at once (each
// warp loops over tiles), with its shared memory.  Returns a CUDA error
// code (0 on success).
inline int grid(Kernel walk_k, Kernel again_k, const Tiles& t,
                unsigned& blocks, size_t& smem) {
  smem = (size_t)kWarps * stage_words(t.cap_edges, t.cap_segs) * sizeof(int);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    const Kernel both[2] = {walk_k, again_k};
    for (Kernel k : both) {
      err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  int device, sms, per_sm;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_k,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long need = ((long long)t.n_tiles + kWarps - 1) / kWarps;
  const long long most = (long long)per_sm * sms;
  blocks = (unsigned)(need < most ? need : most);
  return (int)cudaSuccess;
}

// The masked walk on `stream`: the flag zeroed, pass 0 (walk_k), then pass
// 1 (again_k, the same walk under another name so a profile tells them
// apart), then edge_walk::finish() (the parts and the fix-up of the split
// rows).  Returns a CUDA error code (0 on success).
inline int launch(Kernel walk_k, Kernel again_k, edge_walk::Kernel parts_k,
                  edge_walk::Kernel fixup_k, const Args& a, const Tiles& t,
                  const Mask& m, int* flag, long long n_x,
                  cudaStream_t stream) {
  if (t.n_tiles == 0) return (int)cudaSuccess;
  if (flag == nullptr) return (int)cudaErrorInvalidValue;
  unsigned blocks;
  size_t smem;
  int err = grid(walk_k, again_k, t, blocks, smem);
  if (err != (int)cudaSuccess) return err;
  cudaError_t e = cudaMemsetAsync(flag, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  walk_k<<<blocks, kThreads, smem, stream>>>(a, t, m, Pass{flag, n_x, 0});
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  again_k<<<blocks, kThreads, smem, stream>>>(a, t, m, Pass{flag, n_x, 1});
  return edge_walk::finish(parts_k, fixup_k, a, stream);
}

inline Tiles make_tiles(const void* tile_seg, const void* tile_edge,
                        const void* seg_end, const void* seg_out,
                        int n_tiles, int cap_edges, int cap_segs) {
  Tiles t;
  t.tile_seg = static_cast<const int32_t*>(tile_seg);
  t.tile_edge = static_cast<const int32_t*>(tile_edge);
  t.seg_end = static_cast<const int32_t*>(seg_end);
  t.seg_out = static_cast<const int32_t*>(seg_out);
  t.n_tiles = n_tiles;
  t.cap_edges = cap_edges;
  t.cap_segs = cap_segs;
  return t;
}

inline Mask make_mask(const void* salt, unsigned thresh, unsigned n_drop,
                      unsigned id_base, float scale) {
  Mask m;
  m.salt = static_cast<const int64_t*>(salt);
  m.thresh = thresh;
  m.n_drop = n_drop;
  m.id_base = id_base;
  m.scale = scale;
  return m;
}

}  // namespace drop_walk
