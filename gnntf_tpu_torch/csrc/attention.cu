// The attention chain of a GAT layer: four walks over the attention lists.
//
// They replace the chain that the JAX package computes in XLA,
// gnntf_tpu/ops/attention.py::_make_gat_core: its forward (:321-346, the
// score gather, segment max and sum, and the weighted aggregation) and its
// recompute backward (:357-423, the row pass and the column pass).  With h
// (N, H, F) the projected features, s_src and s_dst (N, H) the score
// halves, and over a list of (dst, src) slots with multiplicity `mult`:
//
//     pre = s_src[src] + s_dst[dst],  sg = leaky_relu(pre, slope),
//     rmax0[dst] = max over dst's slots of sg (0 where none or not finite),
//     dinv[dst] = 1 / max(sum mult * exp(sg - rmax0[dst]), 1e-30),
//     alpha = mult * exp(sg - rmax0[dst]) * dinv[dst],
//     alpha~ = alpha * scale(eid, head),
//
// where scale is the attention dropout (edge_walk.cuh's fmix32):
// base = fmix32(eid ^ s0), hh = fmix32(base ^ (s1 + head * 0x9E3779B9)),
// kept if (hh >> 8) < thresh, then fp32(1 / keep), else 0; self-loops are
// dropped too.  With no salt (null) the scale is 1 and not applied.
//
// * attn_stats_* (A1): rmax0 and dinv, per (dst, head), over the row list;
// * attn_aggregate_* (A2): out[dst, h, :] = sum alpha~ h[src, h, :];
// * attn_bwd_rows_* (A3): per (dst, head), with g the output's gradient,
//   rowdot = sum alpha dalpha and ds_dst = sum (alpha dalpha - alpha
//   rowdot) sigma'(pre), where dalpha = <h[src, h, :], g[dst, h, :]> *
//   scale and sigma' is 1 where pre > 0, else slope; ds_dst is computed as
//   P - rowdot * Q with P = sum alpha dalpha sigma' and Q = sum alpha
//   sigma', so one pass over a row gives both; where a rowdot is given
//   (a rank's slice of the edges, whose rows' rowdot is the sum over every
//   slice), ds_dst takes it in place of the row's own;
// * attn_bwd_cols_* (A4): over the column list (the transpose: a row is a
//   source c, its slots its destinations), dh[c, h, :] = sum alpha~
//   g[dst, h, :] and ds_src[c, h] = sum (alpha dalpha - alpha rowdot[dst])
//   sigma'(pre).
//
// Tables.  A slot gathers one row of a packed table, as the JAX package
// does (:299-307, :385-396): the row pass reads `tab` = [h | s_src] at src,
// the column pass `tabc` = [g | s_dst, rmax0, dinv, rowdot of each head] at
// dst, each padded to a multiple of 4 floats a row (`ld`, `ldc`), so a
// lane's feature part is one aligned float4 (and A4's four scalars of a
// head another) and the narrow parts sit in the same lines.  The column pass reads its own row's h and s_src from `tab`.
//
// Work.  The units of edge_walk.cuh (ops/blocked.py::work_units): a run of
// whole rows, or a piece of a longer row.  A2 gives a unit `group` lanes
// over the row's W = H * F features, float4 loads where F is a multiple of
// 4, each lane computing the coefficient of its head; A3 and A4 give it
// whole heads of lanes over the same features (head_lanes below), each
// slot's dot over a head summed across the head's lanes by shuffles in a
// fixed tree; A1 gives a unit `sgroup` lanes, one a head, each walking the
// unit's slots in list order.  Each lane issues the index and gather loads
// of kLoads slots before it adds their terms.  A4 is one walk over the
// column list: a slot's `tabc` row is
// gathered once for dh and ds_src.  Rows without slots are written (rmax0
// 0, dinv 1e30, sums 0), so nothing is zero-filled.  A piece writes its
// sums to `carry`; a split row's pieces are summed in `parts` parts
// (edge_walk.cuh's sum_parts; A3's three sums and A4's dh and ds_src in
// one carry row, a warp an item) and the parts in order.  A1 takes the
// row's maximum first (the pieces' maxima, in parts, then the row's), then
// the pieces' sums with it; A3 merges its three sums after the fix-up.  So
// every sum runs in a fixed order, with no atomics: two launches give the
// same bits, and the plain versions (ops/attention.py) repeat the order.
// Arithmetic: expf (not __expf), explicit _rn roundings, no fused
// multiply-add.
//
// Bound.  Memory: a slot's index (and its id where the list reads one) and
// its gathered row of the table, the per-row tables and the outputs once.
// The exponentials are far below the card's fp32 rate.  A3 and A4 lose
// most to the latency of their gathers: per-feature lanes issue a slot's
// row as one 16-byte load a lane, a few slots at once, where a lane a head
// issued its F-wide dot's loads one after another.  chip_smoke.py
// phase 2e computes each kernel's bytes from the lists and tables it runs.
#include <math.h>

#include "edge_walk.cuh"

namespace attention {

// One launch's arguments; ops/attention.py::_Args mirrors the layout.
struct AttnArgs {
  const int32_t* ptr;
  const int32_t* idx;
  const int32_t* eid;        // null: the identity
  const int32_t* unit_row;
  const int32_t* unit_edge;
  const int32_t* split;
  const int32_t* part_item;
  const float* mult;         // one an id; null: 1
  const int64_t* salt;       // (2,) the dropout's salts; null: no dropout
  const float* tab;          // [h | s_src], ld floats a row
  const float* tabc;         // [g | (s_dst, rmax0, dinv, rowdot) a head], ldc
  const float* s_dst;        // (N, H), the row pass
  const float* rmax0;        // (N, H), A2 and A3
  const float* dinv;         // (N, H), A2 and A3
  const float* g;            // (N, W), A3
  const float* rowdot;       // (N, H), A3: given (null: the row's own sum)
  float* out;                // A1 rmax0, A2 out, A3 rowdot, A4 dh
  float* out2;               // A1 dinv, A3 ds_dst, A4 ds_src
  float* carry;              // pieces, then the split rows' parts
  int n_units, n_split, n_part_items, parts;
  int heads, feats, ld, ldc;
  int vec, group, sgroup;
  uint32_t thresh;
  float scale, slope;
};

}  // namespace attention

namespace {

using attention::AttnArgs;
using edge_walk::group_blocks;
using edge_walk::group_item;
using edge_walk::mul_add;
using edge_walk::set_zero;

constexpr int kThreads = edge_walk::kThreads;
constexpr uint32_t kGold = 0x9E3779B9u;
// slots whose loads a lane issues before it adds their terms
constexpr int kLoads = 4;
// the same for A3 and for A4, and the least resident blocks of their walks
// an SM, as __launch_bounds__ asks the compiler for: of (A3, A4, blocks) in
// (4,2,4) (2,4,4) (8,1,4) (4,2,3) (2,4,3) (8,1,3), these were the fastest
// over both layer shapes on an H100 (PERF.md, attention)
constexpr int kRowsLoads = 4;
constexpr int kColsLoads = 2;
constexpr int kBwdMinBlocks = 4;

struct Drop {
  bool on;
  uint32_t s0, s1, thresh;
  float scale;
};

__device__ __forceinline__ Drop load_drop(const AttnArgs& a) {
  Drop d{};
  d.on = a.salt != nullptr;
  if (d.on) {
    d.s0 = (uint32_t)a.salt[0];
    d.s1 = (uint32_t)a.salt[1];
    d.thresh = a.thresh;
    d.scale = a.scale;
  }
  return d;
}

// The dropout's scale of (id, head): fp32(1 / keep) where kept, else 0.
__device__ __forceinline__ float keep_scale(const Drop& d, uint32_t id,
                                            int head) {
  const uint32_t base = edge_walk::fmix32(id ^ d.s0);
  const uint32_t hh =
      edge_walk::fmix32(base ^ (d.s1 + (uint32_t)head * kGold));
  return (hh >> 8) < d.thresh ? d.scale : 0.f;
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : __fmul_rn(slope, x);
}

__device__ __forceinline__ float slope_of(float pre, float slope) {
  return pre > 0.f ? 1.f : slope;
}

// mult * exp(leaky(pre) - m0), as the JAX package rounds it
__device__ __forceinline__ float weight(float pre, float m0, float mu,
                                        float slope) {
  return __fmul_rn(expf(__fsub_rn(leaky(pre, slope), m0)), mu);
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float((int)0xff800000);
}

template <typename T>
__device__ __forceinline__ T load(const float* p) {
  return *reinterpret_cast<const T*>(p);
}

// d += <h, g>, the products added in feature order
__device__ __forceinline__ void dot_add(float& d, float h, float g) {
  d = __fadd_rn(d, __fmul_rn(h, g));
}
__device__ __forceinline__ void dot_add(float& d, float4 h, float4 g) {
  dot_add(d, h.x, g.x);
  dot_add(d, h.y, g.y);
  dot_add(d, h.z, g.z);
  dot_add(d, h.w, g.w);
}

// <p[0:F], q[0:F]> in feature order, T-wide loads
template <typename T>
__device__ __forceinline__ float dot(const float* p, const float* q, int f) {
  constexpr int kv = sizeof(T) / sizeof(float);
  float d = 0.f;
  for (int i = 0; i < f; i += kv) dot_add(d, load<T>(p + i), load<T>(q + i));
  return d;
}

// A unit: list rows [r0, r1) whole, or (piece) slots [e0, e1) of row r0.
struct Unit {
  bool piece;
  int r0, r1, e0, e1;
};

__device__ __forceinline__ Unit unit_at(const AttnArgs& a, long long u) {
  Unit t;
  const int head = a.unit_row[u];
  const int next = a.unit_row[u + 1];
  t.piece = head < 0;
  t.r0 = t.piece ? ~head : head;
  t.r1 = t.piece ? t.r0 + 1 : (next < 0 ? ~next : next);
  t.e0 = a.unit_edge[u];
  t.e1 = a.unit_edge[u + 1];
  return t;
}

// The slots of row r of unit t: [b, end).
__device__ __forceinline__ void slots(const AttnArgs& a, const Unit& t, int r,
                                      int& b, int& end) {
  b = t.piece ? t.e0 : a.ptr[r];
  end = t.piece ? t.e1 : a.ptr[r + 1];
}

// The index and id of N slots from e (the last slot repeated past end, so
// every load is unconditional).
template <int N = kLoads>
__device__ __forceinline__ void load_slots(const AttnArgs& a, int e, int end,
                                           int* src, uint32_t* id) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int s = min(e + u, end - 1);
    src[u] = a.idx[s];
    id[u] = a.eid ? (uint32_t)a.eid[s] : (uint32_t)s;
  }
}

__device__ __forceinline__ float mult_of(const AttnArgs& a, uint32_t id) {
  return a.mult ? a.mult[id] : 1.f;
}

// ---- A1: rmax0 and dinv over the row list --------------------------------

// Whole rows: the row's maximum, then its sum.  A piece: its maximum, into
// carry (its sum waits for the row's maximum: attn_stats_pieces).
__global__ void __launch_bounds__(kThreads, edge_walk::kMinBlocks)
    attn_stats_walk(const AttnArgs a) {
  int lane;
  const long long unit = group_item(a.sgroup, a.n_units, lane);
  if (unit < 0) return;
  const Unit t = unit_at(a, unit);
  const int H = a.heads, W = a.heads * a.feats;
  for (int h = lane; h < H; h += a.sgroup) {
    for (int r = t.r0; r < t.r1; ++r) {
      int b, end;
      slots(a, t, r, b, end);
      const float sd = a.s_dst[(long long)r * H + h];
      float m = neg_inf();
      for (int e = b; e < end; e += kLoads) {
        int src[kLoads];
        uint32_t id[kLoads];
        load_slots(a, e, end, src, id);
        float ss[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          ss[u] = a.tab[(long long)src[u] * a.ld + W + h];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const float sg = leaky(__fadd_rn(ss[u], sd), a.slope);
          if (e + u < end && sg > m) m = sg;
        }
      }
      if (t.piece) {
        a.carry[unit * H + h] = m;
        continue;
      }
      const float m0 = isfinite(m) ? m : 0.f;
      float s = 0.f;
      for (int e = b; e < end; e += kLoads) {
        int src[kLoads];
        uint32_t id[kLoads];
        load_slots(a, e, end, src, id);
        float ss[kLoads], mu[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          ss[u] = a.tab[(long long)src[u] * a.ld + W + h];
          mu[u] = mult_of(a, id[u]);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          if (e + u < end)
            s = __fadd_rn(s, weight(__fadd_rn(ss[u], sd), m0, mu[u], a.slope));
      }
      a.out[(long long)r * H + h] = m0;
      a.out2[(long long)r * H + h] = __fdiv_rn(1.f, fmaxf(s, 1e-30f));
    }
  }
}

// The maximum of p[0], p[stride], ..., p[(n-1) * stride] (order-free),
// with kSumLoads loads in flight.
__device__ __forceinline__ float strided_max(const float* __restrict__ p,
                                             long long stride, int n) {
  constexpr int kIn = edge_walk::kSumLoads;
  float m = neg_inf();
  for (int k = 0; k < n; k += kIn) {
    float v[kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u)
      v[u] = k + u < n ? p[(long long)(k + u) * stride] : neg_inf();
#pragma unroll
    for (int u = 0; u < kIn; ++u)
      if (v[u] > m) m = v[u];
  }
  return m;
}

// Item i, part_item[i] = s * parts + g: the maximum of split row s's pieces
// g, g + parts, ..., as sum_parts takes them, so a hub row's pieces spread
// over the card.
__global__ void __launch_bounds__(32) attn_stats_part_max(const AttnArgs a) {
  int lane;
  const long long item = group_item(a.sgroup, a.n_part_items, lane);
  if (item < 0) return;
  const int H = a.heads;
  const int v = a.part_item[item];
  const long long s = v / a.parts;
  const int g = v - (int)s * a.parts;
  const long long first = a.split[3 * s + 1];
  const int n = (a.split[3 * s + 2] - g + a.parts - 1) / a.parts;
  for (int h = lane; h < H; h += a.sgroup)
    a.carry[((long long)a.n_units + s * a.parts + g) * H + h] = strided_max(
        a.carry + (first + g) * H + h, (long long)a.parts * H, n);
}

// Split row s: the maximum of its parts' maxima, rmax0.
__global__ void __launch_bounds__(32) attn_stats_rowmax(const AttnArgs a) {
  int lane;
  const long long s = group_item(a.sgroup, a.n_split, lane);
  if (s < 0) return;
  const int H = a.heads;
  const int row = a.split[3 * s];
  const int n = min(a.parts, a.split[3 * s + 2]);
  for (int h = lane; h < H; h += a.sgroup) {
    const float m = strided_max(
        a.carry + ((long long)a.n_units + s * a.parts) * H + h, H, n);
    a.out[(long long)row * H + h] = isfinite(m) ? m : 0.f;
  }
}

// A piece: its sum under the row's rmax0, into carry.
__global__ void __launch_bounds__(kThreads, edge_walk::kMinBlocks)
    attn_stats_pieces(const AttnArgs a) {
  int lane;
  const long long unit = group_item(a.sgroup, a.n_units, lane);
  if (unit < 0) return;
  const Unit t = unit_at(a, unit);
  if (!t.piece) return;
  const int H = a.heads, W = a.heads * a.feats;
  for (int h = lane; h < H; h += a.sgroup) {
    const float sd = a.s_dst[(long long)t.r0 * H + h];
    const float m0 = a.out[(long long)t.r0 * H + h];
    float s = 0.f;
    for (int e = t.e0; e < t.e1; e += kLoads) {
      int src[kLoads];
      uint32_t id[kLoads];
      load_slots(a, e, t.e1, src, id);
      float ss[kLoads], mu[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        ss[u] = a.tab[(long long)src[u] * a.ld + W + h];
        mu[u] = mult_of(a, id[u]);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (e + u < t.e1)
          s = __fadd_rn(s, weight(__fadd_rn(ss[u], sd), m0, mu[u], a.slope));
    }
    a.carry[unit * H + h] = s;
  }
}

__global__ void __launch_bounds__(32) attn_stats_parts(const AttnArgs a) {
  edge_walk::sum_parts<float>(a.split, a.part_item, a.carry,
                              a.carry + (long long)a.n_units * a.heads,
                              a.n_part_items, a.heads, a.sgroup, a.parts);
}

// Split row s: its parts in order, then dinv.
__global__ void __launch_bounds__(32) attn_stats_fixup(const AttnArgs a) {
  int lane;
  const long long s = group_item(a.sgroup, a.n_split, lane);
  if (s < 0) return;
  const int H = a.heads;
  const int row = a.split[3 * s];
  const int n = min(a.parts, a.split[3 * s + 2]);
  const float* part_sum = a.carry + (long long)a.n_units * H;
  for (int h = lane; h < H; h += a.sgroup) {
    const float d =
        edge_walk::ordered_sum(part_sum + s * a.parts * H + h, H, n);
    a.out2[(long long)row * H + h] = __fdiv_rn(1.f, fmaxf(d, 1e-30f));
  }
}

// ---- A2: the aggregation over the row list -------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, edge_walk::kMinBlocks)
    attn_aggregate_walk(const AttnArgs a) {
  constexpr int kv = sizeof(T) / sizeof(float);
  int lane;
  const long long unit = group_item(a.group, a.n_units, lane);
  if (unit < 0) return;
  const Unit t = unit_at(a, unit);
  const Drop d = load_drop(a);
  const int H = a.heads, W = a.heads * a.feats, fv = W / kv;
  T* out = reinterpret_cast<T*>(a.out);
  T* carry = reinterpret_cast<T*>(a.carry);
  for (int j = lane; j < fv; j += a.group) {
    const int head = j * kv / a.feats;
    for (int r = t.r0; r < t.r1; ++r) {
      int b, end;
      slots(a, t, r, b, end);
      const long long rh = (long long)r * H + head;
      const float sd = a.s_dst[rh], m0 = a.rmax0[rh], di = a.dinv[rh];
      T acc;
      set_zero(acc);
      for (int e = b; e < end; e += kLoads) {
        int src[kLoads];
        uint32_t id[kLoads];
        load_slots(a, e, end, src, id);
        float ss[kLoads], mu[kLoads];
        T v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const float* row = a.tab + (long long)src[u] * a.ld;
          ss[u] = row[W + head];
          v[u] = load<T>(row + j * kv);
          mu[u] = mult_of(a, id[u]);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          if (e + u < end) {
            float al = __fmul_rn(
                weight(__fadd_rn(ss[u], sd), m0, mu[u], a.slope), di);
            if (d.on) al = __fmul_rn(al, keep_scale(d, id[u], head));
            mul_add(acc, al, v[u]);
          }
        }
      }
      if (t.piece)
        carry[unit * fv + j] = acc;
      else
        out[(long long)r * fv + j] = acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32) attn_aggregate_parts(const AttnArgs a) {
  constexpr int kv = sizeof(T) / sizeof(float);
  const int fv = a.heads * a.feats / kv;
  const T* carry = reinterpret_cast<const T*>(a.carry);
  edge_walk::sum_parts<T>(a.split, a.part_item, carry,
                          reinterpret_cast<T*>(a.carry) +
                              (long long)a.n_units * fv,
                          a.n_part_items, fv, a.group, a.parts);
}

template <typename T>
__global__ void __launch_bounds__(32) attn_aggregate_fixup(const AttnArgs a) {
  constexpr int kv = sizeof(T) / sizeof(float);
  const int fv = a.heads * a.feats / kv;
  edge_walk::fix_rows<T, false>(
      a.split, nullptr,
      reinterpret_cast<const T*>(a.carry) + (long long)a.n_units * fv,
      reinterpret_cast<T*>(a.out), a.n_split, fv, a.group, a.parts);
}

// ---- A3 and A4: per-feature lanes, a head's dot reduced by shuffles ------
//
// A unit's `group` lanes span hp heads of ne lanes each (ops/attention.py::
// head_lanes): a head's F features are nq = F / kv vectors (float4 where F
// is a multiple of 4), ne = min(nq, 32), and lane i of a head takes its
// vectors i, i + ne, ... (chunks c = 0, 1, ...: one unless nq > 32); a pass
// takes hp heads, the passes go over the H heads.  A lane keeps its
// chunk-0 vector of the row's own table row (A3: g[r], A4: h[c]) in
// registers and gathers, for a few slots at once (kRowsLoads, kColsLoads),
// its vector of the slot's table row with the slot's per-head scalars.  A
// slot's dot over a head is each lane's partial (its features in order,
// from +0), then summed over the head's lanes by __shfl_sync in a fixed
// tree (head_sums); every lane of a head computes the slot's coefficient,
// and lane 0 of the head adds the slot's terms to its sums in slot order.

struct HeadLanes {
  int nq, ne, hp, nc;  // vectors a head, lanes a head, heads a pass, chunks
  int hh, i;           // this lane's head in a pass, its place in the head
  int me, last;        // this lane and the group's last, in the warp
  unsigned mask;       // the group's lanes
};

__device__ __forceinline__ HeadLanes head_lanes(const AttnArgs& a, int kv,
                                                int lane) {
  HeadLanes l;
  l.nq = a.feats / kv;
  l.ne = min(l.nq, 32);
  l.hp = a.group / l.ne;
  l.nc = (l.nq + l.ne - 1) / l.ne;
  l.hh = lane / l.ne;
  l.i = lane - l.hh * l.ne;
  l.me = threadIdx.x & 31;
  const int lane0 = l.me - lane;
  l.last = lane0 + a.group - 1;
  l.mask = a.group == 32 ? 0xffffffffu : ((1u << a.group) - 1u) << lane0;
  return l;
}

// Each slot's dot over the head from its lanes' partials p: in steps s = 1,
// 2, 4, ..., lane i (a multiple of 2s, i + s < ne) adds lane i + s's, so
// lane 0 of the head ends with the dot (ops/attention.py::_dots repeats
// the order).
template <int N>
__device__ __forceinline__ void head_sums(const HeadLanes& l, float (&p)[N]) {
  for (int s = 1; s < l.ne; s *= 2) {
    const int from = min(l.me + s, l.last);
    const bool take = (l.i & (2 * s - 1)) == 0 && l.i + s < l.ne;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const float o = __shfl_sync(l.mask, p[u], from);
      if (take) p[u] = __fadd_rn(p[u], o);
    }
  }
}

// The partials of the chunks after the first (nq > 32): p[u] += <x_u, y>
// over this lane's vectors c * ne + i, c >= 1, the x_u at x[u] and y at y.
template <typename T, int N>
__device__ __forceinline__ void later_chunks(const HeadLanes& l,
                                             const float* const (&x)[N],
                                             const float* y, float (&p)[N]) {
  constexpr int kv = sizeof(T) / sizeof(float);
  for (int c = 1; c < l.nc; ++c) {
    const int q = c * l.ne + l.i;
    if (q >= l.nq) break;
    const T yv = load<T>(y + q * kv);
#pragma unroll
    for (int u = 0; u < N; ++u) dot_add(p[u], load<T>(x[u] + q * kv), yv);
  }
}

// A piece's carry row of `cols` floats, padded to a multiple of 4 so that
// its parts are summed a float4 at a time (the padding's sums are never
// read).
__device__ __forceinline__ int carry_stride(int cols) {
  return (cols + 3) & ~3;
}

// ---- A3: the backward's row pass -----------------------------------------

// Per (row, head): rowdot, P and Q; whole rows write rowdot and ds_dst =
// P - rowdot * Q, a piece its three sums into carry.  kWide: heads of more
// than 32 vectors (nc > 1 chunks a lane).
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
    attn_bwd_rows_walk(const AttnArgs a) {
  constexpr int N = kRowsLoads;
  constexpr int kv = sizeof(T) / sizeof(float);
  int lane;
  const long long unit = group_item(a.group, a.n_units, lane);
  if (unit < 0) return;
  const HeadLanes l = head_lanes(a, kv, lane);
  const Unit t = unit_at(a, unit);
  const Drop d = load_drop(a);
  const int H = a.heads, F = a.feats, W = a.heads * a.feats;
  for (int h0 = 0; h0 < H; h0 += l.hp) {
    // lanes past the last head repeat it and write nothing
    const bool on = h0 + l.hh < H;
    const int head = on ? h0 + l.hh : H - 1;
    const int off = head * F + l.i * kv;
    for (int r = t.r0; r < t.r1; ++r) {
      int b, end;
      slots(a, t, r, b, end);
      const long long rh = (long long)r * H + head;
      const float sd = a.s_dst[rh], m0 = a.rmax0[rh], di = a.dinv[rh];
      const float* gr = a.g + (long long)r * W + head * F;
      const T gv = load<T>(gr + l.i * kv);
      float rd = 0.f, P = 0.f, Q = 0.f;
      for (int e = b; e < end; e += N) {
        int src[N];
        uint32_t id[N];
        load_slots<N>(a, e, end, src, id);
        const float* row[N];
        float ss[N], mu[N], p[N];
        T v[N];
#pragma unroll
        for (int u = 0; u < N; ++u) {
          row[u] = a.tab + (long long)src[u] * a.ld;
          ss[u] = row[u][W + head];
          v[u] = load<T>(row[u] + off);
          mu[u] = mult_of(a, id[u]);
        }
#pragma unroll
        for (int u = 0; u < N; ++u) {
          p[u] = 0.f;
          dot_add(p[u], v[u], gv);
          row[u] += head * F;
        }
        if (kWide) later_chunks<T>(l, row, gr, p);
        head_sums(l, p);
#pragma unroll
        for (int u = 0; u < N; ++u) {
          if (e + u < end) {
            const float pre = __fadd_rn(ss[u], sd);
            const float al = __fmul_rn(weight(pre, m0, mu[u], a.slope), di);
            float da = p[u];
            if (d.on) da = __fmul_rn(da, keep_scale(d, id[u], head));
            const float w = __fmul_rn(al, da);
            const float sp = slope_of(pre, a.slope);
            rd = __fadd_rn(rd, w);
            P = __fadd_rn(P, __fmul_rn(w, sp));
            Q = __fadd_rn(Q, __fmul_rn(al, sp));
          }
        }
      }
      if (!on || l.i != 0) continue;
      if (t.piece) {
        float* c = a.carry + unit * carry_stride(3 * H) + head;
        c[0] = rd;
        c[H] = P;
        c[2 * H] = Q;
      } else {
        a.out[rh] = rd;
        a.out2[rh] = __fsub_rn(P, __fmul_rn(a.rowdot ? a.rowdot[rh] : rd, Q));
      }
    }
  }
}

// Item i, part_item[i] = s * parts + g: part g of split row s, the sum of
// its pieces g, g + parts, ... in turn (edge_walk.cuh's sum_parts), over
// carry rows of `stride` floats, a warp an item, lanes over the float4s.
__device__ __forceinline__ void carry_parts(const AttnArgs& a, int stride) {
  int lane;
  const long long item = group_item(32, a.n_part_items, lane);
  if (item < 0) return;
  const int v = a.part_item[item];
  const long long s = v / a.parts;
  const int g = v - (int)s * a.parts;
  const long long first = a.split[3 * s + 1];
  const int n = (a.split[3 * s + 2] - g + a.parts - 1) / a.parts;
  const int fv = stride / 4;
  const float4* carry = reinterpret_cast<const float4*>(a.carry);
  float4* part_sum = reinterpret_cast<float4*>(a.carry) +
                     ((long long)a.n_units + s * a.parts + g) * fv;
  for (int j = lane; j < fv; j += 32)
    part_sum[j] = edge_walk::ordered_sum(carry + (first + g) * fv + j,
                                         (long long)a.parts * fv, n);
}

__global__ void __launch_bounds__(32) attn_bwd_rows_parts(const AttnArgs a) {
  carry_parts(a, carry_stride(3 * a.heads));
}

// Split row s, a warp: its parts in order, 10 heads at a time (lanes 0-9
// sum rowdot, 10-19 P, 20-29 Q), then rowdot and ds_dst.
__global__ void __launch_bounds__(32) attn_bwd_rows_fixup(const AttnArgs a) {
  int lane;
  const long long s = group_item(32, a.n_split, lane);
  if (s < 0) return;
  const int H = a.heads;
  const int row = a.split[3 * s];
  const int n = min(a.parts, a.split[3 * s + 2]);
  const int stride = carry_stride(3 * H);
  const float* ps = a.carry + ((long long)a.n_units + s * a.parts) * stride;
  const int which = lane / 10, k = lane - which * 10;
  for (int h0 = 0; h0 < H; h0 += 10) {
    const int h = h0 + k;
    float v = 0.f;
    if (which < 3 && h < H)
      v = edge_walk::ordered_sum(ps + which * H + h, stride, n);
    const float P = __shfl_sync(0xffffffffu, v, min(lane + 10, 31));
    const float Q = __shfl_sync(0xffffffffu, v, min(lane + 20, 31));
    if (which == 0 && h < H) {
      const long long rh = (long long)row * H + h;
      a.out[rh] = v;
      a.out2[rh] = __fsub_rn(P, __fmul_rn(a.rowdot ? a.rowdot[rh] : v, Q));
    }
  }
}

// ---- A4: the backward's column pass --------------------------------------

// A slot's s_dst, rmax0, dinv and rowdot of one head, side by side in its
// tabc row (ops/attention.py::column_table): one float4 where the lanes
// load float4s (W and ldc are then multiples of 4).
template <typename T>
__device__ __forceinline__ float4 head_scalars(const float* p) {
  if (sizeof(T) == sizeof(float4)) return load<float4>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

// One walk over the column list (a row is a source c, its slots' idx the
// destinations, whose `tabc` row is gathered once a slot): dh[c, :] per
// feature and ds_src[c, h] per head.  kWide: heads of more than 32
// vectors, whose later chunks' dh take a sweep of their own over the row's
// slots.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
    attn_bwd_cols_walk(const AttnArgs a) {
  constexpr int kv = sizeof(T) / sizeof(float);
  constexpr int N = kColsLoads;
  int lane;
  const long long unit = group_item(a.group, a.n_units, lane);
  if (unit < 0) return;
  const HeadLanes l = head_lanes(a, kv, lane);
  const Unit t = unit_at(a, unit);
  const Drop d = load_drop(a);
  const int H = a.heads, F = a.feats, W = a.heads * a.feats;
  const int wc = carry_stride(W + H);  // dh, then ds_src
  const int nc = kWide ? l.nc : 1;
  for (int h0 = 0; h0 < H; h0 += l.hp) {
    const bool on = h0 + l.hh < H;
    const int head = on ? h0 + l.hh : H - 1;
    for (int r = t.r0; r < t.r1; ++r) {
      int b, end;
      slots(a, t, r, b, end);
      const float* own = a.tab + (long long)r * a.ld;
      const float ssc = own[W + head];
      own += head * F;
      // chunk 0 sums dh and ds_src; a later chunk its part of dh
      for (int c = 0; c < nc; ++c) {
        const int q = c * l.ne + l.i;
        const bool q_on = !kWide || q < l.nq;
        const int off = (q_on ? q : l.nq - 1) * kv;
        const T hv = load<T>(own + off);
        T acc;
        set_zero(acc);
        float ds = 0.f;
        for (int e = b; e < end; e += N) {
          int dst[N];
          uint32_t id[N];
          load_slots<N>(a, e, end, dst, id);
          const float* row[N];
          float sd[N], m0[N], di[N], rdot[N], mu[N];
          T v[N];
#pragma unroll
          for (int u = 0; u < N; ++u) {
            row[u] = a.tabc + (long long)dst[u] * a.ldc;
            const float4 sc = head_scalars<T>(row[u] + W + 4 * head);
            sd[u] = sc.x;
            m0[u] = sc.y;
            di[u] = sc.z;
            rdot[u] = sc.w;
            row[u] += head * F;
            v[u] = load<T>(row[u] + off);
            mu[u] = mult_of(a, id[u]);
          }
          float al[N], keep[N];
#pragma unroll
          for (int u = 0; u < N; ++u) {
            al[u] = __fmul_rn(
                weight(__fadd_rn(ssc, sd[u]), m0[u], mu[u], a.slope), di[u]);
            keep[u] = d.on ? keep_scale(d, id[u], head) : 1.f;
            if (e + u < end)
              mul_add(acc, d.on ? __fmul_rn(al[u], keep[u]) : al[u], v[u]);
          }
          if (kWide && c > 0) continue;
          float p[N];
#pragma unroll
          for (int u = 0; u < N; ++u) {
            p[u] = 0.f;
            dot_add(p[u], hv, v[u]);
          }
          if (kWide) later_chunks<T>(l, row, own, p);
          head_sums(l, p);
#pragma unroll
          for (int u = 0; u < N; ++u) {
            if (e + u < end) {
              const float pre = __fadd_rn(ssc, sd[u]);
              const float da = d.on ? __fmul_rn(p[u], keep[u]) : p[u];
              const float dsig = __fsub_rn(__fmul_rn(al[u], da),
                                           __fmul_rn(al[u], rdot[u]));
              ds = __fadd_rn(ds, __fmul_rn(dsig, slope_of(pre, a.slope)));
            }
          }
        }
        if (!on) continue;
        const long long j = (long long)head * F + q * kv;
        if (q_on)
          *reinterpret_cast<T*>(t.piece ? a.carry + unit * wc + j
                                        : a.out + (long long)r * W + j) = acc;
        if (c == 0 && l.i == 0) {
          if (t.piece)
            a.carry[unit * wc + W + head] = ds;
          else
            a.out2[(long long)r * H + head] = ds;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(32) attn_bwd_cols_parts(const AttnArgs a) {
  carry_parts(a, carry_stride(a.heads * a.feats + a.heads));
}

// Split row s, a warp: its parts in order, lanes over the float4s of the
// carry row, dh into out and ds_src into out2.
__global__ void __launch_bounds__(32) attn_bwd_cols_fixup(const AttnArgs a) {
  int lane;
  const long long s = group_item(32, a.n_split, lane);
  if (s < 0) return;
  const int H = a.heads, W = a.heads * a.feats, fv = carry_stride(W + H) / 4;
  const int row = a.split[3 * s];
  const int n = min(a.parts, a.split[3 * s + 2]);
  const float4* ps = reinterpret_cast<const float4*>(a.carry) +
                     ((long long)a.n_units + s * a.parts) * fv;
  for (int j = lane; j < fv; j += 32) {
    const float4 v4 = edge_walk::ordered_sum(ps + j, fv, n);
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * j + k;
      if (c < W)
        a.out[(long long)row * W + c] = v[k];
      else if (c < W + H)
        a.out2[(long long)row * H + c - W] = v[k];
    }
  }
}

// ---- launches ------------------------------------------------------------

typedef void (*Kernel)(AttnArgs);

int launch(Kernel k, long long items, int group, int threads,
           const AttnArgs& a, cudaStream_t s) {
  if (items <= 0) return 0;
  k<<<group_blocks(items, group, threads), threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// A per-feature walk, then (where a row is split) its parts and fix-up.
int walk_and_fix(Kernel walk, Kernel parts, Kernel fixup, int group,
                 const AttnArgs& a, cudaStream_t s) {
  int rc = launch(walk, a.n_units, group, kThreads, a, s);
  if (rc || a.n_split == 0) return rc;
  if (a.parts < 1) return (int)cudaErrorInvalidValue;
  rc = launch(parts, a.n_part_items, group, 32, a, s);
  if (rc) return rc;
  return launch(fixup, a.n_split, group, 32, a, s);
}

bool valid(const AttnArgs* a) {
  return a && a->heads > 0 && a->feats > 0 && a->group > 0 &&
         a->group <= 32 && a->sgroup > 0 && a->sgroup <= 32 &&
         (a->vec == 1 || a->vec == 4) && a->feats % a->vec == 0 &&
         a->ld % a->vec == 0 && a->ldc % a->vec == 0;
}

// A3's and A4's lanes: whole heads of min(nq, 32) lanes a unit.
bool head_lanes_valid(const AttnArgs* a) {
  if (!valid(a)) return false;
  const int ne = min(a->feats / a->vec, 32);
  return a->group % ne == 0 && a->group / ne <= a->heads;
}

// A backward walk, then (where a row is split) its parts and fix-up, a
// warp an item.
int backward(Kernel walk, Kernel parts, Kernel fixup, const AttnArgs& a,
             cudaStream_t s) {
  int rc = launch(walk, a.n_units, a.group, kThreads, a, s);
  if (rc || a.n_split == 0) return rc;
  if (a.parts < 1) return (int)cudaErrorInvalidValue;
  rc = launch(parts, a.n_part_items, 32, 32, a, s);
  if (rc) return rc;
  return launch(fixup, a.n_split, 32, 32, a, s);
}

}  // namespace

// A1: rmax0 into out, dinv into out2 (both (N, H) float32, every row
// written); carry holds (n_units + n_split * parts) * H floats.
extern "C" int gnntf_attn_stats(const attention::AttnArgs* a,
                                void* stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = launch(attn_stats_walk, a->n_units, a->sgroup, kThreads, *a, s);
  if (rc || a->n_split == 0) return rc;
  if (a->parts < 1) return (int)cudaErrorInvalidValue;
  rc = launch(attn_stats_part_max, a->n_part_items, a->sgroup, 32, *a, s);
  if (!rc) rc = launch(attn_stats_rowmax, a->n_split, a->sgroup, 32, *a, s);
  if (!rc) rc = launch(attn_stats_pieces, a->n_units, a->sgroup, kThreads,
                       *a, s);
  if (!rc) rc = launch(attn_stats_parts, a->n_part_items, a->sgroup, 32, *a,
                       s);
  if (!rc) rc = launch(attn_stats_fixup, a->n_split, a->sgroup, 32, *a, s);
  return rc;
}

// A2: out (N, W) float32, every row written; carry holds (n_units +
// n_split * parts) * W floats; vec 4 where F % 4 == 0 (ops/attention.py::
// feature_lanes), the tables' rows then 16-byte aligned.
extern "C" int gnntf_attn_aggregate(const attention::AttnArgs* a,
                                    void* stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->vec == 4)
    return walk_and_fix(attn_aggregate_walk<float4>,
                        attn_aggregate_parts<float4>,
                        attn_aggregate_fixup<float4>, a->group, *a, s);
  return walk_and_fix(attn_aggregate_walk<float>, attn_aggregate_parts<float>,
                      attn_aggregate_fixup<float>, a->group, *a, s);
}

// A3: rowdot into out, ds_dst into out2 ((N, H) float32), ds_dst with the
// given rowdot where a->rowdot is set; carry holds
// (n_units + n_split * parts) rows of carry_stride(3H) floats; group and
// vec as head_lanes reads them.  At most three launches.
extern "C" int gnntf_attn_bwd_rows(const attention::AttnArgs* a,
                                   void* stream) {
  if (!head_lanes_valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = a->feats / a->vec > 32;
  Kernel walk = a->vec == 4 ? (wide ? attn_bwd_rows_walk<float4, true>
                                    : attn_bwd_rows_walk<float4, false>)
                            : (wide ? attn_bwd_rows_walk<float, true>
                                    : attn_bwd_rows_walk<float, false>);
  return backward(walk, attn_bwd_rows_parts, attn_bwd_rows_fixup, *a, s);
}

// A4: dh into out ((N, W) float32), ds_src into out2 ((N, H)); carry holds
// (n_units + n_split * parts) rows of carry_stride(W + H) floats.  At most
// three launches.
extern "C" int gnntf_attn_bwd_cols(const attention::AttnArgs* a,
                                   void* stream) {
  if (!head_lanes_valid(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = a->feats / a->vec > 32;
  Kernel walk = a->vec == 4 ? (wide ? attn_bwd_cols_walk<float4, true>
                                    : attn_bwd_cols_walk<float4, false>)
                            : (wide ? attn_bwd_cols_walk<float, true>
                                    : attn_bwd_cols_walk<float, false>);
  return backward(walk, attn_bwd_cols_parts, attn_bwd_cols_fixup, *a, s);
}

extern "C" const char* gnntf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
