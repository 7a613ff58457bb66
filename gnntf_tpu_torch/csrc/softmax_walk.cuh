// A1 and A2 as one walk over the row list: attn_softmax_aggregate_walk,
// then, where a row is split, attn_softmax_aggregate_merge.  Included by
// attention.cu after its helpers (AttnArgs, Drop, weight, ...), inside its
// anonymous namespace.
//
// Per row r of the list and head h, with sg = leaky(s_src[src] +
// s_dst[r]) over the row's slots:
//
//     rmax0 = max sg (0 where none or not finite),
//     dinv = 1 / max(sum w, 1e-30),  w = mult * exp(sg - rmax0),
//     out[r, h, :] = sum (w * dinv) * scale(eid, h) * h[src, h, :],
//
// what attn_stats_walk then attn_aggregate_walk compute, in one launch.
//
// Work.  A group of lanes takes a task (ops/attention.py::softmax_plan):
// a run of up to kRunPieces consecutive pieces of one split row (the runs
// come first, so the long tasks start first), or a run of consecutive
// whole rows of at most 32 slots and kTaskRows rows.  The group is A2's,
// min(32, W / vec) lanes (vec 4 where F % 4 == 0), so a warp holds several
// tasks at narrow rows; its lanes are whole heads of lanes (lane l: head
// l % H).  A pass over a task's slots (n <= 32), through the group's
// shared memory:
//
// * the slots' sources, ids (the dropout's first hash of each) and
//   multiplicities, loaded once, kPairLoads a lane in flight;
// * the (slot, head) pairs, lane l taking slots l / H, l / H + group / H,
//   ... of head l % H: each pair's score gathered once (kPairLoads a lane
//   in flight, with the first kSoftmaxLoads feature rows already in
//   flight); lanes over the (row, head) pairs take each one's maximum;
//   each pair's weight w is made once (one expf); each (row, head)'s sum in
//   slot order (A1's order) gives dinv; each pair's coefficient w * dinv *
//   scale is made once;
// * lanes over the row's W / vec feature vectors (in chunks of 32 where
//   W / vec > 32) add the terms in slot order (A2's order), each term's
//   coefficient read from shared memory, and write each row at its end.
//
// So a whole row's rmax0, dinv and out are those of A1 and A2, bit for bit.
// A piece keeps its own maximum m (0 where not finite), sum s under it and
// sum acc of w * scale * h (no dinv), and the group folds each piece of
// its run into the run's (m, s, acc) in piece order:
//
//     M = max(m1, m2),  e_i = exp(m_i - M),
//     s = s1 * e1 + s2 * e2,  acc = acc1 * e1 + acc2 * e2   (per head),
//
// then writes the run's record to carry.  attn_softmax_aggregate_merge (a
// block a split row, kMergeWarps warps) folds the row's runs the same way
// (each head's e1, e2 made once, in lane h, and shuffled to the columns):
// warp g runs g, g + kMergeWarps, ... in turn, then warp 0 the warps'
// folds in order; rmax0 = M, dinv = 1 / max(s, 1e-30), out = acc * dinv.
// Every fold runs in a fixed order, with no atomics: two launches give the
// same bits, and ops/attention.py::attn_softmax_aggregate_plain repeats
// it.  Lists cut into units of more than 32 items (whose whole rows may
// hold more than 32 slots) have no plan, and the host refuses them
// (ops/attention.py::softmax_plan).
//
// Constants: runs of 8 pieces (16 left a chain of pieces as the walk's
// tail; 4 gave the merge 4x the records of the bench graph's hub); 4
// feature gathers and 4 slot and pair loads a lane in flight and 3
// resident blocks an SM won the sum over GAT's four bench cells on an
// H100 against 2 or 8 gathers, 2 loads, 2 or 4 blocks, and a task a warp
// (PERF.md §6).
#pragma once

// pieces a group folds in a run, the most rows of a task of whole rows
// (which holds at most 32 slots), and the warps of a split row's merge
constexpr int kRunPieces = 8;
constexpr int kTaskRows = 16;
constexpr int kMergeWarps = 32;
// columns of 32 a lane of the merge takes, and the records whose loads it
// keeps in flight
constexpr int kMergeCols = 4;
constexpr int kMergeLoads = 8;
// feature gathers a lane keeps in flight, the least resident blocks of the
// walk an SM, and the slots' and pairs' loads a lane issues before it uses
// them
constexpr int kSoftmaxLoads = 4;
constexpr int kSoftmaxMinBlocks = 3;
constexpr int kPairLoads = 4;

// The fold of (m2, v2) into (m1, v1): v1 * exp(m1 - M) + v2 * exp(m2 - M)
// under M = max(m1, m2).
__device__ __forceinline__ void fold(float& m1, float& v1, float m2,
                                     float v2) {
  const float M = m2 > m1 ? m2 : m1;
  v1 = __fadd_rn(__fmul_rn(v1, expf(__fsub_rn(m1, M))),
                 __fmul_rn(v2, expf(__fsub_rn(m2, M))));
  m1 = M;
}
// The same for a lane's feature vector of a head, under that head's m1, m2.
__device__ __forceinline__ void fold_terms(float4& v1, float m1, float m2,
                                           float4 v2) {
  const float M = m2 > m1 ? m2 : m1;
  const float e1 = expf(__fsub_rn(m1, M)), e2 = expf(__fsub_rn(m2, M));
  v1.x = __fadd_rn(__fmul_rn(v1.x, e1), __fmul_rn(v2.x, e2));
  v1.y = __fadd_rn(__fmul_rn(v1.y, e1), __fmul_rn(v2.y, e2));
  v1.z = __fadd_rn(__fmul_rn(v1.z, e1), __fmul_rn(v2.z, e2));
  v1.w = __fadd_rn(__fmul_rn(v1.w, e1), __fmul_rn(v2.w, e2));
}
__device__ __forceinline__ void fold_terms(float& v1, float m1, float m2,
                                           float v2) {
  fold(m1, v1, m2, v2);
}

// A group's shared memory: a task's slots (source, id, multiplicity, row
// in the task), its rows' first slots (rptr, kTaskRows + 1 of 32), its
// (slot, head) pairs (32 * H floats) and a value a (row, head) (kTaskRows *
// H floats).
struct GroupSmem {
  int* src;
  uint32_t* id;
  float* mu;
  int* seg;
  int* rptr;
  float* pairs;
  float* rh;
};

__host__ __device__ __forceinline__ int group_smem_floats(int heads) {
  return 5 * 32 + 32 * heads + kTaskRows * heads;
}

// A task's group of lanes: `group` lanes (A2's, min(32, W / vec)), lane
// `lane` of them, their first lane and mask in the warp.
struct Group {
  int group, lane, lane0;
  unsigned mask;
};

// A piece's results in a lane: its head's maximum m0 and sum s (lanes
// below H, head `lane`), its feature vectors' sums acc.
template <typename T, bool kWide>
struct Piece {
  static constexpr int kChunks = kWide ? 4 : 1;
  float m0, s;
  T acc[kChunks];
};

// One task: nr rows from row r0 (whole rows: rmax0, dinv and out written)
// or one piece of row r0 (nr 1; its maximum, sum and terms returned), its
// slots [b, b + n) (n <= 32), rptr[0..nr] in the group's memory.
template <typename T, bool kWide>
__device__ __forceinline__ Piece<T, kWide> task_pass(const AttnArgs& a,
                                                     const Drop& d,
                                                     const GroupSmem& m,
                                                     const Group& g, int r0,
                                                     int nr, int b, int n,
                                                     bool whole) {
  constexpr int kv = sizeof(T) / sizeof(float);
  constexpr int L = kSoftmaxLoads;
  constexpr int kChunks = Piece<T, kWide>::kChunks;
  const int H = a.heads, F = a.feats, W = H * F, fv = W / kv;
  // the group's lanes are whole heads of lanes: lane l takes head l % H,
  // and slots (or rows) l / H, l / H + S, ...
  const int h = g.lane % H, k0 = g.lane / H, S = g.group / H;
  Piece<T, kWide> out;
  out.m0 = out.s = 0.f;

  // the slots, kPairLoads a lane at a time; a slot keeps its id's hash
  // (the dropout's first fmix32) where a draw is given
  for (int l0 = 0; l0 < n; l0 += kPairLoads * g.group) {
    int sv[kPairLoads];
    uint32_t iv[kPairLoads];
#pragma unroll
    for (int u = 0; u < kPairLoads; ++u) {
      const int l = l0 + u * g.group + g.lane;
      if (l < n) {
        sv[u] = a.idx[b + l];
        iv[u] = a.eid ? (uint32_t)a.eid[b + l] : (uint32_t)(b + l);
      }
    }
#pragma unroll
    for (int u = 0; u < kPairLoads; ++u) {
      const int l = l0 + u * g.group + g.lane;
      if (l < n) {
        m.src[l] = sv[u];
        m.id[l] = d.on ? edge_walk::fmix32(iv[u] ^ d.s0) : iv[u];
        m.mu[l] = a.mult ? a.mult[iv[u]] : 1.f;
      }
    }
  }
  for (int i = g.lane; i < nr; i += g.group)
    for (int k = m.rptr[i]; k < m.rptr[i + 1]; ++k) m.seg[k] = i;
  __syncwarp(g.mask);
  // the first batch of chunk 0's feature rows, in flight from here (every
  // lane holds one: the group is at most W / vec lanes)
  T v[L];
#pragma unroll
  for (int u = 0; u < L; ++u) {
    set_zero(v[u]);
    if (u < n)
      v[u] = load<T>(a.tab + (long long)m.src[u] * a.ld + g.lane * kv);
  }

  // each pair's score, gathered once, kPairLoads a lane at a time
  for (int k1 = k0; k1 < n; k1 += kPairLoads * S) {
    float ss[kPairLoads], sd[kPairLoads];
#pragma unroll
    for (int u = 0; u < kPairLoads; ++u) {
      const int k = k1 + u * S;
      if (k < n) {
        ss[u] = a.tab[(long long)m.src[k] * a.ld + W + h];
        sd[u] = a.s_dst[(long long)(r0 + m.seg[k]) * H + h];
      }
    }
#pragma unroll
    for (int u = 0; u < kPairLoads; ++u) {
      const int k = k1 + u * S;
      if (k < n) m.pairs[k * H + h] = __fadd_rn(ss[u], sd[u]);
    }
  }
  __syncwarp(g.mask);
  // each (row, head)'s maximum
  for (int i = k0; i < nr; i += S) {
    float mx = neg_inf();
    for (int k = m.rptr[i]; k < m.rptr[i + 1]; ++k) {
      const float sg = leaky(m.pairs[k * H + h], a.slope);
      if (sg > mx) mx = sg;
    }
    const float m0 = isfinite(mx) ? mx : 0.f;
    m.rh[i * H + h] = m0;
    if (whole) a.out3[(long long)(r0 + i) * H + h] = m0;
    out.m0 = m0;
  }
  __syncwarp(g.mask);
  // each pair's weight, once
  for (int k = k0; k < n; k += S)
    m.pairs[k * H + h] =
        weight(m.pairs[k * H + h], m.rh[m.seg[k] * H + h], m.mu[k], a.slope);
  __syncwarp(g.mask);
  // each (row, head)'s sum in slot order, and dinv
  for (int i = k0; i < nr; i += S) {
    float s = 0.f;
    for (int k = m.rptr[i]; k < m.rptr[i + 1]; ++k)
      s = __fadd_rn(s, m.pairs[k * H + h]);
    const float di = __fdiv_rn(1.f, fmaxf(s, 1e-30f));
    m.rh[i * H + h] = di;
    if (whole) a.out2[(long long)(r0 + i) * H + h] = di;
    out.s = s;
  }
  __syncwarp(g.mask);
  // each pair's coefficient, once
  for (int k = k0; k < n; k += S) {
    float al = m.pairs[k * H + h];
    if (whole) al = __fmul_rn(al, m.rh[m.seg[k] * H + h]);
    if (d.on) al = __fmul_rn(al, keep_scale_of(d, m.id[k], h));
    m.pairs[k * H + h] = al;
  }
  __syncwarp(g.mask);

  // the terms in slot order, A2's lanes; whole rows written at their ends
  T* dst = reinterpret_cast<T*>(a.out);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    set_zero(out.acc[c]);
    if (c * 32 >= fv) continue;
    const int jv = c * 32 + g.lane;
    const bool on = jv < fv;
    const int head = on ? jv * kv / F : 0;
    int i = 0;
    for (int k = 0; k < n; k += L) {
      if (c > 0 || k > 0) {
#pragma unroll
        for (int u = 0; u < L; ++u)
          if (on && k + u < n)
            v[u] = load<T>(a.tab + (long long)m.src[k + u] * a.ld + jv * kv);
      }
#pragma unroll
      for (int u = 0; u < L; ++u) {
        if (k + u < n) {
          while (whole && k + u >= m.rptr[i + 1]) {  // rows ending here
            if (on) dst[(long long)(r0 + i) * fv + jv] = out.acc[c];
            set_zero(out.acc[c]);
            ++i;
          }
          if (on) mul_add(out.acc[c], m.pairs[(k + u) * H + head], v[u]);
        }
      }
    }
    for (; whole && i < nr; ++i) {  // the last row, then rows without slots
      if (on) dst[(long long)(r0 + i) * fv + jv] = out.acc[c];
      set_zero(out.acc[c]);
    }
  }
  __syncwarp(g.mask);  // the next task or piece rewrites the group's memory
  return out;
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads, kSoftmaxMinBlocks)
    attn_softmax_aggregate_walk(const AttnArgs a) {
  constexpr int kv = sizeof(T) / sizeof(float);
  constexpr int kChunks = Piece<T, kWide>::kChunks;
  extern __shared__ float smem[];
  Group g;
  g.group = a.group;
  const long long task = group_item(a.group, a.n_tasks, g.lane);
  if (task < 0) return;
  g.lane0 = (threadIdx.x & 31) - g.lane;
  g.mask = a.group == 32 ? 0xffffffffu : ((1u << a.group) - 1u) << g.lane0;
  const int H = a.heads, F = a.feats, W = H * F, fv = W / kv;
  float* base = smem + (long long)((threadIdx.x >> 5) * (32 / a.group) +
                                   g.lane0 / a.group) *
                           group_smem_floats(H);
  const GroupSmem m{reinterpret_cast<int*>(base),
                    reinterpret_cast<uint32_t*>(base + 32),
                    base + 64,
                    reinterpret_cast<int*>(base + 96),
                    reinterpret_cast<int*>(base + 128),
                    base + 160,
                    base + 160 + 32 * H};
  const Drop d = load_drop(a);
  const int first = a.task[2 * task], count = a.task[2 * task + 1];

  if (task >= a.n_runs) {  // whole rows first .. first + count - 1
    const int b = a.ptr[first];
    for (int l = g.lane; l <= count; l += g.group)
      m.rptr[l] = a.ptr[first + l] - b;
    __syncwarp(g.mask);
    task_pass<T, kWide>(a, d, m, g, first, count, b, m.rptr[count], true);
    return;
  }

  // a run of pieces of one split row, folded in piece order
  const int row = ~a.unit_row[first];
  float rm = 0.f, rs = 0.f;
  T racc[kChunks];
  for (int p = 0; p < count; ++p) {
    const int b = a.unit_edge[first + p], e = a.unit_edge[first + p + 1];
    if (g.lane == 0) {
      m.rptr[0] = 0;
      m.rptr[1] = e - b;
    }
    __syncwarp(g.mask);
    const Piece<T, kWide> o =
        task_pass<T, kWide>(a, d, m, g, row, 1, b, e - b, false);
    if (p == 0) {
      rm = o.m0;
      rs = o.s;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) racc[c] = o.acc[c];
      continue;
    }
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int jv = c * 32 + g.lane;
      const int head = jv < fv ? jv * kv / F : 0;
      const float m1 = __shfl_sync(g.mask, rm, g.lane0 + head);
      const float m2 = __shfl_sync(g.mask, o.m0, g.lane0 + head);
      fold_terms(racc[c], m1, m2, o.acc[c]);
    }
    fold(rm, rs, o.m0, o.s);
  }
  float* rec = a.carry + task * (long long)carry_stride(W + 2 * H);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int jv = c * 32 + g.lane;
    if (jv < fv) reinterpret_cast<T*>(rec)[jv] = racc[c];
  }
  if (g.lane < H) {
    rec[W + g.lane] = rs;
    rec[W + H + g.lane] = rm;
  }
}

// Split row s, a block: its runs' records folded, warp g taking runs g, g +
// kMergeWarps, ... in turn (kMergeLoads records' loads in flight), then
// warp 0 the warps' folds in order.  Lane h < H folds head h's maximum and
// makes the head's two factors of a fold (one expf each), which the
// columns take by shuffle; a lane takes kMergeCols columns of 32 apart, a
// head's sum first (columns 0 .. H-1), then the features (H .. H+W-1).
__global__ void __launch_bounds__(kMergeWarps * 32)
    attn_softmax_aggregate_merge(const AttnArgs a) {
  constexpr int C = kMergeCols;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float part_m[kMergeWarps][32], part_v[kMergeWarps][32 * C];
  __shared__ float head_dinv[32];
  const int s = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = a.heads, F = a.feats, W = H * F;
  const int row = a.split[3 * s];
  const int first = a.split_runs[2 * s], runs = a.split_runs[2 * s + 1];
  const long long cs = carry_stride(W + 2 * H);
  const int parts = min(runs, kMergeWarps);
  const int mh_col = W + H + min(lane, H - 1);
  for (int c0 = 0; c0 < H + W; c0 += 32 * C) {
    bool on[C];
    int hd[C], col[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int c = c0 + 32 * j + lane;
      on[j] = c < H + W;
      hd[j] = !on[j] ? 0 : c < H ? c : (c - H) / F;
      col[j] = !on[j] ? 0 : c < H ? W + c : c - H;
    }
    // the fold of (mq, vq) into (m, v): the factors a head, then a column
    auto fold_in = [&](float& m, float (&v)[C], float mq, const float* vq) {
      const float M = mq > m ? mq : m;
      const float e1 = expf(__fsub_rn(m, M)), e2 = expf(__fsub_rn(mq, M));
      m = M;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float f1 = __shfl_sync(kAll, e1, hd[j]);
        const float f2 = __shfl_sync(kAll, e2, hd[j]);
        v[j] = __fadd_rn(__fmul_rn(v[j], f1), __fmul_rn(vq[j], f2));
      }
    };
    float m = 0.f, v[C];
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = 0.f;
    for (int q0 = warp; q0 < runs; q0 += kMergeWarps * kMergeLoads) {
      float mq[kMergeLoads], vq[kMergeLoads][C];
#pragma unroll
      for (int t = 0; t < kMergeLoads; ++t) {
        const float* rec =
            a.carry + (first + min(q0 + t * kMergeWarps, runs - 1)) * cs;
        mq[t] = rec[mh_col];
#pragma unroll
        for (int j = 0; j < C; ++j) vq[t][j] = on[j] ? rec[col[j]] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < kMergeLoads; ++t) {
        const int q = q0 + t * kMergeWarps;
        if (q >= runs) break;
        if (q == warp) {
          m = mq[t];
#pragma unroll
          for (int j = 0; j < C; ++j) v[j] = vq[t][j];
        } else {
          fold_in(m, v, mq[t], vq[t]);
        }
      }
    }
    part_m[warp][lane] = m;
#pragma unroll
    for (int j = 0; j < C; ++j) part_v[warp][32 * j + lane] = v[j];
    __syncthreads();
    if (warp == 0) {
      m = part_m[0][lane];
#pragma unroll
      for (int j = 0; j < C; ++j) v[j] = part_v[0][32 * j + lane];
      for (int g = 1; g < parts; ++g) {
        float vq[C];
#pragma unroll
        for (int j = 0; j < C; ++j) vq[j] = part_v[g][32 * j + lane];
        fold_in(m, v, part_m[g][lane], vq);
      }
      if (c0 == 0 && lane < H) {  // column lane: head lane's sum
        const float di = __fdiv_rn(1.f, fmaxf(v[0], 1e-30f));
        head_dinv[lane] = di;
        a.out3[(long long)row * H + lane] = m;
        a.out2[(long long)row * H + lane] = di;
      }
      __syncwarp();  // the heads' dinv, for the features
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int c = c0 + 32 * j + lane;
        if (on[j] && c >= H)
          a.out[(long long)row * W + col[j]] =
              __fmul_rn(v[j], head_dinv[hd[j]]);
      }
    }
    __syncthreads();
  }
}
