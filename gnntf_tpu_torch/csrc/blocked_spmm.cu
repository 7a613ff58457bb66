// K2: the blocked-COO SpMM.
//
// Replaces the TPU kernel gnntf_tpu/ops/pallas/spmm.py::_kernel (driven by
// _spmm_blocked and spmm_pallas).  Over the live slots s of every chunk c of
// a BlockedCOO layout (gnntf_tpu_torch/ops/blocked.py::block_coo):
//
//     out[w * W + rows[s]] += vals[s] * x[t * T + cols[s]],
//     w = chunk_window[c],  t = chunk_tile[c].
//
// The TPU kernel builds a (BE x T) one-hot gather and a (W x BE) one-hot
// scatter and multiplies them on its matrix unit, only because its compiler
// offers no gather from fast memory.  Here each edge is gathered directly.
// Live slots are a prefix of each chunk (chunk_len of them); padding slots
// are never read, and x is read in place, without the TPU's padded copy:
// source rows and window rows are bounds-checked instead.
//
// Bound.  Two flops per live edge and feature are far below the card's fp32
// rate, so memory bounds the kernel.  The compulsory bytes are the live
// slots (rows, cols, vals: 12 B each), x read once and out written once.  On
// the RCM-reordered bench graph at F = 40 (2,332,478 live slots, N =
// 169,343): 27,989,736 + 27,094,880 + 27,094,880 B = 82.2 MB, 24.5 us at
// 3.35 TB/s.  Reading every slot of the layout (15.6 M) instead would move
// 241 MB.
//
// Design.  Work is balanced by live edges, not by window or chunk: in the RCM
// layout one window holds 27% of the edges and the median chunk holds one
// live edge.  The host lists the live slots window by window, sorted by
// destination row inside a window (`live_slots`), cuts that list into runs
// of `run` live edges, and cuts each run where the window changes into
// segments (`seg_begin`, `seg_window`; run r owns segments run_seg[r] ..
// run_seg[r+1]).  Block (r, y) takes run r for the y-th tile of `ftv`
// feature columns.  Each segment is split into one contiguous range per
// group of `group` lanes, whatever chunks it spans.  A group walks its range
// four edges at a time, so that their gathers are in flight together, and
// sums consecutive edges of one destination row in registers; when the row
// changes it adds the sum into a W x tile float32 window in shared memory
// (40 KB at W = 256, F = 40; 128 KB at F = 128, through the dynamic
// shared-memory opt-in) and marks the row in a bitmask.  Rows of the heavy
// window own thousands of edges each, so without the register sums every
// group of a block would add into the same row at once.  At the end of the
// segment the block adds the touched rows into the zero-filled out with
// global atomicAdd and clears them.  A row whose edges span groups or runs
// (the heaviest window spans about 300 runs) is summed with atomics in an
// order that varies from launch to launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void set_zero(float& a) { a = 0.f; }
__device__ __forceinline__ void set_zero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void fma_into(float& acc, float w, float v) {
  acc = fmaf(w, v, acc);
}
__device__ __forceinline__ void fma_into(float4& acc, float w, float4 v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

__device__ __forceinline__ void window_add(float* w, float a) {
  atomicAdd(w, a);
}
__device__ __forceinline__ void window_add(float* w, float4 a) {
  atomicAdd(w + 0, a.x);
  atomicAdd(w + 1, a.y);
  atomicAdd(w + 2, a.z);
  atomicAdd(w + 3, a.w);
}

// Every thread of the block calls this: adds the touched rows of the shared
// window into out (rows window * W + r, columns col0 .. col0 + wf) and clears
// the window and the bitmask.
__device__ void flush(float* win, unsigned* touched, int n_words, int W,
                      int wf, long long window, float* out, int n_nodes,
                      int F, int col0) {
  __syncthreads();
  const long long row0 = window * W;
  for (int i = threadIdx.x; i < W * wf; i += blockDim.x) {
    const int r = i / wf;
    if (touched[r >> 5] & (1u << (r & 31))) {
      const long long g = row0 + r;
      if (g < n_nodes) atomicAdd(out + g * F + col0 + (i - r * wf), win[i]);
      win[i] = 0.f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) touched[i] = 0u;
  __syncthreads();
}

// Edges a group gathers at a time.
constexpr int kUnroll = 4;

// T is float or float4; fv = F / (floats in T), ftv = feature-tile width in
// units of T.  Shared memory: W * ftv * (floats in T) floats, then the
// ceil(W / 32)-word bitmask of touched window rows.
template <typename T>
__global__ void __launch_bounds__(kThreads) blocked_spmm_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
    const float* __restrict__ vals, const int32_t* __restrict__ chunk_tile,
    const int32_t* __restrict__ live_slots,
    const int32_t* __restrict__ seg_begin,
    const int32_t* __restrict__ seg_window,
    const int32_t* __restrict__ run_seg, const T* __restrict__ x,
    float* __restrict__ out, int n_nodes, int W, int tile, int BE, int fv,
    int ftv, int group) {
  constexpr int VEC = sizeof(T) / sizeof(float);
  extern __shared__ float smem[];
  const int f0 = blockIdx.y * ftv;
  const int width = min(ftv, fv - f0);
  const int wf = width * VEC;
  float* win = smem;
  unsigned* touched = reinterpret_cast<unsigned*>(smem + (size_t)W * ftv * VEC);
  const int n_words = (W + 31) / 32;
  for (int i = threadIdx.x; i < W * wf; i += blockDim.x) win[i] = 0.f;
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) touched[i] = 0u;
  __syncthreads();

  const int lane = threadIdx.x % group;
  const int gid = threadIdx.x / group;
  const int n_groups = blockDim.x / group;
  // uniform across the block: every thread walks the same segments
  for (int seg = run_seg[blockIdx.x]; seg < run_seg[blockIdx.x + 1]; ++seg) {
    const int begin = seg_begin[seg], end = seg_begin[seg + 1];
    const int per = (end - begin + n_groups - 1) / n_groups;
    const int lo = begin + gid * per;
    const int hi = min(end, lo + per);
    for (int j = lane; j < width; j += group) {
      T acc;
      set_zero(acc);
      int row = -1;
      for (int i0 = lo; i0 < hi; i0 += kUnroll) {
        int r[kUnroll];
        float v[kUnroll];
        const T* xr[kUnroll];
        T a[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u;
          xr[u] = nullptr;
          if (i < hi) {
            const int s = live_slots[i];
            const long long src =
                (long long)chunk_tile[s / BE] * tile + cols[s];
            r[u] = rows[s];
            v[u] = vals[s];
            if ((unsigned)r[u] < (unsigned)W && src >= 0 && src < n_nodes)
              xr[u] = x + src * fv + f0;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (xr[u]) a[u] = xr[u][j];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!xr[u]) continue;
          if (r[u] != row) {
            if (row >= 0) window_add(win + row * wf + j * VEC, acc);
            if (j == 0) atomicOr(&touched[r[u] >> 5], 1u << (r[u] & 31));
            set_zero(acc);
            row = r[u];
          }
          fma_into(acc, v[u], a[u]);
        }
      }
      if (row >= 0) window_add(win + row * wf + j * VEC, acc);
    }
    flush(win, touched, n_words, W, wf, seg_window[seg], out, n_nodes,
          fv * VEC, f0 * VEC);
  }
}

template <typename T>
int launch(const void* rows, const void* cols, const void* vals,
           const void* chunk_tile, const void* live_slots,
           const void* seg_begin, const void* seg_window, const void* run_seg,
           const void* x, void* out, int n_runs, int n_nodes, int W, int tile,
           int BE, int fv, int ftv, int group, cudaStream_t stream) {
  constexpr int VEC = sizeof(T) / sizeof(float);
  const size_t smem =
      (size_t)W * ftv * VEC * sizeof(float) + (size_t)((W + 31) / 32) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      blocked_spmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_runs, (unsigned)((fv + ftv - 1) / ftv));
  blocked_spmm_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const float*>(vals),
      static_cast<const int32_t*>(chunk_tile),
      static_cast<const int32_t*>(live_slots),
      static_cast<const int32_t*>(seg_begin),
      static_cast<const int32_t*>(seg_window),
      static_cast<const int32_t*>(run_seg), static_cast<const T*>(x),
      static_cast<float*>(out), n_nodes, W, tile, BE, fv, ftv, group);
  return (int)cudaGetLastError();
}

}  // namespace

// out (n_nodes, f) float32 must be zero-filled; vec is 4 (float4 loads of x;
// f % 4 == 0 and x 16-byte aligned) or 1.  ftv is the feature-tile width in
// units of vec floats, group the lanes per edge (a power of two <= 32).
// Launches on `stream` and returns a CUDA error code (0 on success).
extern "C" int gnntf_blocked_spmm(
    const void* rows, const void* cols, const void* vals,
    const void* chunk_tile, const void* live_slots, const void* seg_begin,
    const void* seg_window, const void* run_seg, const void* x, void* out,
    int n_runs, int n_nodes, int W, int tile, int BE, int f, int ftv, int vec,
    int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return launch<float4>(rows, cols, vals, chunk_tile, live_slots,
                          seg_begin, seg_window, run_seg, x, out, n_runs,
                          n_nodes, W, tile, BE, f / 4, ftv, group, s);
  return launch<float>(rows, cols, vals, chunk_tile, live_slots, seg_begin,
                       seg_window, run_seg, x, out, n_runs, n_nodes, W, tile,
                       BE, f, ftv, group, s);
}

extern "C" const char* gnntf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
