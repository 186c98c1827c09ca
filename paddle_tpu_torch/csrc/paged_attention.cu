// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_paged.py:_paged_kernel.
// One decode query row per slot, keys and values gathered page by page
// through the slot's page-table row:
//
//   out[s] = softmax(scale * q[s] . K[s]^T + bias[s]) . V[s]
//   K[s][l] = cache_k[page_table[s][l / ps]][l % ps]   (same for V)
//
// Row n_rows - 1 of the caches is the trash page; the bias holds an exact
// -inf past each slot's live length, so exp(-inf - m) = 0 exactly and trash
// or stale pages contribute nothing.
//
// What bounds it: bytes.  Every live (slot, key) pair reads one K row and one
// V row of d floats and does 4*d flops on them, 0.5 flop per byte, far below
// the card's ~20 fp32 flops per byte of bandwidth.  At the decode path's
// shapes (8 slots, 512 positions, d = 512) the live rows are a few MB, about
// a microsecond of bandwidth: what sets the time is how many bytes are in
// flight at once, and then the launches' own latency.
//
// Design: each slot's row is split over many blocks, so that 8 slots fill
// the card's 132 SMs, in two launches a call (both from
// pta_paged_attention_f32):
//   A. scores, grid (ceil(L / 32), slots): a block per 32 key positions
//      (two pages of 16), a warp per 4 of them.  A lane issues its loads of
//      all 4 keys' rows before it sums; the warp's shuffles then reduce
//      each.  scale * q . K + bias goes to a scratch row scores[s, L] in
//      device memory.  A key whose bias is -inf is not read: its score is
//      the bias, as q . K + -inf is.
//   B. softmax and p . V, grid (ceil(d / 32), slots): a block per 32
//      columns of the output.  Each block reduces its slot's whole score row
//      (L floats, L2-resident) to the max and then the sum of exp(x - max)
//      in one fixed order, the same in every block of the slot: the EXACT
//      full-row softmax the reference runs (max, exp(x - max), divide by the
//      sum), not the online recurrence of flash attention.  Then p . V over
//      its columns: 32 groups of 8 threads, group j the key positions l = j
//      (mod 32) in increasing order, a thread one float4 of columns, 8 keys'
//      loads in flight before their FMAs; a V row whose p is 0 is not read.
//      The groups' partials are summed in group order.
// The partition is fixed in key positions and columns, never derived from
// the number of pages or of slots, every sum has a fixed order, and there
// are no atomics.  So a slot's output depends on its own row alone and
// repeats bitwise, and a page table cut to the pages a slot uses gives the
// same bits as a longer one whose extra positions have -inf bias (they add
// exact zeros at the ends of the sums): continuous batching equals
// per-request decode on the card.
//
// Page ids are clamped into [0, n_rows) so a bad page table cannot read out
// of bounds.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                     // key positions a score block
constexpr int kKeysPerWarp = kChunk / kWarps;  // 4
constexpr int kCols4 = 8;                      // float4 columns a p.V block
constexpr int kGroups = kThreads / kCols4;     // key groups of a p.V block
constexpr int kBatch = 8;                      // V rows a thread loads at once

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions in a fixed order: warp shuffles, then warp 0 over the
// per-warp partials.  Every thread gets the result.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? red[lane] : -INFINITY;
    t = warp_max(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

__device__ __forceinline__ const float4* cache_row(const float* cache,
                                                   const long long* pt, int l,
                                                   int ps, int d,
                                                   int n_rows) {
  const long long id = pt[l / ps];
  const long long page = id < 0 ? 0 : (id >= n_rows ? n_rows - 1 : id);
  return reinterpret_cast<const float4*>(
      cache + ((size_t)page * ps + (l % ps)) * d);
}

// A: scores[s, l] = scale * q[s] . K[s][l] + bias[s, l] for the block's 32
// key positions.
__global__ void __launch_bounds__(kThreads)
paged_scores_kernel(const float* __restrict__ q,
                    const float* __restrict__ cache_k,
                    const long long* __restrict__ page_table,
                    const float* __restrict__ bias,
                    float* __restrict__ scores, int d, int n_pages, int ps,
                    int n_rows, float scale, int apply_scale) {
  extern __shared__ __align__(16) float qs[];  // [d] the scaled query row
  const int s = blockIdx.y;
  const int ell = n_pages * ps, d4 = d >> 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long* pt = page_table + (size_t)s * n_pages;
  const float* b = bias + (size_t)s * ell;

  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = q[(size_t)s * d + i];
    qs[i] = apply_scale ? v * scale : v;
  }
  __syncthreads();

  const int l0 = blockIdx.x * kChunk + kKeysPerWarp * warp;
  const float4* rows[kKeysPerWarp];
  float bk[kKeysPerWarp], acc[kKeysPerWarp];
  bool live[kKeysPerWarp];
#pragma unroll
  for (int u = 0; u < kKeysPerWarp; ++u) {
    const int l = l0 + u;
    bk[u] = l < ell ? b[l] : -INFINITY;
    live[u] = l < ell && bk[u] != -INFINITY;
    rows[u] = live[u] ? cache_row(cache_k, pt, l, ps, d, n_rows) : nullptr;
    acc[u] = 0.f;
  }
  const float4* q4 = reinterpret_cast<const float4*>(qs);
#pragma unroll 4
  for (int i = lane; i < d4; i += 32) {
    float4 kv[kKeysPerWarp];
#pragma unroll
    for (int u = 0; u < kKeysPerWarp; ++u)
      kv[u] = live[u] ? __ldg(rows[u] + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 qv = q4[i];
#pragma unroll
    for (int u = 0; u < kKeysPerWarp; ++u) {
      acc[u] = fmaf(qv.x, kv[u].x, acc[u]);
      acc[u] = fmaf(qv.y, kv[u].y, acc[u]);
      acc[u] = fmaf(qv.z, kv[u].z, acc[u]);
      acc[u] = fmaf(qv.w, kv[u].w, acc[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kKeysPerWarp; ++u) {
    acc[u] = warp_sum(acc[u]);
    const int l = l0 + u;
    if (lane == 0 && l < ell)
      scores[(size_t)s * ell + l] = live[u] ? acc[u] + bk[u] : bk[u];
  }
}

// B: out[s, cols] = softmax(scores[s]) . V[s][:, cols] for the block's 32
// columns.
__global__ void __launch_bounds__(kThreads)
paged_pv_kernel(const float* __restrict__ cache_v,
                const long long* __restrict__ page_table,
                const float* __restrict__ scores, float* __restrict__ out,
                int d, int n_pages, int ps, int n_rows) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  const int s = blockIdx.y;
  const int ell = n_pages * ps, d4 = d >> 2;
  const int tid = threadIdx.x;
  float* p = smem;                          // [ell] probabilities
  float* part = p + ((ell + 3) & ~3);       // [kGroups, 4 kCols4] partials
  const float* sc = scores + (size_t)s * ell;
  const long long* pt = page_table + (size_t)s * n_pages;

  // 1. the exact softmax over the slot's whole row
  float m = -INFINITY;
  for (int l = tid; l < ell; l += kThreads) m = fmaxf(m, sc[l]);
  m = block_max(m, red);
  float sum = 0.f;
  for (int l = tid; l < ell; l += kThreads) {
    const float e = expf(sc[l] - m);
    p[l] = e;
    sum += e;
  }
  sum = block_sum(sum, red);  // ends in a barrier: every e is visible
  for (int l = tid; l < ell; l += kThreads) p[l] = p[l] / sum;
  __syncthreads();

  // 2. p . V: group grp takes positions grp, grp + kGroups, ... in order
  const int grp = tid / kCols4, c = blockIdx.x * kCols4 + tid % kCols4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < d4) {
    for (int l = grp; l < ell; l += kBatch * kGroups) {
      float pl[kBatch];
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int lu = l + u * kGroups;
        pl[u] = lu < ell ? p[lu] : 0.f;
        v[u] = pl[u] != 0.f
                   ? __ldg(cache_row(cache_v, pt, lu, ps, d, n_rows) + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        acc.x = fmaf(pl[u], v[u].x, acc.x);
        acc.y = fmaf(pl[u], v[u].y, acc.y);
        acc.z = fmaf(pl[u], v[u].z, acc.z);
        acc.w = fmaf(pl[u], v[u].w, acc.w);
      }
    }
  }
  reinterpret_cast<float4*>(part)[tid] = acc;  // [grp][tid % kCols4]
  __syncthreads();

  // 3. the groups' partials, in group order
  if (tid < 4 * kCols4) {
    const int col = 4 * blockIdx.x * kCols4 + tid;
    if (col < d) {
      float o = 0.f;
      for (int j = 0; j < kGroups; ++j) o += part[j * 4 * kCols4 + tid];
      out[(size_t)s * d + col] = o;
    }
  }
}

size_t scores_smem(int d) { return (size_t)d * sizeof(float); }

size_t pv_smem(int n_pages, int ps) {
  const size_t ell_pad = ((size_t)n_pages * ps + 3) & ~(size_t)3;
  return (ell_pad + (size_t)kGroups * 4 * kCols4) * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

// Shared memory the larger of the two launches needs, in bytes (the wrapper
// names it when a launch fails).
long long pta_paged_attention_smem(int d, int n_pages, int ps) {
  const size_t a = scores_smem(d), b = pv_smem(n_pages, ps);
  return (long long)(a > b ? a : b);
}

// Launches A then B on `stream` and returns cudaGetLastError() (0 =
// launched).  All pointers are device pointers; q, out [s_n, d]; caches
// [n_rows, ps, d]; page_table [s_n, n_pages] int64; bias [s_n, n_pages *
// ps]; scores, scratch of scores_numel >= s_n * n_pages * ps floats.
// d % 4 == 0 and every float pointer 16-byte aligned.
int pta_paged_attention_f32(const void* q, const void* cache_k,
                            const void* cache_v, const void* page_table,
                            const void* bias, void* scores,
                            long long scores_numel, void* out, int s_n,
                            int d, int n_pages, int ps, int n_rows,
                            float scale, void* stream) {
  if (s_n == 0) return 0;
  const long long ell = (long long)n_pages * ps;
  if (d % 4 != 0 || ell < 1 || scores_numel < s_n * ell)
    return (int)cudaErrorInvalidValue;
  const size_t smem_a = scores_smem(d), smem_b = pv_smem(n_pages, ps);
  cudaError_t e = allow_smem(paged_scores_kernel, smem_a);
  if (e == cudaSuccess) e = allow_smem(paged_pv_kernel, smem_b);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* pt = static_cast<const long long*>(page_table);
  const dim3 grid_a((unsigned)((ell + kChunk - 1) / kChunk), (unsigned)s_n);
  paged_scores_kernel<<<grid_a, kThreads, smem_a, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(cache_k), pt,
      static_cast<const float*>(bias), static_cast<float*>(scores), d,
      n_pages, ps, n_rows, scale, scale != 1.0f ? 1 : 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_b((unsigned)((d / 4 + kCols4 - 1) / kCols4), (unsigned)s_n);
  paged_pv_kernel<<<grid_b, kThreads, smem_b, st>>>(
      static_cast<const float*>(cache_v), pt,
      static_cast<const float*>(scores), static_cast<float*>(out), d, n_pages,
      ps, n_rows);
  return (int)cudaGetLastError();
}

const char* pta_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
