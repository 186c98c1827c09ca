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
// the card's ~20 fp32 flops per byte of bandwidth.
//
// Design, one block per slot:
//   1. q . K for every key position, one warp per position, the scores of the
//      whole row kept in shared memory (4 * n_pages * ps bytes).  The TPU
//      kernel also parks the gathered fp32 V in VMEM; at L = 512, d = 512
//      that is 1 MiB, far over the 227 KB a block may use, so V is instead
//      streamed in a second pass.
//   2. The EXACT full-row softmax the reference runs (max, exp(x - max),
//      divide by the sum), not the online recurrence of flash attention.
//   3. out = p . V: thread groups split the key positions, each thread owns
//      four columns, and the group partials are summed in a fixed order.
// Every reduction has an order fixed per slot and there are no atomics, so a
// slot's output depends on its own row alone and repeats bitwise: continuous
// batching equals per-request decode on the card.  With 8 slots only 8 of the
// card's 132 SMs work; splitting a slot across blocks is later work.
//
// Page ids are clamped into [0, n_rows) so a bad page table cannot read out
// of bounds.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 8;

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
                                                   const int* pt, int l,
                                                   int ps, int d,
                                                   int n_rows) {
  int page = pt[l / ps];
  page = min(max(page, 0), n_rows - 1);
  return reinterpret_cast<const float4*>(
      cache + ((size_t)page * ps + (l % ps)) * d);
}

__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ cache_k,
                       const float* __restrict__ cache_v,
                       const int* __restrict__ page_table,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int d, int n_pages, int ps,
                       int n_rows, float scale, int apply_scale, int groups) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  const int ell = n_pages * ps;
  const int d4 = d >> 2;
  float* qs = smem;              // [d]      the scaled query row
  float* sc = qs + d;            // [ell]    scores, then probabilities
  float* part = sc + ((ell + 3) & ~3);  // [groups, d] p . V partials, 16 B aligned
  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* pt = page_table + (size_t)s * n_pages;
  const float* b = bias + (size_t)s * ell;

  for (int i = tid; i < d; i += kThreads) {
    const float v = q[(size_t)s * d + i];
    qs[i] = apply_scale ? v * scale : v;
  }
  __syncthreads();

  // 1. scores: one warp per key position, float4 loads along d
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  for (int l = warp; l < ell; l += kWarps) {
    const float4* k4 = cache_row(cache_k, pt, l, ps, d, n_rows);
    float acc = 0.f;
    for (int i = lane; i < d4; i += 32) {
      const float4 kv = __ldg(k4 + i);
      const float4 qv = q4[i];
      acc = fmaf(qv.x, kv.x, acc);
      acc = fmaf(qv.y, kv.y, acc);
      acc = fmaf(qv.z, kv.z, acc);
      acc = fmaf(qv.w, kv.w, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) sc[l] = acc + b[l];
  }
  __syncthreads();

  // 2. exact softmax over the full row
  float m = -INFINITY;
  for (int l = tid; l < ell; l += kThreads) m = fmaxf(m, sc[l]);
  m = block_max(m, red);
  float sum = 0.f;
  for (int l = tid; l < ell; l += kThreads) {
    const float e = expf(sc[l] - m);
    sc[l] = e;
    sum += e;
  }
  sum = block_sum(sum, red);  // ends in a barrier: every e is visible
  for (int l = tid; l < ell; l += kThreads) sc[l] = sc[l] / sum;
  __syncthreads();

  // 3. out = p . V, key positions split over `groups` thread groups
  const int per = (ell + groups - 1) / groups;
  for (int idx = tid; idx < groups * d4; idx += kThreads) {
    const int g = idx / d4, c = idx % d4;
    const int l0 = g * per, l1 = min(ell, l0 + per);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int l = l0; l < l1; ++l) {
      const float4 v = __ldg(cache_row(cache_v, pt, l, ps, d, n_rows) + c);
      const float p = sc[l];
      acc.x = fmaf(p, v.x, acc.x);
      acc.y = fmaf(p, v.y, acc.y);
      acc.z = fmaf(p, v.z, acc.z);
      acc.w = fmaf(p, v.w, acc.w);
    }
    reinterpret_cast<float4*>(part + (size_t)g * d)[c] = acc;
  }
  __syncthreads();
  for (int i = tid; i < d; i += kThreads) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += part[(size_t)g * d + i];
    out[(size_t)s * d + i] = acc;
  }
}

}  // namespace

extern "C" {

// Shared memory the launch needs, in bytes (the wrapper checks it against
// the card's limit before launching).
long long pta_paged_attention_smem(int d, int n_pages, int ps) {
  int groups = kThreads / (d / 4);
  groups = groups < 1 ? 1 : (groups > kMaxGroups ? kMaxGroups : groups);
  const long long ell_pad = ((long long)n_pages * ps + 3) & ~3LL;
  return (d + ell_pad + (long long)groups * d) * (long long)sizeof(float);
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// All pointers are device pointers; q, out [s_n, d]; caches [n_rows, ps, d];
// page_table [s_n, n_pages] int32; bias [s_n, n_pages * ps].  d % 4 == 0 and
// every pointer 16-byte aligned.
int pta_paged_attention_f32(const void* q, const void* cache_k,
                            const void* cache_v, const void* page_table,
                            const void* bias, void* out, int s_n, int d,
                            int n_pages, int ps, int n_rows, float scale,
                            void* stream) {
  if (s_n == 0) return 0;
  int groups = kThreads / (d / 4);
  groups = groups < 1 ? 1 : (groups > kMaxGroups ? kMaxGroups : groups);
  const size_t smem = (size_t)pta_paged_attention_smem(d, n_pages, ps);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<<<s_n, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(cache_k),
      static_cast<const float*>(cache_v), static_cast<const int*>(page_table),
      static_cast<const float*>(bias), static_cast<float*>(out), d, n_pages,
      ps, n_rows, scale, scale != 1.0f ? 1 : 0, groups);
  return (int)cudaGetLastError();
}

const char* pta_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
