// Softmax with cross entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas_fused.py:_xent_partial_kernel
// (forward, finished there by _finalize_loss) and :_xent_bwd_kernel
// (backward).  Over logits x [R, V] and, per row, hard labels (int64 [R]) or
// soft labels (float [R, V]):
//
//   forward   lse  = m + log(max(l, 1e-30)),  m = max_c x,  l = sum_c e^(x - m)
//             hard: loss = lse - x[label]  (0 where label == ignore_index >= 0;
//                   a label outside [0, V) picks nothing)
//             soft: loss = lse * sum_c y - sum_c y * x,  and sum_c y is kept
//   backward  dx = g1 * e^(x - lse) - g2 * target
//             (target: the one-hot of the label, or the soft row; g1, g2 are
//             per-row coefficients the wrapper computes)
//
// What bounds it: bytes.  The forward reads x (and y when soft) once, about
// 1 flop and 1 exp per 4 or 8 bytes; the backward reads x (and y) and writes
// dx.  At R = 16384, V = 30000 fp32 with soft labels that is 3.93 GB and
// 5.90 GB, 1.17 ms and 1.76 ms at the H100's 3.35 TB/s, against ~0.12 ms of
// exps on the special-function units.
//
// The partials entry (pta_xent_partial_<x>_<y>) is the TPU kernel's own
// form: per row it writes m = max x, l = sum e^(x - m), a (sum y * x, or the
// hard label's logit) and, when soft, b = sum y, unfinished.  The tp-sharded
// loss (paddle_tpu/ops/pallas_fused.py:361 softmax_xent_sharded) runs it on
// each rank's vocabulary slice, the labels shifted by the slice's offset, and
// combines the rows' partials across the slices (one max, one sum) before it
// finishes the loss; a is never derived from a finished loss and lse, which
// would cancel.  It is the forward kernel with its last step swapped, in both
// layouts (a small vocabulary split over tp can reach the narrow one).
//
// Logits may be float, bf16 or fp16 (AMP), as the TPU kernels take them
// (_FUSABLE_DTYPES, pallas_fused.py:60): every logit and label is widened to
// fp32 as it is read, all math is fp32, loss / lse / sum_y are fp32, and dx
// is written in the logits' dtype, rounded to nearest.  Soft labels are read
// in their own dtype: float, or the logits' dtype.  One extern entry per
// (logits, labels) pair: pta_xent_{fwd,bwd}_<x>_<y>, y = f32 or x for soft
// labels, i64 for hard ones.
//
// Two layouts, both bound by bytes (at SSD's 122,688 x 21, fp32, hard
// labels: 0.0037 ms forward, 0.0069 ms backward).
//
// The wide layout (V > kFwdNarrowMaxV forward, > kBwdNarrowMaxV backward:
// the Transformer's 30,000): one block of 256 threads per row.  The TPU
// kernel walks the vocab in 16-column VMEM tiles carried across a
// sequential grid axis; here a block streams its whole row, 16 bytes a
// load (4 floats or 8 bf16 / fp16 values, when V is a multiple of that and
// the rows are 16-byte aligned), each thread keeping an online (max, sum)
// pair and the label sums in registers, so the [R, V] probability matrix
// never exists.  The per-thread partials combine in a fixed shuffle tree,
// so a row's result does not depend on timing and repeats bitwise.  A hard
// label's logit is read once by thread 0 rather than matched column by
// column.  The backward is elementwise over the row with its three per-row
// scalars.  At the Transformer's shape this runs at 1.08-1.23x its bound.
//
// The narrow layout (SSD's 21 classes, the R-CNN head's 81).  A block a
// row leaves 235 of 256 threads idle on a 21-wide row, runs the whole
// block reduction for 21 values, loads them as 21 scalar 4-byte loads
// (21 and 81 are no multiple of 4), puts the hard label's logit behind two
// dependent loads, and at 122,688 rows runs ~116 waves of short blocks:
// 55x its bound forward, 11x backward.  Instead:
//  - persistent blocks (as many as fit on the card, or one a tile) walk
//    tiles of consecutive rows, a tile being one contiguous span of
//    rows x V values whose bytes are a multiple of 16.  One thread moves
//    it into shared memory with one bulk asynchronous copy (two when
//    soft), reported to an mbarrier; kStages tiles are in flight a block,
//    so a tile's arithmetic overlaps the next tile's copy.  Two stages of
//    about 8 KB were faster than three of 16 KB at every shape tried: more
//    blocks fit an SM, and at SSD's shape every block holds one or two
//    tiles anyway.  The last, ragged tile, and a call whose x or y is not
//    16-byte aligned, come by plain loads;
//  - G lanes a row, G = 1..32 from V (about 16 values a lane: 2 at V =
//    21, 8 at V = 81): they find the row's max, then its sum of e^(x - m)
//    from shared memory, one expf a value, and combine by xor shuffles in
//    a fixed order, so a row's result repeats bitwise.  A row's columns
//    start at a shift of its index, which puts a warp's rows on distinct
//    banks where V is a multiple of 32 (the copy cannot pad a row);
//  - the tile's labels come (coalesced) while the tile does, and the hard
//    label's logit is picked from shared memory; loss, lse and sum y are
//    stored a row each from the row's first lane;
//  - the backward writes dx over x in shared memory and stores the tile
//    with 16-byte stores; its rows' lse, g1, g2 and label come once each;
//  - few rows (the tiles would not cover the card: the R-CNN head's 1,024):
//    the time is one wave's latency.  The forward takes 32 lanes a row and
//    shrinks the tile; the backward goes elementwise over [R, V] with no
//    staging, one 16-byte load and store a thread (the same dx).
// The thresholds come from tools/xent_ab.py's sweep at 2,576,448 fp32
// logits, hard labels, against the block-a-row kernels as CUDA-graph
// replays over cold inputs (H100 80GB HBM3, 700 W; PERF.md section 6).
// With every V up to 1,024 on the narrow layout, the forward won up
// to V = 256 (0.0104 ms against 0.0250) and lost at 1,000 (0.0125 against
// 0.0116); the backward won up to V = 128 (0.0112 against 0.0159) and lost
// at 256 (0.0111 against 0.0107).
//
// Products and sums are written with __fmul_rn / __fadd_rn where the plain
// PyTorch version rounds each step, so the two agree to an ulp or two in
// fp32, and to an ulp of dx's dtype after its rounding.  The narrow
// layout's dx is the wide one's bit for bit (the same expression); its
// loss and lse sum in another order.
//
// With bf16 logits the bytes fall (forward with fp32 soft labels 2.95 GB,
// backward 3.93 GB at R = 16384, V = 30000), so the bound is 0.88 ms and
// 1.17 ms.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "flash_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Folds x into the online (m, l) pair: l = sum e^(x_i - m), m = max x_i.
__device__ __forceinline__ void online(float x, float& m, float& l) {
  if (x == -INFINITY) return;  // e^-inf = 0, and -inf - -inf would be NaN
  if (x > m) {
    l = __fadd_rn(__fmul_rn(l, expf(m - x)), 1.f);
    m = x;
  } else {
    l = __fadd_rn(l, expf(x - m));
  }
}

// Merges (m2, l2) into (m, l).
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    l = l2;
    return;
  }
  const float mm = fmaxf(m, m2);
  l = __fadd_rn(__fmul_rn(l, expf(m - mm)), __fmul_rn(l2, expf(m2 - mm)));
  m = mm;
}

// Fixed-order block reduction of the four per-thread partials; thread 0
// gets the result.
__device__ void block_reduce(float& m, float& l, float& a, float& b) {
  __shared__ float sm[kWarps], sl[kWarps], sa[kWarps], sb[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge(m, l, m2, l2);
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? sm[lane] : -INFINITY;
    l = lane < kWarps ? sl[lane] : 0.f;
    a = lane < kWarps ? sa[lane] : 0.f;
    b = lane < kWarps ? sb[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
      merge(m, l, m2, l2);
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
      b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
    }
  }
}

// Widening to fp32 and rounding to nearest back.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// N values of type T from p (16-byte aligned, N * sizeof(T) a multiple of
// 16), widened to fp32; streaming loads, as each byte is read once.
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float (&out)[N]) {
  constexpr int kWords = N * (int)sizeof(T) / 16;
  uint4 raw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) raw[w] = __ldcs(reinterpret_cast<const uint4*>(p) + w);
  const T* t = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(t[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float (&v)[N]) {
  constexpr int kWords = N * (int)sizeof(T) / 16;
  uint4 raw[kWords];
  T* t = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = from_f<T>(v[i]);
#pragma unroll
  for (int w = 0; w < kWords; ++w) __stcs(reinterpret_cast<uint4*>(p) + w, raw[w]);
}

// Values of T in one 16-byte load.
template <typename T>
__host__ __device__ constexpr int vec_width() { return 16 / (int)sizeof(T); }

// T: logits; L: soft labels (float or T; unused for hard labels).
// kPartial: the partials entry's form, which writes the row's (m, l, a[, b])
// to (loss, lse, a_out[, sum_y]) instead of finishing the loss: m = max x,
// l = sum e^(x - m), a = sum y * x (soft) or the label's logit (hard, 0 when
// the label is outside [0, v)), b = sum y.
template <typename T, typename L, bool kSoft, bool kVec, bool kPartial = false>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ x, const L* __restrict__ y,
                const long long* __restrict__ label,
                float* __restrict__ loss, float* __restrict__ lse,
                float* __restrict__ sum_y, int v, long long ignore,
                float* __restrict__ a_out) {
  constexpr int kN = vec_width<T>();
  const long long r = blockIdx.x;
  const T* xr = x + r * v;
  const L* yr = kSoft ? y + r * v : nullptr;
  float m = -INFINITY, l = 0.f, a = 0.f, b = 0.f;
  int c0 = 0;
  if (kVec) {
    const int vn = v / kN;
    for (int i = threadIdx.x; i < vn; i += kThreads) {
      float xv[kN];
      load_n<T, kN>(xr + i * kN, xv);
#pragma unroll
      for (int j = 0; j < kN; ++j) online(xv[j], m, l);
      if (kSoft) {
        float yv[kN];
        load_n<L, kN>(yr + i * kN, yv);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          a = __fadd_rn(a, __fmul_rn(yv[j], xv[j]));
          b = __fadd_rn(b, yv[j]);
        }
      }
    }
    c0 = vn * kN;
  }
  for (int c = c0 + threadIdx.x; c < v; c += kThreads) {
    const float xv = to_f(__ldcs(xr + c));
    online(xv, m, l);
    if (kSoft) {
      const float yv = to_f(__ldcs(yr + c));
      a = __fadd_rn(a, __fmul_rn(yv, xv));
      b = __fadd_rn(b, yv);
    }
  }
  block_reduce(m, l, a, b);
  if (kPartial && threadIdx.x == 0) {
    loss[r] = m;
    lse[r] = l;
    if (kSoft) {
      a_out[r] = a;
      sum_y[r] = b;
    } else {
      const long long lab = label[r];
      a_out[r] = (lab >= 0 && lab < v) ? to_f(xr[lab]) : 0.f;
    }
    return;
  }
  if (threadIdx.x == 0) {
    const float s = m + logf(fmaxf(l, 1e-30f));
    float out;
    if (kSoft) {
      out = __fsub_rn(__fmul_rn(s, b), a);
      sum_y[r] = b;
    } else {
      const long long lab = label[r];
      const float picked = (lab >= 0 && lab < v) ? to_f(xr[lab]) : 0.f;
      out = (ignore >= 0 && lab == ignore) ? 0.f : __fsub_rn(s, picked);
    }
    loss[r] = out;
    lse[r] = s;
  }
}

template <bool kSoft>
__device__ __forceinline__ float grad_at(float xv, float yv, int c,
                                         long long lab, float s, float g1,
                                         float g2) {
  const float t = kSoft ? yv : (c == lab ? 1.f : 0.f);
  return __fsub_rn(__fmul_rn(g1, expf(xv - s)), __fmul_rn(g2, t));
}

template <typename T, typename L, bool kSoft, bool kVec>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ x, const L* __restrict__ y,
                const long long* __restrict__ label,
                const float* __restrict__ lse, const float* __restrict__ g1,
                const float* __restrict__ g2, T* __restrict__ dx, int v) {
  constexpr int kN = vec_width<T>();
  const long long r = blockIdx.x;
  const T* xr = x + r * v;
  const L* yr = kSoft ? y + r * v : nullptr;
  T* dr = dx + r * v;
  const float s = lse[r], a1 = g1[r], a2 = g2[r];
  const long long lab = kSoft ? -1 : label[r];
  int c0 = 0;
  if (kVec) {
    const int vn = v / kN;
    for (int i = threadIdx.x; i < vn; i += kThreads) {
      float xv[kN], yv[kN], o[kN];
      load_n<T, kN>(xr + i * kN, xv);
      if (kSoft) {
        load_n<L, kN>(yr + i * kN, yv);
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j) yv[j] = 0.f;
      }
      const int c = i * kN;
#pragma unroll
      for (int j = 0; j < kN; ++j) o[j] = grad_at<kSoft>(xv[j], yv[j], c + j, lab, s, a1, a2);
      store_n<T, kN>(dr + c, o);
    }
    c0 = vn * kN;
  }
  for (int c = c0 + threadIdx.x; c < v; c += kThreads) {
    const float yv = kSoft ? to_f(__ldcs(yr + c)) : 0.f;
    __stcs(dr + c, from_f<T>(grad_at<kSoft>(to_f(__ldcs(xr + c)), yv, c, lab, s, a1, a2)));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}

// ---------------------------------------------------------------------------
// The narrow layout: tiles of consecutive rows in shared memory, G lanes a
// row.
// ---------------------------------------------------------------------------

constexpr int kFwdNarrowMaxV = 256;  // the sweep's crossovers (header)
constexpr int kBwdNarrowMaxV = 128;
constexpr int kStages = 2;            // tiles in flight per block
constexpr int kNarrowThreads = 256;   // a block's threads before shrinking
constexpr int kStageBytes = 8192;     // aim of a stage's bytes (x and y)
constexpr int kFwdSideBytes = 8;      // per row: the label
constexpr int kBwdSideBytes = 20;     // per row: label, lse, g1, g2
constexpr int kFewThreads = 128;      // at most, a block of the few-rows backward

__device__ __forceinline__ float group_max(float v, int g) {
  for (int o = 1; o < g; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Every lane of the group gets the same bits: a + b == b + a in each round.
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = 1; o < g; o <<= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The first column that lane `lane` of a row's G lanes reads.  Lane l takes
// columns l, l + G, ... < v, each moved on by the row's shift mod v: the
// shift puts the 32 / G rows of a warp on distinct banks where v is a
// multiple of 32 (4-byte values), and depends only on the row's index, so a
// row's order of sums does not depend on the tiling.
template <int G>
__device__ __forceinline__ int first_col(long long row, int lane, int v) {
  const int shift = ((int)(row & (32 / G - 1)) * (G - v)) & 31;
  return (lane + shift) % v;
}

__host__ __device__ __forceinline__ size_t round128(size_t n) { return (n + 127) & ~(size_t)127; }

// n values from global src to shared dst (or back): 16-byte words while
// both ends are 16-byte aligned, then single values.
template <typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* src, int n, bool vec) {
  int done = 0;
  if (vec) {
    const int words = n * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < words; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = __ldcs(reinterpret_cast<const uint4*>(src) + i);
    done = words * 16 / (int)sizeof(T);
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldcs(src + i);
}

template <typename T>
__device__ __forceinline__ void copy_out(T* dst, const T* src, int n, bool vec) {
  int done = 0;
  if (vec) {
    const int words = n * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < words; i += blockDim.x)
      __stcs(reinterpret_cast<uint4*>(dst) + i, reinterpret_cast<const uint4*>(src)[i]);
    done = words * 16 / (int)sizeof(T);
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) __stcs(dst + i, src[i]);
}

// What a narrow block holds in shared memory: kStages stages of a tile of x
// (and of y when soft), then the tile's per-row values.
template <typename T, typename L, bool kSoft>
struct NarrowSmem {
  unsigned char* base;
  size_t x_bytes, stage;
  int tile_rows;
  __device__ NarrowSmem(unsigned char* b, int rows, int v) : base(b), tile_rows(rows) {
    x_bytes = round128((size_t)rows * v * sizeof(T));
    stage = x_bytes + (kSoft ? round128((size_t)rows * v * sizeof(L)) : 0);
  }
  __device__ T* x(int s) const { return reinterpret_cast<T*>(base + s * stage); }
  __device__ L* y(int s) const { return reinterpret_cast<L*>(base + s * stage + x_bytes); }
  __device__ long long* label() const {
    return reinterpret_cast<long long*>(base + kStages * stage);
  }
  __device__ float* side(int k) const {  // 0: lse, 1: g1, 2: g2 (backward)
    return reinterpret_cast<float*>(label() + tile_rows) + k * tile_rows;
  }
};

// Local tile i of the block (global tile t) is loaded into stage i % kStages:
// by one bulk copy (two when soft) when `bulk` and the tile is whole, else by
// every thread with plain loads (the last, ragged tile; a call whose x or y
// is not 16-byte aligned).  Only the last tile can be ragged, so every
// earlier use of a stage was a bulk copy and completed one phase of its
// mbarrier: a tile's wait is on parity (i / kStages) & 1.
template <typename T, typename L, bool kSoft>
__device__ __forceinline__ void issue_tile(const NarrowSmem<T, L, kSoft>& sm, uint64_t* bar,
                                           const T* x, const L* y, long long t,
                                           long long whole, bool bulk, int s, int v) {
  if (!bulk || t >= whole) return;
  const long long off = t * sm.tile_rows * (long long)v;
  const uint32_t xb = (uint32_t)((size_t)sm.tile_rows * v * sizeof(T));
  const uint32_t yb = kSoft ? (uint32_t)((size_t)sm.tile_rows * v * sizeof(L)) : 0u;
  sm90::mbar_expect_tx(&bar[s], xb + yb);
  sm90::bulk_load(sm.x(s), x + off, xb, &bar[s]);
  if (kSoft) sm90::bulk_load(sm.y(s), y + off, yb, &bar[s]);
}

template <typename T, typename L, bool kSoft>
__device__ __forceinline__ void await_tile(const NarrowSmem<T, L, kSoft>& sm, uint64_t* bar,
                                           const T* x, const L* y, long long t,
                                           long long whole, bool bulk, int s, int i,
                                           int rows, int v) {
  if (bulk && t < whole) {
    sm90::mbar_wait(&bar[s], (uint32_t)((i / kStages) & 1));
  } else {
    const long long off = t * sm.tile_rows * (long long)v;
    copy_in(sm.x(s), x + off, rows * v, bulk);
    if (kSoft) copy_in(sm.y(s), y + off, rows * v, bulk);
  }
}

template <typename T, typename L, bool kSoft, int G, bool kPartial = false>
__global__ void __launch_bounds__(kNarrowThreads)
xent_fwd_narrow_kernel(const T* __restrict__ x, const L* __restrict__ y,
                       const long long* __restrict__ label,
                       float* __restrict__ loss, float* __restrict__ lse,
                       float* __restrict__ sum_y, long long r, int v,
                       long long ignore, int tile_rows, int bulk,
                       float* __restrict__ a_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[kStages];
  const NarrowSmem<T, L, kSoft> sm(smem, tile_rows, v);
  const int ng = blockDim.x / G, group = threadIdx.x / G, lane = threadIdx.x % G;
  const long long tiles = (r + tile_rows - 1) / tile_rows, whole = r / tile_rows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&bar[s], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s)
      issue_tile(sm, bar, x, y, blockIdx.x + (long long)s * gridDim.x, whole, bulk, s, v);
  int i = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int s = i % kStages;
    const long long row0 = t * tile_rows;
    const int rows = (int)min((long long)tile_rows, r - row0);
    if (!kSoft)  // the labels come while the tile does
      for (int k = threadIdx.x; k < rows; k += blockDim.x) sm.label()[k] = label[row0 + k];
    await_tile(sm, bar, x, y, t, whole, bulk, s, i, rows, v);
    __syncthreads();
    for (int k0 = 0; k0 < tile_rows; k0 += ng) {  // the same count in every warp
      const int k = k0 + group;
      const bool live = k < rows;
      const T* xr = sm.x(s) + (size_t)k * v;
      const L* yr = kSoft ? sm.y(s) + (size_t)k * v : nullptr;
      const int c0 = first_col<G>(row0 + k, lane, v);
      float m = -INFINITY;
      if (live) {
        int c = c0;
        for (int j = lane; j < v; j += G) {
          m = fmaxf(m, to_f(xr[c]));
          c += G;
          if (c >= v) c -= v;
        }
      }
      m = group_max(m, G);
      float l = 0.f, a = 0.f, b = 0.f;
      if (live) {
        int c = c0;
        for (int j = lane; j < v; j += G) {
          const float xv = to_f(xr[c]);
          if (xv != -INFINITY) l = __fadd_rn(l, expf(xv - m));
          if (kSoft) {
            const float yv = to_f(yr[c]);
            a = __fadd_rn(a, __fmul_rn(yv, xv));
            b = __fadd_rn(b, yv);
          }
          c += G;
          if (c >= v) c -= v;
        }
      }
      l = group_sum(l, G);
      if (kSoft) {
        a = group_sum(a, G);
        b = group_sum(b, G);
      }
      if (kPartial && live && lane == 0) {  // the partials entry
        loss[row0 + k] = m;
        lse[row0 + k] = l;
        if (kSoft) {
          a_out[row0 + k] = a;
          sum_y[row0 + k] = b;
        } else {
          const long long lab = sm.label()[k];
          a_out[row0 + k] = (lab >= 0 && lab < v) ? to_f(xr[lab]) : 0.f;
        }
      } else if (live && lane == 0) {
        const float sl = m + logf(fmaxf(l, 1e-30f));
        float out;
        if (kSoft) {
          out = __fsub_rn(__fmul_rn(sl, b), a);
          sum_y[row0 + k] = b;
        } else {
          const long long lab = sm.label()[k];
          const float picked = (lab >= 0 && lab < v) ? to_f(xr[lab]) : 0.f;
          out = (ignore >= 0 && lab == ignore) ? 0.f : __fsub_rn(sl, picked);
        }
        loss[row0 + k] = out;
        lse[row0 + k] = sl;
      }
    }
    __syncthreads();  // stage s is read: refill it
    if (threadIdx.x == 0)
      issue_tile(sm, bar, x, y, t + (long long)kStages * gridDim.x, whole, bulk, s, v);
  }
}

template <typename T, typename L, bool kSoft, int G>
__global__ void __launch_bounds__(kNarrowThreads)
xent_bwd_narrow_kernel(const T* __restrict__ x, const L* __restrict__ y,
                       const long long* __restrict__ label,
                       const float* __restrict__ lse, const float* __restrict__ g1,
                       const float* __restrict__ g2, T* __restrict__ dx,
                       long long r, int v, int tile_rows, int bulk, int vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[kStages];
  const NarrowSmem<T, L, kSoft> sm(smem, tile_rows, v);
  const int ng = blockDim.x / G, group = threadIdx.x / G, lane = threadIdx.x % G;
  const long long tiles = (r + tile_rows - 1) / tile_rows, whole = r / tile_rows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&bar[s], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s)
      issue_tile(sm, bar, x, y, blockIdx.x + (long long)s * gridDim.x, whole, bulk, s, v);
  int i = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int s = i % kStages;
    const long long row0 = t * tile_rows;
    const int rows = (int)min((long long)tile_rows, r - row0);
    for (int k = threadIdx.x; k < rows; k += blockDim.x) {  // while the tile comes
      if (!kSoft) sm.label()[k] = label[row0 + k];
      sm.side(0)[k] = lse[row0 + k];
      sm.side(1)[k] = g1[row0 + k];
      sm.side(2)[k] = g2[row0 + k];
    }
    await_tile(sm, bar, x, y, t, whole, bulk, s, i, rows, v);
    __syncthreads();
    for (int k = group; k < rows; k += ng) {  // no shuffles: rows run free
      T* xr = sm.x(s) + (size_t)k * v;
      const L* yr = kSoft ? sm.y(s) + (size_t)k * v : nullptr;
      const float sl = sm.side(0)[k], a1 = sm.side(1)[k], a2 = sm.side(2)[k];
      const long long lab = kSoft ? -1 : sm.label()[k];
      int c = first_col<G>(row0 + k, lane, v);
      for (int j = lane; j < v; j += G) {
        const float yv = kSoft ? to_f(yr[c]) : 0.f;
        xr[c] = from_f<T>(grad_at<kSoft>(to_f(xr[c]), yv, c, lab, sl, a1, a2));
        c += G;
        if (c >= v) c -= v;
      }
    }
    sm90::fence_async_smem();  // dx overwrote x: order it before the next bulk copy
    __syncthreads();
    copy_out(dx + row0 * v, sm.x(s), rows * v, vec_out);
    __syncthreads();  // stage s is read: refill it
    if (threadIdx.x == 0)
      issue_tile(sm, bar, x, y, t + (long long)kStages * gridDim.x, whole, bulk, s, v);
  }
}

// The backward for few rows (the narrow tiles would not cover the card):
// one wave that is all latency, so no staging: elementwise over the whole
// [r, v] (fewer than 2^31 values), one 16-byte load of x (and y) and one
// store of dx a thread where aligned and v is at least a load's values, so
// that a load spans at most two rows, whose lse, g1, g2 and label are read
// through the cache beside it.  dx is the tiled kernel's, bit for bit: the
// same expression on the same values.
template <typename T, typename L, bool kSoft>
__global__ void __launch_bounds__(kFewThreads)
xent_bwd_few_kernel(const T* __restrict__ x, const L* __restrict__ y,
                    const long long* __restrict__ label,
                    const float* __restrict__ lse, const float* __restrict__ g1,
                    const float* __restrict__ g2, T* __restrict__ dx, int r, int v,
                    int vec) {
  constexpr int kN = vec_width<T>();
  const int n = r * v, stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  int done = 0;
  if (vec) {
    const int chunks = n / kN;
    for (int i = first; i < chunks; i += stride) {
      const int k0 = i * kN / v, k1 = min(k0 + 1, r - 1);
      const long long l0 = kSoft ? -1 : __ldg(label + k0), l1 = kSoft ? -1 : __ldg(label + k1);
      const float s0 = __ldg(lse + k0), s1 = __ldg(lse + k1);
      const float a0 = __ldg(g1 + k0), a1 = __ldg(g1 + k1);
      const float b0 = __ldg(g2 + k0), b1 = __ldg(g2 + k1);
      float xv[kN], yv[kN], o[kN];
      load_n<T, kN>(x + i * kN, xv);
      if (kSoft) {
        load_n<L, kN>(y + i * kN, yv);
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j) yv[j] = 0.f;
      }
      int c = i * kN - k0 * v;
      bool next = false;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        o[j] = next ? grad_at<kSoft>(xv[j], yv[j], c, l1, s1, a1, b1)
                    : grad_at<kSoft>(xv[j], yv[j], c, l0, s0, a0, b0);
        if (++c == v) {
          c = 0;
          next = true;
        }
      }
      store_n<T, kN>(dx + i * kN, o);
    }
    done = chunks * kN;
  }
  for (int e = done + first; e < n; e += stride) {
    const int k = e / v;
    const float yv = kSoft ? to_f(__ldcs(y + e)) : 0.f;
    __stcs(dx + e, from_f<T>(grad_at<kSoft>(to_f(__ldcs(x + e)), yv, e - k * v,
                                            kSoft ? -1 : __ldg(label + k), __ldg(lse + k),
                                            __ldg(g1 + k), __ldg(g2 + k))));
  }
}

// The SMs of the current device, read once per device.
int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cache[dev] == 0) cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev);
  return cache[dev] > 0 ? cache[dev] : 1;
}

bool narrow_layout(long long r, int v, bool backward) {
  return r > 0 && v >= 1 && v <= (backward ? kBwdNarrowMaxV : kFwdNarrowMaxV);
}

// G: the lanes of a row, about 16 values a lane, a power of two up to 32.
int lanes_for(int v) {
  const int need = (v + 15) / 16;
  int g = 1;
  while (g < need && g < 32) g <<= 1;
  return g;
}

// The fewest rows whose values of `bytes` each fill whole 16-byte words.
int rows_unit(int v, int bytes) {
  int u = 1;
  while (((long long)v * bytes * u) % 16) u <<= 1;
  return u;
}

struct NarrowPlan {
  int g, threads, tile_rows;
  bool few;  // the tiles at the full block would not cover the card
  size_t smem;
};

// 256 / G rows at a time, and as many such passes a tile as fill about
// kStages * kStageBytes with the stages and the rows' own values.  Where
// the tiles would not cover the card (few rows), a row takes 32 lanes
// (shorter chains: the time is latency) and the tile shrinks, first its
// passes, then its rows and the block's threads with them, down to a warp
// or to a tile of 16-byte words.
NarrowPlan narrow_plan(long long r, int v, int ex, int ey, int side) {
  NarrowPlan p;
  p.g = lanes_for(v);
  const int unit = std::max(rows_unit(v, ex), ey ? rows_unit(v, ey) : 1);
  int ng = kNarrowThreads / p.g;
  int k = std::max(1, kStages * kStageBytes / (ng * (kStages * v * (ex + ey) + side)));
  const long long sms = sm_count();
  auto tiles = [&]() { return (r + (long long)ng * k - 1) / ((long long)ng * k); };
  p.few = tiles() < sms;
  if (p.few) {
    p.g = 32;
    ng = kNarrowThreads / 32;
    k = 1;
  }
  while (tiles() < sms) {
    if (k > 1)
      k /= 2;
    else if (ng > unit && ng * p.g > 32)
      ng /= 2;
    else
      break;
  }
  p.threads = ng * p.g;
  p.tile_rows = ng * k;
  p.smem = kStages * (round128((size_t)p.tile_rows * v * ex) +
                      (ey ? round128((size_t)p.tile_rows * v * ey) : 0)) +
           (size_t)p.tile_rows * side;
  return p;
}

// A persistent grid: as many blocks as fit on the card at once, or one a
// tile if there are fewer tiles.
template <typename Kernel, typename... Args>
int launch_narrow(Kernel kernel, const NarrowPlan& p, long long r, cudaStream_t st,
                  Args... args) {
  // (always: the static mbarriers count against the default 48 KB too)
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, p.threads, p.smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (r + p.tile_rows - 1) / p.tile_rows;
  const unsigned grid = (unsigned)std::min(tiles, (long long)sm_count() * occ);
  kernel<<<grid, p.threads, p.smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, typename L, bool kSoft, bool kPartial = false>
int fwd_narrow(const T* x, const L* y, const long long* lb, float* lo, float* ls,
               float* sy, long long r, int v, long long ignore, cudaStream_t st,
               float* ao = nullptr) {
  const NarrowPlan p = narrow_plan(r, v, sizeof(T), kSoft ? sizeof(L) : 0, kFwdSideBytes);
  const int bulk = aligned16(x) && (!kSoft || aligned16(y));
#define PTA_FWD_NARROW(G)                                                             \
  case G:                                                                             \
    return launch_narrow(xent_fwd_narrow_kernel<T, L, kSoft, G, kPartial>, p, r, st, \
                         x, y, lb, lo, ls, sy, r, v, ignore, p.tile_rows, bulk, ao);
  switch (p.g) {
    PTA_FWD_NARROW(1)
    PTA_FWD_NARROW(2)
    PTA_FWD_NARROW(4)
    PTA_FWD_NARROW(8)
    PTA_FWD_NARROW(16)
    PTA_FWD_NARROW(32)
  }
#undef PTA_FWD_NARROW
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename L, bool kSoft>
int bwd_narrow(const T* x, const L* y, const long long* lb, const float* ls,
               const float* c1, const float* c2, T* d, long long r, int v,
               cudaStream_t st) {
  const NarrowPlan p = narrow_plan(r, v, sizeof(T), kSoft ? sizeof(L) : 0, kBwdSideBytes);
  const int bulk = aligned16(x) && (!kSoft || aligned16(y));
  const int vec_out = aligned16(d);
  const long long n = r * v;
  if (p.few && n < (1LL << 31)) {
    const int kN = vec_width<T>();
    const long long items = std::max(n / kN, n % kN);
    int threads = kFewThreads;  // smaller blocks until they cover the card
    while (threads > 32 && (items + threads - 1) / threads < sm_count()) threads /= 2;
    const unsigned grid = (unsigned)std::max(1LL, (items + threads - 1) / threads);
    xent_bwd_few_kernel<T, L, kSoft><<<grid, threads, 0, st>>>(
        x, y, lb, ls, c1, c2, d, (int)r, v, bulk && vec_out && v >= kN);
    return (int)cudaGetLastError();
  }
#define PTA_BWD_NARROW(G)                                                                \
  case G:                                                                                \
    return launch_narrow(xent_bwd_narrow_kernel<T, L, kSoft, G>, p, r, st, x, y, lb, ls, \
                         c1, c2, d, r, v, p.tile_rows, bulk, vec_out);
  switch (p.g) {
    PTA_BWD_NARROW(1)
    PTA_BWD_NARROW(2)
    PTA_BWD_NARROW(4)
    PTA_BWD_NARROW(8)
    PTA_BWD_NARROW(16)
    PTA_BWD_NARROW(32)
  }
#undef PTA_BWD_NARROW
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename L, bool kPartial = false>
int xent_fwd(const void* x, const void* y, const void* label, int soft,
             void* loss, void* lse, void* sum_y, long long r, int v,
             long long ignore, void* stream, void* a_out = nullptr) {
  if (r == 0) return 0;
  const bool vec = (v % vec_width<T>() == 0) && aligned16(x) && (!soft || aligned16(y));
  const T* xt = static_cast<const T*>(x);
  const L* yt = static_cast<const L*>(y);
  const long long* lb = static_cast<const long long*>(label);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  float* sy = static_cast<float*>(sum_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ao = static_cast<float*>(a_out);
  if (narrow_layout(r, v, false))  // hard labels: one kernel whatever L is
    return soft ? fwd_narrow<T, L, true, kPartial>(xt, yt, lb, lo, ls, sy, r, v, ignore, st, ao)
                : fwd_narrow<T, float, false, kPartial>(xt, nullptr, lb, lo, ls, sy, r, v,
                                                        ignore, st, ao);
  const dim3 grid((unsigned)r);
  if (soft && vec)
    xent_fwd_kernel<T, L, true, true, kPartial>
        <<<grid, kThreads, 0, st>>>(xt, yt, lb, lo, ls, sy, v, ignore, ao);
  else if (soft)
    xent_fwd_kernel<T, L, true, false, kPartial>
        <<<grid, kThreads, 0, st>>>(xt, yt, lb, lo, ls, sy, v, ignore, ao);
  else if (vec)
    xent_fwd_kernel<T, L, false, true, kPartial>
        <<<grid, kThreads, 0, st>>>(xt, yt, lb, lo, ls, sy, v, ignore, ao);
  else
    xent_fwd_kernel<T, L, false, false, kPartial>
        <<<grid, kThreads, 0, st>>>(xt, yt, lb, lo, ls, sy, v, ignore, ao);
  return (int)cudaGetLastError();
}

template <typename T, typename L>
int xent_bwd(const void* x, const void* y, const void* label, int soft,
             const void* lse, const void* g1, const void* g2, void* dx,
             long long r, int v, void* stream) {
  if (r == 0) return 0;
  const bool vec = (v % vec_width<T>() == 0) && aligned16(x) && aligned16(dx) &&
                   (!soft || aligned16(y));
  const T* xt = static_cast<const T*>(x);
  const L* yt = static_cast<const L*>(y);
  const long long* lb = static_cast<const long long*>(label);
  const float* ls = static_cast<const float*>(lse);
  const float* c1 = static_cast<const float*>(g1);
  const float* c2 = static_cast<const float*>(g2);
  T* d = static_cast<T*>(dx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (narrow_layout(r, v, true))
    return soft ? bwd_narrow<T, L, true>(xt, yt, lb, ls, c1, c2, d, r, v, st)
                : bwd_narrow<T, float, false>(xt, nullptr, lb, ls, c1, c2, d, r, v, st);
  const dim3 grid((unsigned)r);
  if (soft && vec)
    xent_bwd_kernel<T, L, true, true><<<grid, kThreads, 0, st>>>(xt, yt, lb, ls, c1, c2, d, v);
  else if (soft)
    xent_bwd_kernel<T, L, true, false><<<grid, kThreads, 0, st>>>(xt, yt, lb, ls, c1, c2, d, v);
  else if (vec)
    xent_bwd_kernel<T, L, false, true><<<grid, kThreads, 0, st>>>(xt, yt, lb, ls, c1, c2, d, v);
  else
    xent_bwd_kernel<T, L, false, false><<<grid, kThreads, 0, st>>>(xt, yt, lb, ls, c1, c2, d, v);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward.  x [r, v] of the entry's logits type; soft: y [r, v] of its
// labels type, label unused; hard: label [r] int64, y unused.  Writes
// loss [r], lse [r] and, when soft, sum_y [r] (fp32).  Launches on
// `stream`; returns cudaGetLastError() (0 = ok).
//
// Backward.  As the forward, plus lse, g1, g2 [r] (fp32); writes dx [r, v]
// in the logits' type.
//
// Partials (the tp-sharded forward: the TPU kernel's own outputs, combined
// across the vocabulary shards by the caller).  As the forward, but writes
// the row's m [r], l [r], a [r] and, when soft, b [r] (fp32): m = max x,
// l = sum e^(x - m), a = sum y * x or the hard label's logit (0 for a label
// outside [0, v): a shard that does not hold it), b = sum y.  Both layouts.
//
// The i64 entries are the hard-label ones (soft must be 0).
#define PTA_XENT_ENTRIES(SX, SY, T, L)                                             \
  extern "C" int pta_xent_partial_##SX##_##SY(const void* x, const void* y,        \
                                              const void* label, int soft,         \
                                              void* m, void* l, void* a, void* b,  \
                                              long long r, int v, void* stream) {  \
    return xent_fwd<T, L, true>(x, y, label, soft, m, l, b, r, v, -1, stream, a);  \
  }                                                                                \
  extern "C" int pta_xent_fwd_##SX##_##SY(const void* x, const void* y,            \
                                          const void* label, int soft, void* loss, \
                                          void* lse, void* sum_y, long long r,     \
                                          int v, long long ignore, void* stream) { \
    return xent_fwd<T, L>(x, y, label, soft, loss, lse, sum_y, r, v, ignore,      \
                          stream);                                                 \
  }                                                                                \
  extern "C" int pta_xent_bwd_##SX##_##SY(const void* x, const void* y,            \
                                          const void* label, int soft,             \
                                          const void* lse, const void* g1,         \
                                          const void* g2, void* dx, long long r,   \
                                          int v, void* stream) {                   \
    return xent_bwd<T, L>(x, y, label, soft, lse, g1, g2, dx, r, v, stream);      \
  }

PTA_XENT_ENTRIES(f32, f32, float, float)
PTA_XENT_ENTRIES(f32, i64, float, float)
PTA_XENT_ENTRIES(bf16, f32, __nv_bfloat16, float)
PTA_XENT_ENTRIES(bf16, bf16, __nv_bfloat16, __nv_bfloat16)
PTA_XENT_ENTRIES(bf16, i64, __nv_bfloat16, float)
PTA_XENT_ENTRIES(f16, f32, __half, float)
PTA_XENT_ENTRIES(f16, f16, __half, __half)
PTA_XENT_ENTRIES(f16, i64, __half, float)

// The layout a call of r rows of v logits takes, forward or backward: 1 the
// narrow one, 0 the block a row (the rule is the row width alone,
// kFwdNarrowMaxV and kBwdNarrowMaxV, for every dtype).
extern "C" int pta_xent_layout(long long r, int v, int backward) {
  return narrow_layout(r, v, backward != 0) ? 1 : 0;
}

extern "C" const char* pta_xent_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
