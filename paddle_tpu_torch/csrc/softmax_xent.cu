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
// Logits may be float, bf16 or fp16 (AMP), as the TPU kernels take them
// (_FUSABLE_DTYPES, pallas_fused.py:60): every logit and label is widened to
// fp32 as it is read, all math is fp32, loss / lse / sum_y are fp32, and dx
// is written in the logits' dtype, rounded to nearest.  Soft labels are read
// in their own dtype: float, or the logits' dtype.  One extern entry per
// (logits, labels) pair: pta_xent_{fwd,bwd}_<x>_<y>, y = f32 or x for soft
// labels, i64 for hard ones.
//
// Design: one block of 256 threads per row.  The TPU kernel walks the vocab
// in 16-column VMEM tiles carried across a sequential grid axis; here a
// block streams its whole row, 16 bytes a load (4 floats or 8 bf16 / fp16
// values, when V is a multiple of that and the rows are 16-byte aligned),
// each thread keeping an online (max, sum) pair and the label sums in
// registers, so the [R, V] probability matrix never exists.  The per-thread
// partials combine in a fixed shuffle tree, so a row's result does not
// depend on timing and repeats bitwise.  A hard label's logit is read once
// by thread 0 rather than matched column by column.  The backward is
// elementwise over the row with its three per-row scalars.  Products and
// sums are written with __fmul_rn / __fadd_rn where the plain PyTorch
// version rounds each step, so the two agree to an ulp or two in fp32, and
// to an ulp of dx's dtype after its rounding.
//
// With bf16 logits the bytes fall (forward with fp32 soft labels 2.95 GB,
// backward 3.93 GB at the shape above), so the bound is 0.88 ms and 1.17 ms.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

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
template <typename T, typename L, bool kSoft, bool kVec>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ x, const L* __restrict__ y,
                const long long* __restrict__ label,
                float* __restrict__ loss, float* __restrict__ lse,
                float* __restrict__ sum_y, int v, long long ignore) {
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

template <typename T, typename L>
int xent_fwd(const void* x, const void* y, const void* label, int soft,
             void* loss, void* lse, void* sum_y, long long r, int v,
             long long ignore, void* stream) {
  if (r == 0) return 0;
  const bool vec = (v % vec_width<T>() == 0) && aligned16(x) && (!soft || aligned16(y));
  const T* xt = static_cast<const T*>(x);
  const L* yt = static_cast<const L*>(y);
  const long long* lb = static_cast<const long long*>(label);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  float* sy = static_cast<float*>(sum_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)r);
  if (soft && vec)
    xent_fwd_kernel<T, L, true, true><<<grid, kThreads, 0, st>>>(xt, yt, lb, lo, ls, sy, v, ignore);
  else if (soft)
    xent_fwd_kernel<T, L, true, false><<<grid, kThreads, 0, st>>>(xt, yt, lb, lo, ls, sy, v, ignore);
  else if (vec)
    xent_fwd_kernel<T, L, false, true><<<grid, kThreads, 0, st>>>(xt, yt, lb, lo, ls, sy, v, ignore);
  else
    xent_fwd_kernel<T, L, false, false><<<grid, kThreads, 0, st>>>(xt, yt, lb, lo, ls, sy, v, ignore);
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
// The i64 entries are the hard-label ones (soft must be 0).
#define PTA_XENT_ENTRIES(SX, SY, T, L)                                             \
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

extern "C" const char* pta_xent_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
