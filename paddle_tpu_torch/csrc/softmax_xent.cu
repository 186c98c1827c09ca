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
// Design: one block of 256 threads per row.  The TPU kernel walks the vocab
// in 16-column VMEM tiles carried across a sequential grid axis; here a
// block streams its whole row (float4 loads when V % 4 == 0), each thread
// keeping an online (max, sum) pair and the label sums in registers, so the
// [R, V] probability matrix never exists.  The per-thread partials combine
// in a fixed shuffle tree, so a row's result does not depend on timing and
// repeats bitwise.  A hard label's logit is read once by thread 0 rather
// than matched column by column.  The backward is elementwise over the row
// with its three per-row scalars.  Products and sums are written with
// __fmul_rn / __fadd_rn where the plain PyTorch version rounds each step,
// so the two agree to an ulp or two.

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

template <bool kSoft, bool kVec>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const long long* __restrict__ label,
                float* __restrict__ loss, float* __restrict__ lse,
                float* __restrict__ sum_y, int v, long long ignore) {
  const long long r = blockIdx.x;
  const float* xr = x + r * v;
  const float* yr = kSoft ? y + r * v : nullptr;
  float m = -INFINITY, l = 0.f, a = 0.f, b = 0.f;
  int c0 = 0;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* y4 = reinterpret_cast<const float4*>(yr);
    const int v4 = v >> 2;
    for (int i = threadIdx.x; i < v4; i += kThreads) {
      const float4 xv = __ldcs(x4 + i);
      online(xv.x, m, l);
      online(xv.y, m, l);
      online(xv.z, m, l);
      online(xv.w, m, l);
      if (kSoft) {
        const float4 yv = __ldcs(y4 + i);
        a = __fadd_rn(a, __fmul_rn(yv.x, xv.x));
        a = __fadd_rn(a, __fmul_rn(yv.y, xv.y));
        a = __fadd_rn(a, __fmul_rn(yv.z, xv.z));
        a = __fadd_rn(a, __fmul_rn(yv.w, xv.w));
        b = __fadd_rn(__fadd_rn(b, yv.x), __fadd_rn(yv.y, __fadd_rn(yv.z, yv.w)));
      }
    }
    c0 = v4 << 2;
  }
  for (int c = c0 + threadIdx.x; c < v; c += kThreads) {
    const float xv = __ldcs(xr + c);
    online(xv, m, l);
    if (kSoft) {
      const float yv = __ldcs(yr + c);
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
      const float picked = (lab >= 0 && lab < v) ? xr[lab] : 0.f;
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

template <bool kSoft, bool kVec>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const long long* __restrict__ label,
                const float* __restrict__ lse, const float* __restrict__ g1,
                const float* __restrict__ g2, float* __restrict__ dx, int v) {
  const long long r = blockIdx.x;
  const float* xr = x + r * v;
  const float* yr = kSoft ? y + r * v : nullptr;
  float* dr = dx + r * v;
  const float s = lse[r], a1 = g1[r], a2 = g2[r];
  const long long lab = kSoft ? -1 : label[r];
  int c0 = 0;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* y4 = reinterpret_cast<const float4*>(yr);
    float4* d4 = reinterpret_cast<float4*>(dr);
    const int v4 = v >> 2;
    for (int i = threadIdx.x; i < v4; i += kThreads) {
      const float4 xv = __ldcs(x4 + i);
      const float4 yv = kSoft ? __ldcs(y4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      const int c = i << 2;
      float4 o;
      o.x = grad_at<kSoft>(xv.x, yv.x, c, lab, s, a1, a2);
      o.y = grad_at<kSoft>(xv.y, yv.y, c + 1, lab, s, a1, a2);
      o.z = grad_at<kSoft>(xv.z, yv.z, c + 2, lab, s, a1, a2);
      o.w = grad_at<kSoft>(xv.w, yv.w, c + 3, lab, s, a1, a2);
      __stcs(d4 + i, o);
    }
    c0 = v4 << 2;
  }
  for (int c = c0 + threadIdx.x; c < v; c += kThreads) {
    const float yv = kSoft ? __ldcs(yr + c) : 0.f;
    __stcs(dr + c, grad_at<kSoft>(__ldcs(xr + c), yv, c, lab, s, a1, a2));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ULL) == 0;
}

}  // namespace

extern "C" {

// Forward.  x [r, v] float; soft: y [r, v] float, label unused; hard:
// label [r] int64, y unused.  Writes loss [r], lse [r] and, when soft,
// sum_y [r].  Launches on `stream`; returns cudaGetLastError() (0 = ok).
int pta_xent_fwd_f32(const void* x, const void* y, const void* label,
                     int soft, void* loss, void* lse, void* sum_y,
                     long long r, int v, long long ignore, void* stream) {
  if (r == 0) return 0;
  const bool vec = (v % 4 == 0) && aligned16(x) && (!soft || aligned16(y));
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const long long* lb = static_cast<const long long*>(label);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  float* sy = static_cast<float*>(sum_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)r);
  if (soft && vec)
    xent_fwd_kernel<true, true><<<grid, kThreads, 0, st>>>(xf, yf, lb, lo, ls, sy, v, ignore);
  else if (soft)
    xent_fwd_kernel<true, false><<<grid, kThreads, 0, st>>>(xf, yf, lb, lo, ls, sy, v, ignore);
  else if (vec)
    xent_fwd_kernel<false, true><<<grid, kThreads, 0, st>>>(xf, yf, lb, lo, ls, sy, v, ignore);
  else
    xent_fwd_kernel<false, false><<<grid, kThreads, 0, st>>>(xf, yf, lb, lo, ls, sy, v, ignore);
  return (int)cudaGetLastError();
}

// Backward.  As the forward, plus lse, g1, g2 [r]; writes dx [r, v].
int pta_xent_bwd_f32(const void* x, const void* y, const void* label,
                     int soft, const void* lse, const void* g1,
                     const void* g2, void* dx, long long r, int v,
                     void* stream) {
  if (r == 0) return 0;
  const bool vec = (v % 4 == 0) && aligned16(x) && aligned16(dx) &&
                   (!soft || aligned16(y));
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const long long* lb = static_cast<const long long*>(label);
  const float* ls = static_cast<const float*>(lse);
  const float* c1 = static_cast<const float*>(g1);
  const float* c2 = static_cast<const float*>(g2);
  float* d = static_cast<float*>(dx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)r);
  if (soft && vec)
    xent_bwd_kernel<true, true><<<grid, kThreads, 0, st>>>(xf, yf, lb, ls, c1, c2, d, v);
  else if (soft)
    xent_bwd_kernel<true, false><<<grid, kThreads, 0, st>>>(xf, yf, lb, ls, c1, c2, d, v);
  else if (vec)
    xent_bwd_kernel<false, true><<<grid, kThreads, 0, st>>>(xf, yf, lb, ls, c1, c2, d, v);
  else
    xent_bwd_kernel<false, false><<<grid, kThreads, 0, st>>>(xf, yf, lb, ls, c1, c2, d, v);
  return (int)cudaGetLastError();
}

const char* pta_xent_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
