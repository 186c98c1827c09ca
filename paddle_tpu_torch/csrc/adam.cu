// Adam update, in place, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_fused.py:_adam_kernel (run
// there through _opt_sweep / fused_adam).  For one parameter of n values:
//
//   m1 = b1 * m1 + (1 - b1) * g
//   m2 = b2 * m2 + (1 - b2) * g * g
//   p  = p - lr_eff * m1 / (sqrt(m2) + eps)
//
// lr_eff = lr * sqrt(1 - b2^t) / (1 - b1^t) is a [1] device tensor the
// wrapper computes; the kernel reads it through a pointer, so no step costs
// a host sync.
//
// What bounds it: bytes.  It reads p, g, m1, m2 and writes p, m1, m2: 28
// bytes for ~12 flops a value.  Design: one grid-stride launch per
// parameter, float4 loads and stores when n % 4 == 0 and every pointer is
// 16-byte aligned, a scalar loop otherwise (the TPU kernel's lane-aligned
// view and its ragged-size limit are VMEM constraints with no counterpart
// here).  Every product and sum is rounded on its own (__fmul_rn, ...) in
// the order the plain PyTorch version evaluates, so the two agree to the
// bit on the card.  The small layer-norm and bias vectors are set by
// launch latency, not bytes: a launch batched over parameters is later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Coef {
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void step(float& p, float g, float& m1, float& m2,
                                     float lr, const Coef& c) {
  m1 = __fadd_rn(__fmul_rn(c.b1, m1), __fmul_rn(c.omb1, g));
  m2 = __fadd_rn(__fmul_rn(c.b2, m2), __fmul_rn(__fmul_rn(c.omb2, g), g));
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, m1),
                             __fadd_rn(__fsqrt_rn(m2), c.eps)));
}

__global__ void __launch_bounds__(kThreads)
adam_vec_kernel(float4* __restrict__ p, const float4* __restrict__ g,
                float4* __restrict__ m1, float4* __restrict__ m2,
                const float* __restrict__ lr_eff, long long n4, Coef c) {
  const float lr = *lr_eff;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    float4 pv = p[i], a = m1[i], b = m2[i];
    const float4 gv = g[i];
    step(pv.x, gv.x, a.x, b.x, lr, c);
    step(pv.y, gv.y, a.y, b.y, lr, c);
    step(pv.z, gv.z, a.z, b.z, lr, c);
    step(pv.w, gv.w, a.w, b.w, lr, c);
    p[i] = pv;
    m1[i] = a;
    m2[i] = b;
  }
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m1, float* __restrict__ m2,
            const float* __restrict__ lr_eff, long long n, Coef c) {
  const float lr = *lr_eff;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float pv = p[i], a = m1[i], b = m2[i];
    step(pv, g[i], a, b, lr, c);
    p[i] = pv;
    m1[i] = a;
    m2[i] = b;
  }
}

bool aligned16(const void* q) {
  return (reinterpret_cast<unsigned long long>(q) & 15ULL) == 0;
}

// Enough blocks to fill the card (132 SMs x 8 resident blocks of 256
// threads), fewer when the tensor is small.
unsigned blocks_for(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  return (unsigned)(want < 1 ? 1 : (want > 1056 ? 1056 : want));
}

}  // namespace

extern "C" {

// p, m1, m2 are updated in place; g and lr_eff [1] are read.  omb1 and omb2
// are (1 - b1) and (1 - b2) rounded to float by the caller.  Launches on
// `stream`; returns cudaGetLastError() (0 = ok).
int pta_adam_f32(void* p, const void* g, void* m1, void* m2,
                 const void* lr_eff, long long n, float b1, float omb1,
                 float b2, float omb2, float eps, void* stream) {
  if (n == 0) return 0;
  const Coef c{b1, omb1, b2, omb2, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lr = static_cast<const float*>(lr_eff);
  if (n % 4 == 0 && aligned16(p) && aligned16(g) && aligned16(m1) &&
      aligned16(m2)) {
    const long long n4 = n / 4;
    adam_vec_kernel<<<blocks_for(n4), kThreads, 0, st>>>(
        static_cast<float4*>(p), static_cast<const float4*>(g),
        static_cast<float4*>(m1), static_cast<float4*>(m2), lr, n4, c);
  } else {
    adam_kernel<<<blocks_for(n), kThreads, 0, st>>>(
        static_cast<float*>(p), static_cast<const float*>(g),
        static_cast<float*>(m1), static_cast<float*>(m2), lr, n, c);
  }
  return (int)cudaGetLastError();
}

const char* pta_adam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
