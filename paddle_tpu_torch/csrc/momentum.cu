// Momentum update, in place, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_fused.py:_momentum_kernel
// (run there through _opt_sweep / fused_momentum).  For one parameter of n
// values, in the reference's order of operations:
//
//   v = mu * v + g
//   p = p - lr * v                      (plain)
//   p = p - (g + mu * v) * lr           (use_nesterov)
//
// lr is the [1] LearningRate device tensor, read through a pointer, so no
// step costs a host sync; mu and the Nesterov flag are launch arguments.
//
// What bounds it: bytes.  It reads p, g, v and writes p, v: 20 bytes for 2
// to 4 flops a value.  Design: one grid-stride launch per parameter, float4
// loads and stores when n % 4 == 0 and every pointer is 16-byte aligned, a
// scalar loop otherwise (the TPU kernel's lane-aligned [n/128, 128] view and
// its 2^17 ragged-size limit are VMEM constraints with no counterpart here,
// so every float32 parameter takes the kernel).  Every product and sum is
// rounded on its own (__fmul_rn, ...) in the order the plain PyTorch version
// evaluates, so the two agree to the bit on the card.  Most of ResNet-50's
// 161 parameters are small BN vectors whose update is set by launch latency,
// not bytes: a launch batched over parameters is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kNesterov>
__device__ __forceinline__ void step(float& p, float g, float& v, float lr,
                                     float mu) {
  v = __fadd_rn(__fmul_rn(mu, v), g);
  if (kNesterov) {
    p = __fsub_rn(p, __fmul_rn(__fadd_rn(g, __fmul_rn(mu, v)), lr));
  } else {
    p = __fsub_rn(p, __fmul_rn(lr, v));
  }
}

template <bool kNesterov>
__global__ void __launch_bounds__(kThreads)
momentum_vec_kernel(float4* __restrict__ p, const float4* __restrict__ g,
                    float4* __restrict__ v, const float* __restrict__ lr_ptr,
                    long long n4, float mu) {
  const float lr = *lr_ptr;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    float4 pv = p[i], vv = v[i];
    const float4 gv = g[i];
    step<kNesterov>(pv.x, gv.x, vv.x, lr, mu);
    step<kNesterov>(pv.y, gv.y, vv.y, lr, mu);
    step<kNesterov>(pv.z, gv.z, vv.z, lr, mu);
    step<kNesterov>(pv.w, gv.w, vv.w, lr, mu);
    p[i] = pv;
    v[i] = vv;
  }
}

template <bool kNesterov>
__global__ void __launch_bounds__(kThreads)
momentum_kernel(float* __restrict__ p, const float* __restrict__ g,
                float* __restrict__ v, const float* __restrict__ lr_ptr,
                long long n, float mu) {
  const float lr = *lr_ptr;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float pv = p[i], vv = v[i];
    step<kNesterov>(pv, g[i], vv, lr, mu);
    p[i] = pv;
    v[i] = vv;
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

template <bool kNesterov>
void launch(float* p, const float* g, float* v, const float* lr, long long n,
            float mu, cudaStream_t st) {
  if (n % 4 == 0 && aligned16(p) && aligned16(g) && aligned16(v)) {
    const long long n4 = n / 4;
    momentum_vec_kernel<kNesterov><<<blocks_for(n4), kThreads, 0, st>>>(
        reinterpret_cast<float4*>(p), reinterpret_cast<const float4*>(g),
        reinterpret_cast<float4*>(v), lr, n4, mu);
  } else {
    momentum_kernel<kNesterov><<<blocks_for(n), kThreads, 0, st>>>(
        p, g, v, lr, n, mu);
  }
}

}  // namespace

extern "C" {

// p and v are updated in place; g and lr [1] are read.  Launches on
// `stream`; returns cudaGetLastError() (0 = ok).
int pta_momentum_f32(void* p, const void* g, void* v, const void* lr,
                     long long n, float mu, int nesterov, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(p);
  const float* gp = static_cast<const float*>(g);
  float* vp = static_cast<float*>(v);
  const float* lp = static_cast<const float*>(lr);
  if (nesterov) {
    launch<true>(pp, gp, vp, lp, n, mu, st);
  } else {
    launch<false>(pp, gp, vp, lp, n, mu, st);
  }
  return (int)cudaGetLastError();
}

const char* pta_momentum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
