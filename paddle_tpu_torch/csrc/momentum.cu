// Momentum update of a group of parameters, in place, in one launch, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_fused.py:_momentum_kernel
// (run there through _opt_sweep / fused_momentum, one sweep a parameter
// inside one XLA program).  For each parameter of n values, in the
// reference's order of operations:
//
//   v = mu * v + g
//   p = p - lr * v                      (plain)
//   p = p - (g + mu * v) * lr           (use_nesterov)
//
// Each entry's lr is a [1] device tensor read through its own pointer, so
// no step costs a host sync and a Program with per-parameter learning
// rates still groups; mu and the Nesterov flag are shared by the group.
//
// What bounds it: bytes.  It reads p, g, v and writes p, v: 20 bytes for 2
// to 4 flops a value.  What bounded the per-parameter launches was launch
// latency: most of ResNet-50's 161 parameters are batch-norm vectors of
// 64-2048 values, each a whole launch and a host round trip.  Design: one
// launch covers every entry of a table passed by value as the kernel's
// parameter (__grid_constant__, up to 32,764 bytes since CUDA 12.1; a
// larger group is split into launches of the same kernel).  Each tensor is
// cut into chunks of kChunk values; the table carries the prefix sum of
// the chunk counts and each block finds its (tensor, chunk) by a binary
// search over it.  A tensor whose n % 4 == 0 and whose pointers are all
// 16-byte aligned takes the float4 path, any other the scalar path,
// decided per entry; each thread keeps kUnroll float4 loads of each array
// in flight.  Every product and sum is rounded on its own (__fmul_rn, ...)
// in the order the plain PyTorch version evaluates, so the two agree to
// the bit on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// values a block updates: 25.6 M values (ResNet-50) make ~1,670 blocks,
// about 12 a streaming multiprocessor of 132, each thread 16 float4s
constexpr long long kChunk = 16384;
constexpr int kMaxEntries = 640;

struct Entry {
  float* p;
  const float* g;
  float* v;
  const float* lr;
  long long n;
};

struct Table {
  Entry e[kMaxEntries];
  int chunk_end[kMaxEntries];  // blocks of entries 0..i together
  unsigned char vec[kMaxEntries];
  int count;
  float mu;
};
static_assert(sizeof(Table) <= 32764,
              "a kernel's parameters may take at most 32,764 bytes");

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
__device__ __forceinline__ void step4(float4& p, const float4& g, float4& v,
                                      float lr, float mu) {
  step<kNesterov>(p.x, g.x, v.x, lr, mu);
  step<kNesterov>(p.y, g.y, v.y, lr, mu);
  step<kNesterov>(p.z, g.z, v.z, lr, mu);
  step<kNesterov>(p.w, g.w, v.w, lr, mu);
}

// The entry whose chunks hold block b: the first i with chunk_end[i] > b.
__device__ __forceinline__ int find_entry(const Table& t, int b) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.chunk_end[mid] > b) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Updates items [begin, end) of p, g, v (float or float4), kUnroll items a
// thread in flight.
template <bool kNesterov, typename T>
__device__ __forceinline__ void sweep(T* __restrict__ p,
                                      const T* __restrict__ g,
                                      T* __restrict__ v, long long begin,
                                      long long end, float lr, float mu) {
  for (long long base = begin + threadIdx.x; base < end;
       base += (long long)kThreads * kUnroll) {
    T pr[kUnroll], gr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = base + (long long)j * kThreads;
      if (i < end) {
        pr[j] = p[i];
        gr[j] = g[i];
        vr[j] = v[i];
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = base + (long long)j * kThreads;
      if (i < end) {
        if constexpr (sizeof(T) == sizeof(float4)) {
          step4<kNesterov>(pr[j], gr[j], vr[j], lr, mu);
        } else {
          step<kNesterov>(pr[j], gr[j], vr[j], lr, mu);
        }
        p[i] = pr[j];
        v[i] = vr[j];
      }
    }
  }
}

template <bool kNesterov>
__global__ void __launch_bounds__(kThreads)
momentum_group_kernel(const __grid_constant__ Table t) {
  const int k = find_entry(t, blockIdx.x);
  const Entry& e = t.e[k];
  const long long chunk = blockIdx.x - (k > 0 ? t.chunk_end[k - 1] : 0);
  const long long begin = chunk * kChunk;
  const long long end = begin + kChunk < e.n ? begin + kChunk : e.n;
  const float lr = *e.lr;
  if (t.vec[k]) {
    sweep<kNesterov>(reinterpret_cast<float4*>(e.p),
                     reinterpret_cast<const float4*>(e.g),
                     reinterpret_cast<float4*>(e.v), begin / 4, end / 4, lr,
                     t.mu);
  } else {
    sweep<kNesterov>(e.p, e.g, e.v, begin, end, lr, t.mu);
  }
}

bool aligned16(long long q) { return (q & 15LL) == 0; }

}  // namespace

extern "C" {

// Updates `count` parameters in place.  `cols` holds five columns of
// `count` values each: the addresses of p, g, v and lr ([1]), then n.
// Launches on `stream`, as few launches as the table's capacity allows;
// adds their number to *launches and returns cudaGetLastError() (0 = ok).
int pta_momentum_group_f32(const long long* cols, int count, float mu,
                           int nesterov, void* stream, int* launches) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Table t;
  for (int first = 0; first < count; first += kMaxEntries) {
    const int m = count - first < kMaxEntries ? count - first : kMaxEntries;
    long long blocks = 0;
    for (int i = 0; i < m; ++i) {
      const int r = first + i;
      const long long n = cols[4 * count + r];
      t.e[i] = Entry{reinterpret_cast<float*>(cols[r]),
                     reinterpret_cast<const float*>(cols[count + r]),
                     reinterpret_cast<float*>(cols[2 * count + r]),
                     reinterpret_cast<const float*>(cols[3 * count + r]), n};
      t.vec[i] = n % 4 == 0 && aligned16(cols[r]) &&
                 aligned16(cols[count + r]) && aligned16(cols[2 * count + r]);
      blocks += n > 0 ? (n + kChunk - 1) / kChunk : 0;
      t.chunk_end[i] = (int)blocks;
    }
    if (blocks == 0) continue;
    t.count = m;
    t.mu = mu;
    if (nesterov) {
      momentum_group_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(t);
    } else {
      momentum_group_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(t);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return 0;
}

const char* pta_momentum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
