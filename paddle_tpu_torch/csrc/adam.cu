// Adam update of a group of parameters, in place, in one launch, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_fused.py:_adam_kernel (run
// there through _opt_sweep / fused_adam, one sweep a parameter inside one
// XLA program) and the scalar math the reference's adam op does around it
// (paddle_tpu/ops/optimizer_ops.py).  For each parameter of n values, with
// its own learning rate lr and beta pows b1p, b2p ([1] device tensors):
//
//   lr_eff = lr * sqrt(1 - b2p) / (1 - b1p)
//   m1 = b1 * m1 + (1 - b1) * g
//   m2 = b2 * m2 + (1 - b2) * g * g
//   p  = p - lr_eff * m1 / (sqrt(m2) + eps)
//   b1p = b1p * b1,  b2p = b2p * b2            (after the sweep)
//
// All of it reads device tensors through pointers, so no step costs a host
// sync; b1, b2 and eps are shared by the group.
//
// What bounds it: bytes.  It reads p, g, m1, m2 and writes p, m1, m2: 28
// bytes for ~12 flops a value.  What bounded the per-parameter launches
// was launch latency: the layer-norm and bias vectors of 512-2048 values
// each took a whole launch, and the op added 7 small torch launches a
// parameter for lr_eff and the pows.  Design: one launch covers every
// entry of a table passed by value as the kernel's parameter
// (__grid_constant__, up to 32,764 bytes since CUDA 12.1; a larger group
// is split into launches of the same kernel).  Each tensor is cut into
// chunks of kChunk values; the table carries the prefix sum of the chunk
// counts and each block finds its (tensor, chunk) by a binary search over
// it.  A tensor whose n % 4 == 0 and whose pointers are all 16-byte
// aligned takes the float4 path, any other the scalar path, decided per
// entry; each thread keeps kUnroll float4 loads of each array in flight.
// Every block computes lr_eff from its entry's pointers.
//
// The beta pows: every block of a tensor reads b1p and b2p, so none may
// overwrite them while another may still read them.  The last block of a
// tensor to finish writes them (an atomic count of finished blocks per
// entry, reset to 0 by that last block, so the counters are zero again for
// the next launch on the stream); a tensor of one chunk skips the count.
// That keeps the group at one launch; a second launch over the table would
// cost a launch latency and a second table copy for 2 x 4 bytes a tensor.
//
// Every product, sum, quotient and root is rounded on its own (__fmul_rn,
// ..., __fsqrt_rn) in the order the plain PyTorch version evaluates, so
// the two agree to the bit on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// values a block updates: 90.2 M values (Transformer-base) make ~5,600
// blocks, each thread 16 float4s of each array
constexpr long long kChunk = 16384;
constexpr int kMaxEntries = 448;

struct Entry {
  float* p;
  const float* g;
  float* m1;
  float* m2;
  const float* lr;
  float* b1p;
  float* b2p;
  long long n;
};

struct Table {
  Entry e[kMaxEntries];
  int chunk_end[kMaxEntries];  // blocks of entries 0..i together
  unsigned char vec[kMaxEntries];
  int* done;  // finished blocks per entry; zero between launches
  int count;
  float b1, omb1, b2, omb2, eps;
};
static_assert(sizeof(Table) <= 32764,
              "a kernel's parameters may take at most 32,764 bytes");

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

__device__ __forceinline__ void step(float4& p, const float4& g, float4& m1,
                                     float4& m2, float lr, const Coef& c) {
  step(p.x, g.x, m1.x, m2.x, lr, c);
  step(p.y, g.y, m1.y, m2.y, lr, c);
  step(p.z, g.z, m1.z, m2.z, lr, c);
  step(p.w, g.w, m1.w, m2.w, lr, c);
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

// Updates items [begin, end) of p, g, m1, m2 (float or float4), kUnroll
// items a thread in flight.
template <typename T>
__device__ __forceinline__ void sweep(T* __restrict__ p,
                                      const T* __restrict__ g,
                                      T* __restrict__ m1, T* __restrict__ m2,
                                      long long begin, long long end,
                                      float lr, const Coef& c) {
  for (long long base = begin + threadIdx.x; base < end;
       base += (long long)kThreads * kUnroll) {
    T pr[kUnroll], gr[kUnroll], ar[kUnroll], br[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = base + (long long)j * kThreads;
      if (i < end) {
        pr[j] = p[i];
        gr[j] = g[i];
        ar[j] = m1[i];
        br[j] = m2[i];
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = base + (long long)j * kThreads;
      if (i < end) {
        step(pr[j], gr[j], ar[j], br[j], lr, c);
        p[i] = pr[j];
        m1[i] = ar[j];
        m2[i] = br[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
adam_group_kernel(const __grid_constant__ Table t) {
  const int k = find_entry(t, blockIdx.x);
  const Entry& e = t.e[k];
  const int first_block = k > 0 ? t.chunk_end[k - 1] : 0;
  const long long begin = (long long)(blockIdx.x - first_block) * kChunk;
  const long long end = begin + kChunk < e.n ? begin + kChunk : e.n;
  const float b1p = *e.b1p, b2p = *e.b2p;
  // lr * sqrt(1 - b2p) / (1 - b1p), as the op evaluates it
  const float lr = __fdiv_rn(
      __fmul_rn(*e.lr, __fsqrt_rn(__fsub_rn(1.0f, b2p))),
      __fsub_rn(1.0f, b1p));
  const Coef c{t.b1, t.omb1, t.b2, t.omb2, t.eps};
  if (t.vec[k]) {
    sweep(reinterpret_cast<float4*>(e.p),
          reinterpret_cast<const float4*>(e.g),
          reinterpret_cast<float4*>(e.m1), reinterpret_cast<float4*>(e.m2),
          begin / 4, end / 4, lr, c);
  } else {
    sweep(e.p, e.g, e.m1, e.m2, begin, end, lr, c);
  }
  // every thread of this block has read b1p and b2p; the last block of
  // the entry to get here writes the new pows
  __syncthreads();
  if (threadIdx.x == 0) {
    const int blocks = t.chunk_end[k] - first_block;
    bool last = blocks == 1;
    if (!last) {
      __threadfence();
      last = atomicAdd(&t.done[k], 1) == blocks - 1;
      if (last) t.done[k] = 0;
    }
    if (last) {
      *e.b1p = __fmul_rn(b1p, t.b1);
      *e.b2p = __fmul_rn(b2p, t.b2);
    }
  }
}

bool aligned16(long long q) { return (q & 15LL) == 0; }

}  // namespace

extern "C" {

// Capacity of one launch's table: the `done` counters must hold this many.
int pta_adam_group_capacity() { return kMaxEntries; }

// Updates `count` parameters in place.  `cols` holds eight columns of
// `count` values each: the addresses of p, g, m1, m2, lr, b1p and b2p (the
// last three [1]), then n.  `done` points at pta_adam_group_capacity()
// zeroed ints on the device.  omb1 and omb2 are (1 - b1) and (1 - b2)
// rounded to float by the caller.  Launches on `stream`, as few launches
// as the table's capacity allows; adds their number to *launches and
// returns cudaGetLastError() (0 = ok).
int pta_adam_group_f32(const long long* cols, int count, void* done, float b1,
                       float omb1, float b2, float omb2, float eps,
                       void* stream, int* launches) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Table t;
  t.done = static_cast<int*>(done);
  t.b1 = b1;
  t.omb1 = omb1;
  t.b2 = b2;
  t.omb2 = omb2;
  t.eps = eps;
  for (int first = 0; first < count; first += kMaxEntries) {
    const int m = count - first < kMaxEntries ? count - first : kMaxEntries;
    long long blocks = 0;
    for (int i = 0; i < m; ++i) {
      const int r = first + i;
      const long long* c = cols + r;
      const long long n = c[7 * count];
      t.e[i] = Entry{reinterpret_cast<float*>(c[0]),
                     reinterpret_cast<const float*>(c[count]),
                     reinterpret_cast<float*>(c[2 * count]),
                     reinterpret_cast<float*>(c[3 * count]),
                     reinterpret_cast<const float*>(c[4 * count]),
                     reinterpret_cast<float*>(c[5 * count]),
                     reinterpret_cast<float*>(c[6 * count]), n};
      t.vec[i] = n % 4 == 0 && aligned16(c[0]) && aligned16(c[count]) &&
                 aligned16(c[2 * count]) && aligned16(c[3 * count]);
      // at least one block a tensor: an empty one still moves its pows
      blocks += n > 0 ? (n + kChunk - 1) / kChunk : 1;
      t.chunk_end[i] = (int)blocks;
    }
    t.count = m;
    adam_group_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return 0;
}

const char* pta_adam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
