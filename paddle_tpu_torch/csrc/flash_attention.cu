// Flash attention for Hopper (sm_90a), float32: the forward, dQ and dK/dV
// kernels of the training path.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_flash.py:
//   flash_fwd_kernel  <- _flash_kernel (via _flash_forward)
//   flash_dq_kernel   <- _dq_kernel    (via _flash_backward)
//   flash_dkv_kernel  <- _dkv_kernel   (via _flash_backward)
//
// q [B*H, Tq, D], k/v [B*H, Tk, D], an optional key-padding bias [B, Tk]
// (row b serves the H heads of batch b), lse/delta [B*H, Tq]:
//
//   forward:  S = (scale*q) k^T + bias, -1e30 where query < key (causal,
//             top-left aligned); online softmax over k tiles with running
//             (m, l, acc); out = acc / max(l, 1e-30), lse = m + log(l).
//   dQ:       P = exp(scale*q k^T + bias - lse), dS = P * (dO v^T - delta),
//             dq = scale * dS k.
//   dK/dV:    dv = P^T dO, dk = scale * dS^T q.
//
// delta = rowsum(dO * out) comes from the caller, as the reference leaves it
// to XLA (:307).  The bias gets no gradient.
//
// What bounds them: operations.  One (query, key) pair costs 2*D FMAs in
// the forward (q.k and p.v), 3*D in dQ and 4*D in dK/dV, against 4 * 4 * D
// bytes of q, k, v, out read once: at B*H = 512, T = 256, D = 64 the forward
// is 8.6 GFLOP over 134 MB, ~64 flops per byte, far above the H100's ~20
// fp32 flops per byte.  So the least time is the FMAs over the 67 TFLOP/s of
// the CUDA cores (fp32, no TF32: the training path is full float32).
//
// Design.  The Pallas grid carries (m, l, acc) in VMEM scratch across a
// sequential k axis; Hopper's blocks run in parallel and in no order, so a
// loop inside one block takes its place:
//   - forward and dQ: one block per (b*h, 64-row q tile); the q tile (and
//     dO) stay in shared memory while 64-row k/v tiles stream through it;
//   - dK/dV: one block per (b*h, 64-row k tile); q, dO, lse and delta tiles
//     stream.
// 256 threads as 16 x 16: thread (ty, tx) owns tile rows ty + 16 i and
// columns tx + 16 j (i, j < 4) of a 64 x 64 score tile, computed as 4 x 4
// register outer products over float4 reads along D.  The tile's
// probabilities go through shared memory for the second product (P v,
// dS k, P^T dO, dS^T q), where the thread owns rows ty + 16 i and D/16
// columns.  A row's max and sum are shuffles within the 16 lanes that share
// it.  Rows are padded to D + 4 floats: 16-byte aligned, and the float4
// reads of 8 neighbouring rows fall into distinct banks.  At B*H = 512,
// T = 256 that is 2,048 blocks over 132 SMs.
//
// Dead causal tiles are skipped (the reference's `live`, :80, :131, :180).
// The ragged edge of Tq and Tk is masked here (rows past the end load as
// zeros, keys past the end get weight 0), so any Tq, Tk >= 1 works, with no
// power-of-two block halving.  Every sum has a fixed order and there are no
// atomics, so two launches are bitwise equal.  All arithmetic is fp32 FMA on
// the CUDA cores; wgmma, TMA and bf16 tensor-core tiles are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kLdP = kTile + 4;  // row stride of a 64 x 64 score tile
constexpr float kNegInf = -1e30f;

template <int D>
struct Cfg {
  static constexpr int kLd = D + 4;                 // row stride of a [64, D] tile
  static constexpr int kVw = D >= 64 ? 4 : D / 16;  // floats per vector read
  static constexpr int kGroups = D / (16 * kVw);    // vectors a thread owns in a row
  static constexpr int kCols = D / 16;              // columns a thread owns in a row
};

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

// Column of a thread's e-th owned value in a row of a [64, D] tile.
template <int D>
__device__ __forceinline__ int own_col(int tx, int e) {
  constexpr int VW = Cfg<D>::kVw;
  return (e / VW) * 16 * VW + tx * VW + (e % VW);
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst [64, D] (stride kLd) <- mul * src rows [0, n_valid) (stride D); rows
// past n_valid are zeros.
template <int D>
__device__ void load_tile(float* dst, const float* __restrict__ src, int n_valid,
                          float mul) {
  constexpr int kV = D / 4;
  for (int i = threadIdx.x; i < kTile * kV; i += kThreads) {
    const int r = i / kV, c = i % kV;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) {
      x = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * D) + c);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * Cfg<D>::kLd + c * 4) = x;
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d], d in order.
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* B, int ty,
                                         int tx, float s[4][4]) {
  constexpr int LD = Cfg<D>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// acc[i][e] += sum_c P[ty + 16 i][c] * X[c][own_col(tx, e)], c in order;
// P is a 64 x 64 tile (stride kLdP), X a [64, D] tile.
template <int D>
__device__ __forceinline__ void acc_tile(const float* P, const float* X, int ty,
                                         int tx, float acc[4][D / 16]) {
  constexpr int LD = Cfg<D>::kLd, VW = Cfg<D>::kVw, G = Cfg<D>::kGroups;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * kLdP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float x[G * VW];
#pragma unroll
      for (int g = 0; g < G; ++g)
        load_vec<VW>(X + (c + cc) * LD + g * 16 * VW + tx * VW, x + g * VW);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = comp(p[i], cc);
#pragma unroll
        for (int e = 0; e < G * VW; ++e) acc[i][e] = fmaf(pv, x[e], acc[i][e]);
      }
    }
  }
}

// rows [row0, row0 + 64) of out [rows, D] <- mul * acc, rows < n_rows only.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float acc[4][D / 16], int row0,
                                           int n_rows, int ty, int tx, float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int e = 0; e < D / 16; ++e)
      out[(size_t)r * D + own_col<D>(tx, e)] = mul * acc[i][e];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int H, int Tq,
                 int Tk, float scale, int causal, int n_qt) {
  constexpr int LD = Cfg<D>::kLd, NC = Cfg<D>::kCols;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [64, LD] scale * q
  float* Ks = Qs + kTile * LD;   // [64, LD]
  float* Vs = Ks + kTile * LD;   // [64, LD]
  float* Ps = Vs + kTile * LD;   // [64, kLdP] probabilities of the tile
  const int bh = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  const float* bb = bias ? bias + (size_t)(bh / H) * Tk : nullptr;
  load_tile<D>(Qs, q + ((size_t)bh * Tq + q0) * D, min(kTile, Tq - q0), scale);

  float m[4], l[4], o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NC; ++e) o[i][e] = 0.f;
  }
  // causal: key tiles past the q tile's last row are dead
  const int k_end = causal ? min(Tk, q0 + kTile) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's K, V and P are read
    const int nk = min(kTile, Tk - k0);
    load_tile<D>(Ks, kb + (size_t)k0 * D, nk, 1.f);
    load_tile<D>(Vs, vb + (size_t)k0 * D, nk, 1.f);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = -INFINITY;  // keys past Tk: weight exactly 0
        if (col < Tk) {
          x = s[i][j];
          if (bb) x += bb[col];
          if (causal && row < col) x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NC; ++e) o[i][e] *= corr;
    }
    __syncthreads();
    acc_tile<D>(Ps, Vs, ty, tx, o);
  }

  float* ob = out + (size_t)bh * Tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float lf = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < NC; ++e)
      ob[(size_t)row * D + own_col<D>(tx, e)] = o[i][e] / lf;
    if (tx == 0) lse[(size_t)bh * Tq + row] = m[i] + logf(lf);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq, int H,
                int Tq, int Tk, float scale, int causal, int n_qt) {
  constexpr int LD = Cfg<D>::kLd, NC = Cfg<D>::kCols;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [64, LD]
  float* dOs = Qs + kTile * LD;  // [64, LD]
  float* Ks = dOs + kTile * LD;  // [64, LD]
  float* Vs = Ks + kTile * LD;   // [64, LD]
  float* dSs = Vs + kTile * LD;  // [64, kLdP]
  const int bh = blockIdx.x / n_qt, q0 = (blockIdx.x % n_qt) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = min(kTile, Tq - q0);
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  const float* bb = bias ? bias + (size_t)(bh / H) * Tk : nullptr;
  load_tile<D>(Qs, q + ((size_t)bh * Tq + q0) * D, nq, 1.f);
  load_tile<D>(dOs, dout + ((size_t)bh * Tq + q0) * D, nq, 1.f);

  float lse_r[4], delta_r[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    lse_r[i] = r < nq ? lse[(size_t)bh * Tq + q0 + r] : 0.f;
    delta_r[i] = r < nq ? delta[(size_t)bh * Tq + q0 + r] : 0.f;
#pragma unroll
    for (int e = 0; e < NC; ++e) acc[i][e] = 0.f;
  }
  const int k_end = causal ? min(Tk, q0 + kTile) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    const int nk = min(kTile, Tk - k0);
    load_tile<D>(Ks, kb + (size_t)k0 * D, nk, 1.f);
    load_tile<D>(Vs, vb + (size_t)k0 * D, nk, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(Qs, Ks, ty, tx, s);
    dot_tile<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float p = 0.f;
        if (col < Tk) {
          float x = s[i][j] * scale;
          if (bb) x += bb[col];
          if (causal && row < col) x = kNegInf;
          p = expf(x - lse_r[i]);
        }
        dSs[(ty + 16 * i) * kLdP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    acc_tile<D>(dSs, Ks, ty, tx, acc);
  }
  store_rows<D>(dq + (size_t)bh * Tq * D, acc, q0, Tq, ty, tx, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int H, int Tq, int Tk, float scale,
                 int causal, int n_kt) {
  constexpr int LD = Cfg<D>::kLd, NC = Cfg<D>::kCols;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // [64, LD]
  float* Vs = Ks + kTile * LD;    // [64, LD]
  float* Qs = Vs + kTile * LD;    // [64, LD]
  float* dOs = Qs + kTile * LD;   // [64, LD]
  float* Pt = dOs + kTile * LD;   // [64, kLdP] P^T: rows keys, columns queries
  float* dSt = Pt + kTile * kLdP; // [64, kLdP] dS^T
  float* lse_s = dSt + kTile * kLdP;  // [64]
  float* delta_s = lse_s + kTile;     // [64]
  const int bh = blockIdx.x / n_kt, k0 = (blockIdx.x % n_kt) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qb = q + (size_t)bh * Tq * D;
  const float* ob = dout + (size_t)bh * Tq * D;
  const float* bb = bias ? bias + (size_t)(bh / H) * Tk : nullptr;
  load_tile<D>(Ks, k + ((size_t)bh * Tk + k0) * D, min(kTile, Tk - k0), 1.f);
  load_tile<D>(Vs, v + ((size_t)bh * Tk + k0) * D, min(kTile, Tk - k0), 1.f);

  float bias_c[4], dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + ty + 16 * i;
    bias_c[i] = (bb && col < Tk) ? bb[col] : 0.f;
#pragma unroll
    for (int e = 0; e < NC; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  }
  // causal: query tiles whose last row is above this tile's first key are dead
  for (int q0 = causal ? k0 : 0; q0 < Tq; q0 += kTile) {
    __syncthreads();
    const int nq = min(kTile, Tq - q0);
    load_tile<D>(Qs, qb + (size_t)q0 * D, nq, 1.f);
    load_tile<D>(dOs, ob + (size_t)q0 * D, nq, 1.f);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      lse_s[r] = r < nq ? lse[(size_t)bh * Tq + q0 + r] : 0.f;
      delta_s[r] = r < nq ? delta[(size_t)bh * Tq + q0 + r] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    dot_tile<D>(Ks, Qs, ty, tx, st);   // rows keys, columns queries
    dot_tile<D>(Vs, dOs, ty, tx, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, row = q0 + r;
        float p = 0.f;
        if (row < Tq && col < Tk) {
          float x = st[i][j] * scale;
          if (bb) x += bias_c[i];
          if (causal && row < col) x = kNegInf;
          p = expf(x - lse_s[r]);
        }
        Pt[(ty + 16 * i) * kLdP + r] = p;
        dSt[(ty + 16 * i) * kLdP + r] = p * (dpt[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
    acc_tile<D>(Pt, dOs, ty, tx, dv_acc);
    acc_tile<D>(dSt, Qs, ty, tx, dk_acc);
  }
  store_rows<D>(dk + (size_t)bh * Tk * D, dk_acc, k0, Tk, ty, tx, scale);
  store_rows<D>(dv + (size_t)bh * Tk * D, dv_acc, k0, Tk, ty, tx, 1.f);
}

template <int D>
constexpr size_t tile_bytes() {
  return (size_t)kTile * Cfg<D>::kLd * sizeof(float);
}
constexpr size_t kScoreBytes = (size_t)kTile * kLdP * sizeof(float);

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct Dims {
  int B, H, Tq, Tk;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias,
               void* out, void* lse, const Dims& d) {
  const size_t smem = 3 * tile_bytes<D>() + kScoreBytes;
  cudaError_t e = allow_smem(flash_fwd_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (d.Tq + kTile - 1) / kTile;
  flash_fwd_kernel<D><<<(unsigned)((long long)d.B * d.H * n_qt), kThreads, smem,
                        d.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(out), static_cast<float*>(lse), d.H, d.Tq, d.Tk,
      d.scale, d.causal, n_qt);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* bias,
              const void* dout, const void* lse, const void* delta, void* dq,
              const Dims& d) {
  const size_t smem = 4 * tile_bytes<D>() + kScoreBytes;
  cudaError_t e = allow_smem(flash_dq_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (d.Tq + kTile - 1) / kTile;
  flash_dq_kernel<D><<<(unsigned)((long long)d.B * d.H * n_qt), kThreads, smem,
                       d.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), d.H, d.Tq,
      d.Tk, d.scale, d.causal, n_qt);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias,
               const void* dout, const void* lse, const void* delta, void* dk,
               void* dv, const Dims& d) {
  const size_t smem = 4 * tile_bytes<D>() + 2 * kScoreBytes +
                      2 * kTile * sizeof(float);
  cudaError_t e = allow_smem(flash_dkv_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_kt = (d.Tk + kTile - 1) / kTile;
  flash_dkv_kernel<D><<<(unsigned)((long long)d.B * d.H * n_kt), kThreads, smem,
                        d.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), d.H, d.Tq, d.Tk, d.scale, d.causal, n_kt);
  return (int)cudaGetLastError();
}

}  // namespace

#define PTA_FLASH_DISPATCH(D_, CALL) \
  switch (D_) {                      \
    case 16: return CALL(16);        \
    case 32: return CALL(32);        \
    case 64: return CALL(64);        \
    case 128: return CALL(128);      \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
// Device pointers, all float32, contiguous and 16-byte aligned: q, dout,
// out, dq [B*H, Tq, D]; k, v, dk, dv [B*H, Tk, D]; lse, delta [B*H, Tq];
// bias [B, Tk] or null.  D is 16, 32, 64 or 128; Tq, Tk >= 1.

int pta_flash_fwd_f32(const void* q, const void* k, const void* v,
                      const void* bias, void* out, void* lse, int B, int H,
                      int Tq, int Tk, int D, float scale, int causal,
                      void* stream) {
  if ((long long)B * H * Tq == 0) return 0;
  const Dims d{B, H, Tq, Tk, scale, causal, (cudaStream_t)stream};
#define PTA_CALL(N) launch_fwd<N>(q, k, v, bias, out, lse, d)
  PTA_FLASH_DISPATCH(D, PTA_CALL)
#undef PTA_CALL
}

int pta_flash_dq_f32(const void* q, const void* k, const void* v,
                     const void* bias, const void* dout, const void* lse,
                     const void* delta, void* dq, int B, int H, int Tq, int Tk,
                     int D, float scale, int causal, void* stream) {
  if ((long long)B * H * Tq == 0) return 0;
  const Dims d{B, H, Tq, Tk, scale, causal, (cudaStream_t)stream};
#define PTA_CALL(N) launch_dq<N>(q, k, v, bias, dout, lse, delta, dq, d)
  PTA_FLASH_DISPATCH(D, PTA_CALL)
#undef PTA_CALL
}

int pta_flash_dkv_f32(const void* q, const void* k, const void* v,
                      const void* bias, const void* dout, const void* lse,
                      const void* delta, void* dk, void* dv, int B, int H,
                      int Tq, int Tk, int D, float scale, int causal,
                      void* stream) {
  if ((long long)B * H * Tk == 0) return 0;
  const Dims d{B, H, Tq, Tk, scale, causal, (cudaStream_t)stream};
#define PTA_CALL(N) launch_dkv<N>(q, k, v, bias, dout, lse, delta, dk, dv, d)
  PTA_FLASH_DISPATCH(D, PTA_CALL)
#undef PTA_CALL
}

const char* pta_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
