// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV kernels of
// the training path, for float32, bfloat16 and float16 inputs.
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
// What bounds them in fp32: operations.  One (query, key) pair costs 2*D
// FMAs in the forward (q.k and p.v), 3*D in dQ (q.k, dO.v, dS.k) and 4*D in
// dK/dV, against 4 * 4 * D bytes of q, k, v, out read once: at B*H = 512,
// T = 256, D = 64 the forward is 8.6 GFLOP over 134 MB, ~64 flops per byte.
// In the main path's padding case (B 64, H 8, T 256, D 64; 25.3 M live
// pairs a call):
//   - on the CUDA cores (fp32 FMA, 67 TFLOP/s) the least time is 0.098 ms
//     for the forward, 0.147 ms for dQ and 0.195 ms for dK/dV;
//   - on the tensor cores, three TF32 products per fp32 product (below) at
//     495 TFLOP/s plus 4 CUDA-core flops a live pair: 0.041 ms for the
//     forward (its bytes over 3.35 TB/s: 0.040 ms), 0.061 ms for dQ and
//     0.080 ms for dK/dV (bytes 0.060 ms).
//
// All three: fp32 on the tensor cores by 3xTF32.  Each fp32 operand x is
// split as big = tf32(x) (round to nearest), small = x - big, and a
// product a b is small_a big_b + big_a small_b + big_a big_b, three
// mma.sync.m16n8k8 TF32 products: ~2^-21 relative per product against
// plain TF32's 2^-11.  The tensor core truncates its fp32 sums, so each k
// step (8 products) goes into a fresh accumulator that is added to the
// running sum rounded to nearest (mma3): summed along a 256-long row, the
// truncations alone reached 1e-5 of dK.  The kernels so keep the fp32 plain
// versions' tolerance, though no output is bitwise equal to its plain
// version (tests/test_torch_flash_tf32.py emulates the scheme on the CPU).
// mma.sync rather than wgmma: TF32 wgmma reads B K-major from shared
// memory, and the B operand of P V (and of dS k, P^T dO, dS^T q) is
// N-major as stored; mma.sync fragments load at any stride.  4 warps a
// block, each owning 16 rows of the score tile:
//   - forward: a block per (b*h, 64 query rows); the q tile stays in shared
//     memory, 32-key K/V tiles (16 at D = 128) are double-buffered by
//     cp.async, so tile k+1 is in flight while tile k is computed; S stays
//     in the accumulators, a row's max and sum are shuffles within the 4
//     lanes of a quad, and the accumulators are, unchanged, the A fragment
//     of P V (the k positions stand for keys 8j + 2t and 8j + 2t + 1); out
//     and lse are written once;
//   - dQ: the forward's blocks, tile order and K/V stages (bias with them);
//     q and dO stay in shared memory, each lane holds its two rows' lse and
//     delta; per tile S = q k^T and dP = dO v^T in registers, P and dS =
//     P (dP - delta) formed there, and dS, unchanged, the A fragment of
//     dS k.  k is the B operand of q k^T (read along d) and the X of dS k
//     (read along rows): every tile at stride D + 4, where both reads are
//     free of bank conflicts.  dq is written once, scaled;
//   - dK/dV: a block per (b*h, 64 keys), the K/V tile in shared memory; q,
//     dO, lse and delta tiles of 32 queries (16 at D = 128) stream through
//     a double buffer; S^T and dP^T in registers, P^T and dS^T the A
//     operands of P^T dO and dS^T q; dK and dV accumulate in registers and
//     are written once, dK scaled.  At D = 128 the two accumulators do not
//     fit the registers together, so dV and then dK take a sweep each over
//     the queries (S^T computed twice).
// This takes the CUDA cores' shared-memory cap off the products (a 4 x 4
// register tile reads 2 floats of shared memory per FMA, and an SM
// delivers 32 floats a clock against 128 FMAs) and lets copies overlap
// compute.  What bounds them now is the issue of the split, the 3 mma and
// the add per k step at 2 blocks (8 warps) an SM: the registers (190-245 a
// thread at D = 64) allow no more without spills.
//
// bf16 and fp16 (the reference's other two input dtypes, _FUSABLE_DTYPES of
// pallas_fused.py:60): the same three kernels, templated on the element
// type T, with the same blocks, tiles, stages, tile order and causal
// skipping.  As in the reference (:84-86, :135-138, :184-187) every value
// is widened to fp32, every sum is fp32, P and dS stay fp32 (:97-103,
// :146-153, :199-209), out, dq, dk and dv are rounded once to T, and lse is
// fp32:
//   - products of two input tensors (q k^T, dO v^T; k q^T, v dO^T in dK/dV)
//     are one mma.sync.m16n8k16 in T a 16-wide k step (dot_rows): the
//     products of two 8-bit (bf16) or 11-bit (fp16) mantissas are exact in
//     fp32, so only the order of the sums differs from the reference.
//     scale multiplies the fp32 scores after the product (the reference's
//     forward scales q in fp32 first: one fp32 rounding apart);
//   - products with P or dS (P v, P^T dO, dS k, dS^T q) take the TF32
//     route: P (dS) is split into big + small TF32 parts as in 3xTF32, and
//     the other operand, a bf16 or fp16 value, is exact in TF32 (8 or 11 of
//     TF32's 11 mantissa bits, fp32's exponents), so two TF32 products
//     (mma2) keep ~21 bits of P.  Rounding P to T, FlashAttention-2's usual
//     move, would put up to 2^-9 max|v| of error into out where the
//     reference has none.  A hi + lo split of P in T would keep 16 bits
//     at the bf16 rate, but in fp16 a dS under the loss scaler (up to 2^24)
//     can pass fp16's 65504 where the reference's fp32 does not; TF32 has
//     fp32's range, and the fp32 kernels' fragment code (acc_rows, the
//     split, the fresh accumulator a k step) serves as it is.  An overflow
//     that the reference does produce (dq past fp16's range) still rounds
//     to inf when dq is written;
//   - tiles lie in shared memory as T at a stride of D + 8 elements, where
//     a row's 32-bit words fall 4 banks apart, so the fragment reads along
//     d (dot_rows) and the row reads of acc_rows are free of conflicts;
//   - the bias is fp32 or T, widened as it is read.
// What bounds them in bf16: bytes.  At the main shape the reference's
// products at the bf16 tensor-core rate take 0.009 ms (forward), 0.013 (dQ)
// and 0.017 (dK/dV) against 0.020, 0.025 and 0.030 ms of bytes.
//
// Dead causal tiles are skipped (the reference's `live`, :80, :131, :180),
// and in dQ also a warp's tiles that lie wholly above its rows.  The
// ragged edge of Tq and Tk is masked here (rows past the end load as
// zeros, keys past the end get weight 0), so any Tq, Tk >= 1 works, with no
// power-of-two block halving.  Every sum has a fixed order and there are no
// atomics, so two launches are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

template <typename T>
constexpr bool kIsF32 = std::is_same_v<T, float>;

// The low-precision element types, two to a 32-bit word: widened to fp32
// exactly, rounded from it to nearest, and their m16n8k16 product (fp32
// sums).  In an m16n8k16 fragment lane = 4 g + t: A (16 x 16, row) a0 (g,
// 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); B
// (16 x 8, col) b0 (2t..2t+1, g), b1 (2t + 8.., g); the accumulator as in
// m16n8k8 (below).  The lower k of a pair is the lower half of the word.
template <typename T>
struct Low;

template <>
struct Low<__nv_bfloat16> {
  static __device__ __forceinline__ float widen(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Low<__half> {
  static __device__ __forceinline__ float widen(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// VW consecutive values of a row, widened to fp32.
template <int VW, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (kIsF32<T>) {
    if constexpr (VW == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(p);
      out[0] = t.x; out[1] = t.y;
    }
  } else if constexpr (VW == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const float2 a = Low<T>::unpack(w.x), b = Low<T>::unpack(w.y);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else {
    const float2 a = Low<T>::unpack(*reinterpret_cast<const uint32_t*>(p));
    out[0] = a.x; out[1] = a.y;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core machinery: fp32 products as three TF32 mma.sync.m16n8k8
// (3xTF32), products with P or dS in the low types as two, tiles copied by
// cp.async.
//
// In an m16n8k8 fragment lane = 4 g + t.  A (16 x 8, row) holds a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, col) b0 (t, g),
// b1 (t + 4, g); the fp32 accumulator C (16 x 8) c0 (g, 2t), c1 (g, 2t + 1),
// c2 (g + 8, 2t), c3 (g + 8, 2t + 1).  Which index of the operands a k
// position stands for is free, as long as A and B agree: the kernels pick
// it so that a lane's values lie side by side in shared memory (vector
// reads) and so that a score accumulator is, unchanged, the A fragment of
// the next product (no shuffles).
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// exp(x) as ex2 of x log2(e): within a few ulps of expf for the softmax's
// arguments (<= 0), exactly 0 at -inf and -1e30.
__device__ __forceinline__ float exp_e(float x) { return exp2f(x * kLog2e); }

// x = big + small: big = tf32(x) rounded to nearest, ties away (cvt.rna;
// done here in two integer ops, as cvt.rna.tf32.f32 becomes a longer
// sequence on sm_90), small = x - big exactly in fp32, of which the tensor
// core reads the top 19 bits (truncation).  big + small keeps x to 2^-21.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void split4(const float x[4], uint32_t big[4],
                                       uint32_t small[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(x[e], big[e], small[e]);
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b for one k step in fp32 accuracy: small_a big_b + big_a small_b
// + big_a big_b, the small terms first, into a fresh accumulator, then one
// round-to-nearest add into d.  The tensor core rounds its sums toward
// zero: summed into d along a whole row, that bias would grow with the
// row's length (96 truncations of a dK element at T = 256, ~1e-5 of it);
// here it is one truncation of an 8-product partial per step.  b0/b1 are
// fp32, split here.
__device__ __forceinline__ void mma3(float d[4], const uint32_t a_big[4],
                                     const uint32_t a_small[4], float b0,
                                     float b1) {
  uint32_t b0_big, b0_small, b1_big, b1_small;
  split_tf32(b0, b0_big, b0_small);
  split_tf32(b1, b1_big, b1_small);
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, a_small, b0_big, b1_big);
  mma_tf32(part, a_big, b0_small, b1_small);
  mma_tf32(part, a_big, b0_big, b1_big);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += part[e];
}

// mma3 for a b0/b1 that TF32 holds exactly (a bf16 or fp16 value widened):
// small_a b + big_a b into a fresh accumulator, then one add into d.
__device__ __forceinline__ void mma2(float d[4], const uint32_t a_big[4],
                                     const uint32_t a_small[4], float b0,
                                     float b1) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(part, a_small, __float_as_uint(b0), __float_as_uint(b1));
  mma_tf32(part, a_big, __float_as_uint(b0), __float_as_uint(b1));
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += part[e];
}

// 16-byte copy global -> shared that does not hold the thread; zeros when
// !valid (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// dst [ROWS, ld] <- rows [0, n_valid) of src [*, D]; zeros past n_valid.
template <int D, int ROWS, int NT, typename T>
__device__ __forceinline__ void async_rows(T* dst, int ld,
                                           const T* __restrict__ src,
                                           int n_valid) {
  constexpr int kE = 16 / sizeof(T);  // values a 16-byte copy
  constexpr int kV = D / kE;
  for (int i = threadIdx.x; i < ROWS * kV; i += NT) {
    const int r = i / kV, c = i % kV;
    const bool ok = r < n_valid;
    cp_async16(dst + r * ld + c * kE,
               src + (size_t)(ok ? r : 0) * D + c * kE, ok);
  }
}

// dst [n] <- src [0, n_valid), zeros past it.
template <int NT>
__device__ __forceinline__ void async_vec(float* dst, const float* src, int n,
                                          int n_valid) {
  for (int i = threadIdx.x; i < n; i += NT)
    cp_async4(dst + i, src + (i < n_valid ? i : 0), i < n_valid);
}

// async_vec of a bias in a low type, widened: plain loads and stores (a
// 2-byte value is under cp.async's least copy), ordered for the readers by
// the same barriers as the stage's copies.
template <int NT, typename T>
__device__ __forceinline__ void widen_vec(float* dst, const T* src, int n,
                                          int n_valid) {
  for (int i = threadIdx.x; i < n; i += NT)
    dst[i] = i < n_valid ? Low<T>::widen(src[i]) : 0.f;
}

// The columns of a [*, D] tile as the B operand of a product over rows
// (P V, P^T dO, dS^T q): n-tile i = VW c + u and B column n stand for
// column CHUNK c + VW n + u, so that a lane reads its VW columns of a row
// at once and holds, in the accumulator, 2 VW adjacent output columns.
template <int D>
struct ColMap {
  static constexpr int kVw = D >= 32 ? 4 : 2;
  static constexpr int kChunk = 8 * kVw;
  static constexpr int kChunks = D / kChunk;
};

// VW fp32 values stored as VW values of T (rounded to nearest).
template <int VW, typename T>
__device__ __forceinline__ void store_vec(T* dst, const float* x) {
  if constexpr (kIsF32<T>) {
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
      *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
    }
  } else if constexpr (VW == 4) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(Low<T>::pack(x[0], x[1]), Low<T>::pack(x[2], x[3]));
  } else {
    *reinterpret_cast<uint32_t*>(dst) = Low<T>::pack(x[0], x[1]);
  }
}

// acc [D/8][4] (16 rows x D) += P X over the 8 NK rows of X [8 NK, ld]:
// P [NK][4] is a 16 x 8 NK score accumulator, taken as A with k position
// t <-> row 8j + 2t and t + 4 <-> row 8j + 2t + 1 (so a0..a3 = p0, p2, p1,
// p3); X is read by ColMap.  fp32 X: ld = 4 (mod 32), the VW-wide reads of
// 8 (or 16) lanes fall into distinct banks, and each product is mma3; X in
// a low type: ld = 8 (mod 64) values, the same, and mma2.
template <int D, int NK, typename TX>
__device__ __forceinline__ void acc_rows(float acc[D / 8][4],
                                         const float P[NK][4],
                                         const TX* X, int ld, int g,
                                         int t) {
  using CM = ColMap<D>;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const float pa[4] = {P[j][0], P[j][2], P[j][1], P[j][3]};
    uint32_t p_big[4], p_small[4];
    split4(pa, p_big, p_small);
    const TX* x0 = X + (8 * j + 2 * t) * ld + CM::kVw * g;
    float v0[D / 8], v1[D / 8];
#pragma unroll
    for (int c = 0; c < CM::kChunks; ++c) {
      load_vec<CM::kVw>(x0 + CM::kChunk * c, v0 + CM::kVw * c);
      load_vec<CM::kVw>(x0 + ld + CM::kChunk * c, v1 + CM::kVw * c);
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      if constexpr (kIsF32<TX>) {
        mma3(acc[i], p_big, p_small, v0[i], v1[i]);
      } else {
        mma2(acc[i], p_big, p_small, v0[i], v1[i]);
      }
    }
  }
}

// rows r and r + 8 of out [rows, D] <- acc (as acc_rows leaves it), rows
// < n_rows only.
template <int D, typename T>
__device__ __forceinline__ void store_acc(T* __restrict__ out,
                                          const float acc[D / 8][4], int r,
                                          int n_rows, int t) {
  using CM = ColMap<D>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= n_rows) continue;
#pragma unroll
    for (int c = 0; c < CM::kChunks; ++c) {
      float x[2 * CM::kVw];
#pragma unroll
      for (int u = 0; u < CM::kVw; ++u) {
        x[u] = acc[CM::kVw * c + u][2 * h];
        x[CM::kVw + u] = acc[CM::kVw * c + u][2 * h + 1];
      }
      T* dst = out + (size_t)row * D + CM::kChunk * c + 2 * CM::kVw * t;
      store_vec<CM::kVw>(dst, x);
      store_vec<CM::kVw>(dst + CM::kVw, x + CM::kVw);
    }
  }
}

__device__ __forceinline__ uint32_t word(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc [NQ][4] = A B^T over d: A rows g and g + 8 of [*, ld], B [8 NQ, ld].
// fp32: 3xTF32, k position t <-> d = 8s + t, t + 4 <-> 8s + t + 4 (ld = 4
// mod 32: the scalar reads of a warp fall into distinct banks).  A low
// type: one m16n8k16 a 16-wide step s, k positions as d = 16s + k (a lane's
// pairs are 32-bit words; ld = 8 mod 64 values: distinct banks).
template <int D, int NQ, typename T>
__device__ __forceinline__ void dot_rows(float acc[NQ][4], const T* A,
                                         const T* B, int ld, int g, int t) {
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if constexpr (kIsF32<T>) {
#pragma unroll 2
    for (int ks = 0; ks < D / 8; ++ks) {
      const float* a = A + g * ld + 8 * ks + t;
      const float af[4] = {a[0], a[8 * ld], a[4], a[8 * ld + 4]};
      uint32_t a_big[4], a_small[4];
      split4(af, a_big, a_small);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float* b = B + (8 * j + g) * ld + 8 * ks + t;
        mma3(acc[j], a_big, a_small, b[0], b[4]);
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const T* a = A + g * ld + 16 * ks + 2 * t;
      const uint32_t af[4] = {word(a), word(a + 8 * ld), word(a + 8),
                              word(a + 8 * ld + 8)};
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const T* b = B + (8 * j + g) * ld + 16 * ks + 2 * t;
        Low<T>::mma(acc[j], af, word(b), word(b + 8));
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Row b's key-padding bias [Tk]: fp32 (f) or, for a low T only, T (low);
// null where there is none.
template <typename T>
struct BiasRow {
  const float* f;
  const T* low;

  __device__ BiasRow(const float* bias, const T* bias_low, size_t offset)
      : f(bias ? bias + offset : nullptr),
        low(!kIsF32<T> && bias_low ? bias_low + offset : nullptr) {}
  __device__ bool any() const { return f != nullptr || low != nullptr; }
  // its [k0, k0 + n_valid) into fp32 dst [n], zeros past n_valid
  template <int NT>
  __device__ void stage(float* dst, int k0, int n, int n_valid) const {
    if (f) async_vec<NT>(dst, f + k0, n, n_valid);
    if constexpr (!kIsF32<T>) {
      if (low) widen_vec<NT>(dst, low + k0, n, n_valid);
    }
  }
  __device__ float at(int key) const {
    if constexpr (!kIsF32<T>) {
      if (low) return Low<T>::widen(low[key]);
    }
    return f ? f[key] : 0.f;
  }
};

// ---------------------------------------------------------------------------
// Forward: one block per (b*h, 64 query rows), 4 warps of 16 rows each.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct FwdCfg {
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;         // query rows a block
  static constexpr int kKeys = D == 128 ? 16 : 32;  // keys a tile
  // fp32: float2 reads along d of 16 lanes (rows g, columns 2t): no
  // conflict; a low T: dot_rows' word reads
  static constexpr int kLdQ = D + 8, kLdK = D + 8;
  static constexpr int kLdV = kIsF32<T> ? D + 4 : D + 8;  // acc_rows' reads
  // smem bytes: q [kRows, kLdQ] once; two stages of K [kKeys, kLdK], V
  // [kKeys, kLdV] and the fp32 bias [kKeys]
  static constexpr int kQBytes = kRows * kLdQ * sizeof(T);
  static constexpr int kStageBytes =
      kKeys * (kLdK + kLdV) * sizeof(T) + kKeys * sizeof(float);
  static constexpr size_t kSmem = kQBytes + 2 * kStageBytes;
};

template <typename T, int D>
__global__ void __launch_bounds__(FwdCfg<T, D>::kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const T* __restrict__ bias_low, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Tq, int Tk, float scale,
                 int causal, int n_qt) {
  using C = FwdCfg<T, D>;
  constexpr int kN = C::kKeys / 8, kDn = D / 8, NT = C::kThreads;
  constexpr int LQ = C::kLdQ, LK = C::kLdK, LV = C::kLdV;
  extern __shared__ __align__(16) unsigned char smem[];  // carved by bytes
  // within a head, the q tiles with the most causal work start first
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * C::kRows;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w0 = 16 * (threadIdx.x >> 5);  // this warp's first row (local)
  const int r0 = q0 + w0 + g;              // this lane's rows r0, r0 + 8
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const BiasRow<T> br(bias, bias_low, (size_t)(bh / H) * Tk);
  const bool has_bias = br.any();
  T* Qs = reinterpret_cast<T*>(smem);
  unsigned char* stages = smem + C::kQBytes;

  auto load_stage = [&](int buf, int k0) {
    T* Ks = reinterpret_cast<T*>(stages + buf * C::kStageBytes);
    T* Vs = Ks + C::kKeys * LK;
    const int nk = min(C::kKeys, Tk - k0);
    async_rows<D, C::kKeys, NT>(Ks, LK, kb + (size_t)k0 * D, nk);
    async_rows<D, C::kKeys, NT>(Vs, LV, vb + (size_t)k0 * D, nk);
    br.template stage<NT>(reinterpret_cast<float*>(Vs + C::kKeys * LV), k0,
                          C::kKeys, nk);
  };
  const int k_end = causal ? min(Tk, q0 + C::kRows) : Tk;
  const int n_kt = (k_end + C::kKeys - 1) / C::kKeys;
  async_rows<D, C::kRows, NT>(Qs, LQ, q + ((size_t)bh * Tq + q0) * D,
                              min(C::kRows, Tq - q0));
  load_stage(0, 0);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[kDn][4];
#pragma unroll
  for (int i = 0; i < kDn; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * C::kKeys;
    // tile kt + 1 is copied while tile kt is computed
    if (kt + 1 < n_kt) load_stage((kt + 1) & 1, k0 + C::kKeys);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Ks = reinterpret_cast<const T*>(stages + (kt & 1) *
                                             C::kStageBytes);
    const T* Vs = Ks + C::kKeys * LK;
    const float* Bs = reinterpret_cast<const float*>(Vs + C::kKeys * LV);

    // S = q k^T, 16 rows x kKeys keys a warp; key 8j + g is B column g of
    // n-tile j.  fp32: (scale q) k^T by 3xTF32, k position t standing for
    // d = 8 ks + 2t, t + 4 for 8 ks + 2t + 1 (float2 reads); A rows r0 (a0,
    // a2) and r0 + 8 (a1, a3).  A low T: dot_rows, scale after
    float s[kN][4];
    if constexpr (kIsF32<T>) {
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kDn; ++ks) {
        const float* qa = Qs + (w0 + g) * LQ + 8 * ks + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(qa);
        const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * LQ);
        const float a[4] = {x0.x * scale, x1.x * scale, x0.y * scale,
                            x1.y * scale};
        uint32_t a_big[4], a_small[4];
        split4(a, a_big, a_small);
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              Ks + (8 * j + g) * LK + 8 * ks + 2 * t);
          mma3(s[j], a_big, a_small, kv.x, kv.y);
        }
      }
    } else {
      static_assert(LQ == LK, "dot_rows reads q and k at one stride");
      dot_rows<D, kN>(s, Qs + w0 * LQ, Ks, LQ, g, t);
    }

    // bias, masks and the online softmax; c_e holds row r0 + 8 (e >> 1),
    // key k0 + 8j + 2t + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1), kc = 8 * j + 2 * t + (e & 1);
        float x = -INFINITY;  // keys past Tk: weight exactly 0
        if (k0 + kc < Tk) {
          x = s[j][e];
          if constexpr (!kIsF32<T>) x *= scale;
          if (has_bias) x += Bs[kc];
          if (causal && row < k0 + kc) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      const float corr = exp_e(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr;  // this lane's share of the row sum
#pragma unroll
      for (int i = 0; i < kDn; ++i) {
        o[i][2 * h] *= corr;
        o[i][2 * h + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp_e(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    // o += P V, P straight from the score registers
    acc_rows<D, kN>(o, s, Vs, LV, g, t);
    __syncthreads();  // every warp is done with this stage
  }

  float lf[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lf[h] = fmaxf(quad_sum(l[h]), 1e-30f);
#pragma unroll
  for (int i = 0; i < kDn; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] /= lf[e >> 1];
  store_acc<D>(out + (size_t)bh * Tq * D, o, r0, Tq, t);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < Tq)
        lse[(size_t)bh * Tq + r0 + 8 * h] = m[h] + logf(lf[h]);
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (b*h, 64 query rows), 4 warps of 16 rows each.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DqCfg {
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;         // query rows a block
  static constexpr int kKeys = D == 128 ? 16 : 32;  // keys a tile
  // one stride for every tile: dot_rows' reads along d (q, dO as A, k, v
  // as B) and acc_rows' reads of k (the X of dS k) are conflict-free
  static constexpr int kLd = kIsF32<T> ? D + 4 : D + 8;
  // smem bytes: q, dO [kRows, kLd] once; two stages of K, V [kKeys, kLd]
  // and the fp32 bias [kKeys]
  static constexpr int kQOBytes = 2 * kRows * kLd * sizeof(T);
  static constexpr int kStageBytes =
      2 * kKeys * kLd * sizeof(T) + kKeys * sizeof(float);
  static constexpr size_t kSmem = kQOBytes + 2 * kStageBytes;
};

template <typename T, int D>
__global__ void __launch_bounds__(DqCfg<T, D>::kThreads, 2)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                const T* __restrict__ bias_low, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int H,
                int Tq, int Tk, float scale, int causal, int n_qt) {
  using C = DqCfg<T, D>;
  constexpr int kN = C::kKeys / 8, kDn = D / 8, NT = C::kThreads;
  constexpr int LD = C::kLd;
  extern __shared__ __align__(16) unsigned char smem[];  // carved by bytes
  // within a head, the q tiles with the most causal work start first
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * C::kRows;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w0 = 16 * (threadIdx.x >> 5);  // this warp's first row (local)
  const int r0 = q0 + w0 + g;              // this lane's rows r0, r0 + 8
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const BiasRow<T> br(bias, bias_low, (size_t)(bh / H) * Tk);
  const bool has_bias = br.any();
  T* Qs = reinterpret_cast<T*>(smem);
  T* Os = Qs + C::kRows * LD;
  unsigned char* stages = smem + C::kQOBytes;

  auto load_stage = [&](int buf, int k0) {
    T* Ks = reinterpret_cast<T*>(stages + buf * C::kStageBytes);
    T* Vs = Ks + C::kKeys * LD;
    const int nk = min(C::kKeys, Tk - k0);
    async_rows<D, C::kKeys, NT>(Ks, LD, kb + (size_t)k0 * D, nk);
    async_rows<D, C::kKeys, NT>(Vs, LD, vb + (size_t)k0 * D, nk);
    br.template stage<NT>(reinterpret_cast<float*>(Vs + C::kKeys * LD), k0,
                          C::kKeys, nk);
  };
  const int nq = min(C::kRows, Tq - q0);
  const int k_end = causal ? min(Tk, q0 + C::kRows) : Tk;
  const int n_kt = (k_end + C::kKeys - 1) / C::kKeys;
  async_rows<D, C::kRows, NT>(Qs, LD, q + ((size_t)bh * Tq + q0) * D, nq);
  async_rows<D, C::kRows, NT>(Os, LD, dout + ((size_t)bh * Tq + q0) * D, nq);
  load_stage(0, 0);
  cp_async_commit();

  float lse_r[2], delta_r[2], acc[kDn][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    lse_r[h] = row < Tq ? lse[(size_t)bh * Tq + row] : 0.f;
    delta_r[h] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kDn; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // causal: a tile whose first key is past this warp's last row adds
  // nothing to the warp's rows
  const int warp_end = causal ? q0 + w0 + 16 : Tk;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * C::kKeys;
    // tile kt + 1 is copied while tile kt is computed
    if (kt + 1 < n_kt) load_stage((kt + 1) & 1, k0 + C::kKeys);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (k0 < warp_end) {
      const T* Ks = reinterpret_cast<const T*>(stages + (kt & 1) *
                                               C::kStageBytes);
      const T* Vs = Ks + C::kKeys * LD;
      const float* Bs = reinterpret_cast<const float*>(Vs + C::kKeys * LD);
      // S = q k^T, then P = exp(scale S + bias - lse); c_e holds row r0 +
      // 8 (e >> 1), key k0 + 8j + 2t + (e & 1)
      float p[kN][4], ds[kN][4];
      dot_rows<D, kN>(p, Qs + w0 * LD, Ks, LD, g, t);
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e >> 1), key = k0 + 8 * j + 2 * t + (e & 1);
          float pe = 0.f;  // keys past Tk, and above the causal diagonal
          if (key < Tk && !(causal && row < key)) {
            float x = p[j][e] * scale;
            if (has_bias) x += Bs[key - k0];
            pe = exp_e(x - lse_r[e >> 1]);
          }
          p[j][e] = pe;
        }
      // dS = P (dP - delta), dP = dO v^T; dq += dS k, dS as it stands the A
      // fragment
      dot_rows<D, kN>(ds, Os + w0 * LD, Vs, LD, g, t);
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - delta_r[e >> 1]);
      acc_rows<D, kN>(acc, ds, Ks, LD, g, t);
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < kDn; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] *= scale;
  store_acc<D>(dq + (size_t)bh * Tq * D, acc, r0, Tq, t);
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (b*h, 64 keys), 4 warps of 16 keys each.
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DkvCfg {
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int kKeys = 16 * kWarps;      // keys a block
  static constexpr int kQ = D == 128 ? 16 : 32;  // queries a tile
  // reads along d and acc_rows'
  static constexpr int kLd = kIsF32<T> ? D + 4 : D + 8;
  // D = 128: dV, then dK, in two sweeps over the queries, so that one set
  // of accumulators (64 registers) is live at a time
  static constexpr bool kTwoSweeps = D == 128;
  // smem bytes: K, V [kKeys, kLd] once; two stages of q, dO [kQ, kLd], fp32
  // lse, delta [kQ]
  static constexpr int kKVBytes = 2 * kKeys * kLd * sizeof(T);
  static constexpr int kStageBytes =
      2 * kQ * kLd * sizeof(T) + 2 * kQ * sizeof(float);
  static constexpr size_t kSmem = kKVBytes + 2 * kStageBytes;
};

// What one sweep over a block's query tiles needs.
template <typename T>
struct DkvSweep {
  const T* qb;          // q [Tq, D] of this head
  const T* ob;          // dO [Tq, D]
  const float* lb;      // lse [Tq]
  const float* db;      // delta [Tq]
  const T* Ks;          // this warp's K rows (raw, shared memory)
  const T* Vs;          // its V rows
  unsigned char* stages;  // two stages of q, dO, lse, delta
  int Tq, Tk, key, q_begin, n_qt, causal;
  float scale, bias_k[2];
};

// One sweep: dV (kDv) and/or dK (kDk) of this lane's keys key + 8h into
// dv_acc / dk_acc (dK unscaled).
template <typename T, int D, bool kDv, bool kDk>
__device__ __forceinline__ void dkv_sweep(const DkvSweep<T>& w,
                                          float dv_acc[D / 8][4],
                                          float dk_acc[D / 8][4], int g,
                                          int t) {
  using C = DkvCfg<T, D>;
  constexpr int kN = C::kQ / 8, NT = C::kThreads, LD = C::kLd;
  auto load_stage = [&](int buf, int q0) {
    T* Qs = reinterpret_cast<T*>(w.stages + buf * C::kStageBytes);
    T* Os = Qs + C::kQ * LD;
    float* Ls = reinterpret_cast<float*>(Os + C::kQ * LD);
    const int nq = min(C::kQ, w.Tq - q0);
    async_rows<D, C::kQ, NT>(Qs, LD, w.qb + (size_t)q0 * D, nq);
    async_rows<D, C::kQ, NT>(Os, LD, w.ob + (size_t)q0 * D, nq);
    async_vec<NT>(Ls, w.lb + q0, C::kQ, nq);
    if (kDk) async_vec<NT>(Ls + C::kQ, w.db + q0, C::kQ, nq);
  };
  if (w.n_qt > 0) load_stage(0, w.q_begin);
  cp_async_commit();

  for (int it = 0; it < w.n_qt; ++it) {
    const int q0 = w.q_begin + it * C::kQ;
    // tile it + 1 is copied while tile it is computed
    if (it + 1 < w.n_qt) load_stage((it + 1) & 1, q0 + C::kQ);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Qs = reinterpret_cast<const T*>(w.stages + (it & 1) *
                                             C::kStageBytes);
    const T* Os = Qs + C::kQ * LD;
    const float* Ls = reinterpret_cast<const float*>(Os + C::kQ * LD);
    const float* Ds = Ls + C::kQ;

    // S^T = K q^T and P^T = exp(scale S^T + bias - lse): rows keys, c_e
    // key w.key + 8 (e >> 1), query q0 + 8j + 2t + (e & 1)
    float p[kN][4];
    dot_rows<D, kN>(p, w.Ks, Qs, LD, g, t);
#pragma unroll
    for (int j = 0; j < kN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = w.key + 8 * (e >> 1);
        const int qc = 8 * j + 2 * t + (e & 1), query = q0 + qc;
        float pe = 0.f;
        if (query < w.Tq && key < w.Tk && !(w.causal && query < key))
          pe = exp_e(p[j][e] * w.scale + w.bias_k[e >> 1] - Ls[qc]);
        p[j][e] = pe;
      }
    // dV += P^T dO
    if (kDv) acc_rows<D, kN>(dv_acc, p, Os, LD, g, t);
    if (kDk) {
      // dS^T = P^T (dP^T - delta), dP^T = V dO^T; dK += dS^T q
      float ds[kN][4];
      dot_rows<D, kN>(ds, w.Vs, Os, LD, g, t);
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - Ds[8 * j + 2 * t + (e & 1)]);
      acc_rows<D, kN>(dk_acc, ds, Qs, LD, g, t);
    }
    __syncthreads();  // every warp is done with this stage
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvCfg<T, D>::kThreads, 2)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 const T* __restrict__ bias_low, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int Tq, int Tk, float scale,
                 int causal, int n_kt) {
  using C = DkvCfg<T, D>;
  constexpr int kDn = D / 8, NT = C::kThreads, LD = C::kLd;
  extern __shared__ __align__(16) unsigned char smem[];  // carved by bytes
  const int bh = blockIdx.x / n_kt, k0 = (blockIdx.x % n_kt) * C::kKeys;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kr = 16 * (threadIdx.x >> 5);  // this warp's first key (local)
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + C::kKeys * LD;
  const BiasRow<T> br(bias, bias_low, (size_t)(bh / H) * Tk);

  DkvSweep<T> w;
  w.qb = q + (size_t)bh * Tq * D;
  w.ob = dout + (size_t)bh * Tq * D;
  w.lb = lse + (size_t)bh * Tq;
  w.db = delta + (size_t)bh * Tq;
  w.Ks = Ks + kr * LD;
  w.Vs = Vs + kr * LD;
  w.stages = smem + C::kKVBytes;
  w.Tq = Tq;
  w.Tk = Tk;
  w.key = k0 + kr + g;  // this lane's keys w.key, w.key + 8
  // causal: query tiles whose last row is above this block's first key
  // are dead (k0 is a multiple of kQ)
  w.q_begin = causal ? k0 : 0;
  w.n_qt = w.q_begin < Tq ? (Tq - w.q_begin + C::kQ - 1) / C::kQ : 0;
  w.causal = causal;
  w.scale = scale;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = w.key + 8 * h;
    w.bias_k[h] = key < Tk ? br.at(key) : 0.f;
  }
  if (w.n_qt > 0) {
    const int nk = min(C::kKeys, Tk - k0);
    async_rows<D, C::kKeys, NT>(Ks, LD, k + ((size_t)bh * Tk + k0) * D, nk);
    async_rows<D, C::kKeys, NT>(Vs, LD, v + ((size_t)bh * Tk + k0) * D, nk);
  }
  // (committed with the first sweep's first stage)

  float dk_acc[kDn][4], dv_acc[kDn][4];
#pragma unroll
  for (int i = 0; i < kDn; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  T* dk_out = dk + (size_t)bh * Tk * D;
  T* dv_out = dv + (size_t)bh * Tk * D;
  if constexpr (C::kTwoSweeps) {
    dkv_sweep<T, D, true, false>(w, dv_acc, dk_acc, g, t);
    store_acc<D>(dv_out, dv_acc, w.key, Tk, t);
    dkv_sweep<T, D, false, true>(w, dv_acc, dk_acc, g, t);
  } else {
    dkv_sweep<T, D, true, true>(w, dv_acc, dk_acc, g, t);
    store_acc<D>(dv_out, dv_acc, w.key, Tk, t);
  }
#pragma unroll
  for (int i = 0; i < kDn; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] *= scale;
  store_acc<D>(dk_out, dk_acc, w.key, Tk, t);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes);
}

struct Dims {
  int B, H, Tq, Tk;
  float scale;
  int causal;
  int bias_low;  // the bias is in the inputs' low type (else fp32)
  cudaStream_t stream;
};

// The bias pointer as the kernels take it: fp32, or the inputs' type T.
const float* bias_f32(const void* bias, const Dims& d) {
  return d.bias_low ? nullptr : static_cast<const float*>(bias);
}

template <typename T>
const T* bias_t(const void* bias, const Dims& d) {
  return d.bias_low ? static_cast<const T*>(bias) : nullptr;
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias,
               void* out, void* lse, const Dims& d) {
  using C = FwdCfg<T, D>;
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (d.Tq + C::kRows - 1) / C::kRows;
  flash_fwd_kernel<T, D><<<(unsigned)((long long)d.B * d.H * n_qt),
                           C::kThreads, C::kSmem, d.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias_f32(bias, d), bias_t<T>(bias, d),
      static_cast<T*>(out), static_cast<float*>(lse), d.H, d.Tq, d.Tk,
      d.scale, d.causal, n_qt);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* bias,
              const void* dout, const void* lse, const void* delta, void* dq,
              const Dims& d) {
  using C = DqCfg<T, D>;
  cudaError_t e = allow_smem(flash_dq_kernel<T, D>, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (d.Tq + C::kRows - 1) / C::kRows;
  flash_dq_kernel<T, D><<<(unsigned)((long long)d.B * d.H * n_qt),
                          C::kThreads, C::kSmem, d.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias_f32(bias, d), bias_t<T>(bias, d),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), d.H, d.Tq,
      d.Tk, d.scale, d.causal, n_qt);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias,
               const void* dout, const void* lse, const void* delta, void* dk,
               void* dv, const Dims& d) {
  using C = DkvCfg<T, D>;
  cudaError_t e = allow_smem(flash_dkv_kernel<T, D>, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int n_kt = (d.Tk + C::kKeys - 1) / C::kKeys;
  flash_dkv_kernel<T, D><<<(unsigned)((long long)d.B * d.H * n_kt),
                           C::kThreads, C::kSmem, d.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias_f32(bias, d), bias_t<T>(bias, d),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), d.H, d.Tq, d.Tk, d.scale, d.causal, n_kt);
  return (int)cudaGetLastError();
}

// Blocks of one kernel that fit an SM at once (kind 0 forward, 1 dQ, 2
// dK/dV), from its threads, registers and shared memory.
template <typename T, int D>
int blocks_per_sm(int kind, int* blocks) {
  const void* kernel;
  int threads;
  size_t smem_bytes;
  if (kind == 0) {
    kernel = (const void*)flash_fwd_kernel<T, D>;
    threads = FwdCfg<T, D>::kThreads;
    smem_bytes = FwdCfg<T, D>::kSmem;
  } else if (kind == 1) {
    kernel = (const void*)flash_dq_kernel<T, D>;
    threads = DqCfg<T, D>::kThreads;
    smem_bytes = DqCfg<T, D>::kSmem;
  } else if (kind == 2) {
    kernel = (const void*)flash_dkv_kernel<T, D>;
    threads = DkvCfg<T, D>::kThreads;
    smem_bytes = DkvCfg<T, D>::kSmem;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = allow_smem(kernel, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, smem_bytes);
}

// f(std::integral_constant<int, D>) for a head width the kernels are built
// for.
template <typename F>
int with_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int flash_fwd(const void* q, const void* k, const void* v, const void* bias,
              void* out, void* lse, int B, int H, int Tq, int Tk, int D,
              float scale, int causal, void* stream, int bias_low) {
  if ((long long)B * H * Tq == 0) return 0;
  const Dims d{B, H, Tq, Tk, scale, causal, bias_low, (cudaStream_t)stream};
  return with_head_dim(D, [&](auto n) {
    return launch_fwd<T, decltype(n)::value>(q, k, v, bias, out, lse, d);
  });
}

template <typename T>
int flash_dq(const void* q, const void* k, const void* v, const void* bias,
             const void* dout, const void* lse, const void* delta, void* dq,
             int B, int H, int Tq, int Tk, int D, float scale, int causal,
             void* stream, int bias_low) {
  if ((long long)B * H * Tq == 0) return 0;
  const Dims d{B, H, Tq, Tk, scale, causal, bias_low, (cudaStream_t)stream};
  return with_head_dim(D, [&](auto n) {
    return launch_dq<T, decltype(n)::value>(q, k, v, bias, dout, lse, delta,
                                            dq, d);
  });
}

template <typename T>
int flash_dkv(const void* q, const void* k, const void* v, const void* bias,
              const void* dout, const void* lse, const void* delta, void* dk,
              void* dv, int B, int H, int Tq, int Tk, int D, float scale,
              int causal, void* stream, int bias_low) {
  if ((long long)B * H * Tk == 0) return 0;
  const Dims d{B, H, Tq, Tk, scale, causal, bias_low, (cudaStream_t)stream};
  return with_head_dim(D, [&](auto n) {
    return launch_dkv<T, decltype(n)::value>(q, k, v, bias, dout, lse, delta,
                                             dk, dv, d);
  });
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
// Device pointers, contiguous and 16-byte aligned: q, dout, out, dq [B*H,
// Tq, D]; k, v, dk, dv [B*H, Tk, D], all of the entry's type; lse, delta
// [B*H, Tq] float32; bias [B, Tk] or null, float32 (or, in the bf16 and f16
// entries with bias_low set, of the entry's type).  D is 16, 32, 64 or 128;
// Tq, Tk >= 1.

int pta_flash_fwd_f32(const void* q, const void* k, const void* v,
                      const void* bias, void* out, void* lse, int B, int H,
                      int Tq, int Tk, int D, float scale, int causal,
                      void* stream) {
  return flash_fwd<float>(q, k, v, bias, out, lse, B, H, Tq, Tk, D, scale,
                          causal, stream, 0);
}

int pta_flash_dq_f32(const void* q, const void* k, const void* v,
                     const void* bias, const void* dout, const void* lse,
                     const void* delta, void* dq, int B, int H, int Tq, int Tk,
                     int D, float scale, int causal, void* stream) {
  return flash_dq<float>(q, k, v, bias, dout, lse, delta, dq, B, H, Tq, Tk,
                         D, scale, causal, stream, 0);
}

int pta_flash_dkv_f32(const void* q, const void* k, const void* v,
                      const void* bias, const void* dout, const void* lse,
                      const void* delta, void* dk, void* dv, int B, int H,
                      int Tq, int Tk, int D, float scale, int causal,
                      void* stream) {
  return flash_dkv<float>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Tq,
                          Tk, D, scale, causal, stream, 0);
}

#define PTA_FLASH_LOW_ENTRIES(SFX, T)                                        \
  int pta_flash_fwd_##SFX(const void* q, const void* k, const void* v,       \
                          const void* bias, void* out, void* lse, int B,     \
                          int H, int Tq, int Tk, int D, float scale,         \
                          int causal, void* stream, int bias_low) {          \
    return flash_fwd<T>(q, k, v, bias, out, lse, B, H, Tq, Tk, D, scale,     \
                        causal, stream, bias_low);                           \
  }                                                                          \
  int pta_flash_dq_##SFX(const void* q, const void* k, const void* v,        \
                         const void* bias, const void* dout,                 \
                         const void* lse, const void* delta, void* dq,       \
                         int B, int H, int Tq, int Tk, int D, float scale,   \
                         int causal, void* stream, int bias_low) {           \
    return flash_dq<T>(q, k, v, bias, dout, lse, delta, dq, B, H, Tq, Tk, D, \
                       scale, causal, stream, bias_low);                     \
  }                                                                          \
  int pta_flash_dkv_##SFX(const void* q, const void* k, const void* v,       \
                          const void* bias, const void* dout,                \
                          const void* lse, const void* delta, void* dk,      \
                          void* dv, int B, int H, int Tq, int Tk, int D,     \
                          float scale, int causal, void* stream,             \
                          int bias_low) {                                    \
    return flash_dkv<T>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Tq,   \
                        Tk, D, scale, causal, stream, bias_low);             \
  }

PTA_FLASH_LOW_ENTRIES(bf16, __nv_bfloat16)
PTA_FLASH_LOW_ENTRIES(f16, __half)

#undef PTA_FLASH_LOW_ENTRIES

// dtype 0 float32, 1 bfloat16, 2 float16.
int pta_flash_blocks_per_sm(int kind, int dtype, int D, int* blocks) {
  return with_head_dim(D, [&](auto n) {
    constexpr int kD = decltype(n)::value;
    switch (dtype) {
      case 0: return blocks_per_sm<float, kD>(kind, blocks);
      case 1: return blocks_per_sm<__nv_bfloat16, kD>(kind, blocks);
      case 2: return blocks_per_sm<__half, kD>(kind, blocks);
      default: return (int)cudaErrorInvalidValue;
    }
  });
}

const char* pta_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
