// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV kernels of
// the training path, for float32, bfloat16 and float16 inputs.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas_flash.py:
//   flash_fwd_kernel (fp32), flash_fwd_wgmma_kernel (bf16, fp16)
//                     <- _flash_kernel (via _flash_forward, :280)
//   flash_dq_kernel (fp32), flash_dq_wgmma_kernel (bf16, fp16)
//                     <- _dq_kernel    (via _flash_backward, :328)
//   flash_dkv_kernel (fp32), flash_dkv_wgmma_kernel (bf16, fp16)
//                     <- _dkv_kernel   (via _flash_backward, :349)
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
//   - dQ (fp32): the forward's blocks, tile order and K/V stages (bias with
//     them);
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
// pallas_fused.py:60).  As in the reference (:84-86, :135-138, :184-187)
// every value is widened to fp32, every sum is fp32, P and dS are fp32
// values (:97-103, :146-153, :199-209), out, dq, dk and dv are rounded
// once to T, and lse is fp32.  Products of two input tensors (q k^T, dO
// v^T; k q^T, v dO^T in dK/dV) are exact in fp32, so only the order of the
// sums differs from the reference; scale multiplies the fp32 scores after
// the product.  What bounds them on the card: bytes.  At the main shape
// (B 64, H 8, T 256, D 64, a padding bias) the reference's products at the
// bf16 tensor-core rate take 0.009 ms (forward), 0.013 (dQ) and 0.017
// (dK/dV) against 0.020, 0.025 and 0.030 ms of bytes.  The kernels'
// split of P and dS (below) doubles their third and fourth products: at the
// bf16 rate dQ's four then take 0.017 ms and dK/dV's six 0.026, still
// under their bytes.  What holds them above that bound is latency: a
// block's first tiles arrive before anything overlaps them, and a
// warpgroup waits on each of its own products.
//
//   All three (flash_fwd_wgmma_kernel, flash_dq_wgmma_kernel,
//     flash_dkv_wgmma_kernel, on flash_sm90.cuh): warpgroup products
//     (wgmma) on tiles that TMA brings into shared memory.  A block is two
//     consumer warpgroups of 64 rows each and a producer warpgroup;
//     setmaxnreg gives the consumers the producer's registers.  The
//     producer's first warp fills a ring of stages (full and empty
//     mbarriers a stage): K and V tiles of 64 keys (forward, dQ) or q and
//     dO tiles of 64 queries (dK/dV) by TMA, each row a swizzled line of
//     32, 64 or 128 bytes (two 128-byte panels at D = 128), and the small
//     rows (the bias in the forward and dQ, lse and delta in dK/dV) by its
//     own loads.  P (in dQ and dK/dV also dS) goes into its product
//     as hi + lo in T: hi = T(P), lo = T(P - hi), two wgmma into the same
//     fp32 accumulator, lo first, with A in registers straight from the
//     score accumulator (an accumulator's 16 columns packed pairwise are an
//     A fragment) and B read MN-major through the descriptor (the
//     16-bit types allow it; TF32 does not, which keeps fp32 on mma.sync).
//     hi + lo keeps ~16 bits of P, within FLASH_LOW_TOL where rounding P
//     once to T (FlashAttention-2's move, 2^-9 max|v| into out) is not
//     (tests/test_torch_flash_amp_split.py), at the 16-bit rate: half the
//     instructions of the TF32 split, and wgmma's operand shape.
//     - forward: persistent, two blocks an SM (D <= 64; one at D = 128),
//       each walking the work items (b*h, 128 query rows) head by head;
//       per item q (two buffers: the next item's loads while this one's
//       out leaves through the other), then its K/V tiles through 4 stages
//       (2 at D = 128).  Per 64-key tile a warpgroup forms S = q k^T by
//       wgmma (both operands K-major in shared memory), the online softmax
//       in base 2 in registers (a row's max and sum over the 4 lanes of a
//       quad; masks only in a tile at Tk's edge or across the causal
//       diagonal), then o += P V.  out is rounded to T in the q tile and
//       written by one TMA store; lse by the threads.
//     - dK/dV: a block per (b*h, 128 keys), one block an SM; each
//       warpgroup holds its 64 keys' K and V tiles (TMA, once) and dK, dV
//       in registers; per 64-query tile S^T = K q^T and dP^T = V dO^T, P^T
//       = 2^(S^T scale log2 e + bias log2 e - lse log2 e) as soon as S^T is
//       in, dV += P^T dO while dS^T = P^T (dP^T - delta) is formed, then
//       dK += dS^T q (three wgmma batches, so that the tensor cores work
//       while the threads do).  In fp16 a dS under the loss scaler can pass
//       65504 where the reference's fp32 does not: each key row of dS^T is
//       multiplied by 2^-ex before the split, ex the least exponent that
//       keeps the row's largest |dS| under 2^15 so far (it only grows; the
//       row of dK, kept in units of 2^ex, is rescaled exactly when it
//       does), and dK takes scale 2^ex once at the end.  bf16 has fp32's
//       range and needs none.  At D = 128 dV and then dK take a sweep each
//       over the queries (S^T computed twice), so that one accumulator of
//       64 registers is live at a time.  dK and dV leave through the K and
//       V tiles by TMA stores (at D = 128 dV by the threads, as sweep 2
//       still reads V).
//     - dQ: dK/dV with rows and columns swapped.  Persistent as the
//       forward, one block an SM walking the work items (b*h, 128 query
//       rows), the rows with the most causal work first; per item each
//       warpgroup holds its 64 rows' q and dO tiles (TMA, two buffers, as
//       the forward's q), their lse and delta in registers, and dQ in
//       registers; K and V tiles of 64 keys stream through 4 stages (2 at
//       D = 128) with the keys' bias.  Per tile S = q k^T and dP = dO v^T
//       (two wgmma batches), P = 2^(S scale log2 e + bias log2 e - lse
//       log2 e) as soon as S is in, dS = P (dP - delta), then dQ += dS k
//       with k read MN-major from the same tile that S read (no
//       transposing copy).  In fp16 each query row of dS takes the
//       exponent of dK's key rows, and dQ the factor 2^ex at the end.  A
//       group skips the tiles wholly above its rows (causal) but arrives
//       on every stage's empty barrier.  S, dP, the hi / lo words and dQ
//       (D / 2 a thread) fit the consumers' 232 registers at every D, so
//       there is one sweep.  dQ leaves through the group's q tile by one
//       TMA store.
//   - the bias is fp32 or T, widened as it is read.  An overflow that the
//     reference does produce (dq past fp16's range) still rounds to inf
//     when the output is written.
//
// Dead causal tiles are skipped (the reference's `live`, :80, :131, :180),
// and in dQ also a warp's (warpgroup's) tiles that lie wholly above its
// rows.  The ragged edge of Tq and Tk is masked here (rows past the end
// load as zeros, keys past the end get weight 0), so any Tq, Tk >= 1
// works, with no power-of-two block halving.  Every sum has a fixed order and there are no
// atomics, so two launches are bitwise equal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;

template <typename T>
constexpr bool kIsF32 = std::is_same_v<T, float>;

// The low-precision element types, two to a 32-bit word: widened to fp32
// exactly and rounded from it to nearest (the lower element of a pair in
// the lower half of the word).
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
};

// VW consecutive fp32 values of a row.
template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core machinery of the fp32 kernels: products as three TF32
// mma.sync.m16n8k8 (3xTF32), tiles copied by cp.async.
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

// VW fp32 values stored.
template <int VW>
__device__ __forceinline__ void store_vec(float* dst, const float* x) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  }
}

// acc [D/8][4] (16 rows x D) += P X over the 8 NK rows of X [8 NK, ld]:
// P [NK][4] is a 16 x 8 NK score accumulator, taken as A with k position
// t <-> row 8j + 2t and t + 4 <-> row 8j + 2t + 1 (so a0..a3 = p0, p2, p1,
// p3); X is read by ColMap at ld = 4 (mod 32), where the VW-wide reads of
// 8 (or 16) lanes fall into distinct banks; each product is mma3.
template <int D, int NK>
__device__ __forceinline__ void acc_rows(float acc[D / 8][4],
                                         const float P[NK][4],
                                         const float* X, int ld, int g,
                                         int t) {
  using CM = ColMap<D>;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const float pa[4] = {P[j][0], P[j][2], P[j][1], P[j][3]};
    uint32_t p_big[4], p_small[4];
    split4(pa, p_big, p_small);
    const float* x0 = X + (8 * j + 2 * t) * ld + CM::kVw * g;
    float v0[D / 8], v1[D / 8];
#pragma unroll
    for (int c = 0; c < CM::kChunks; ++c) {
      load_vec<CM::kVw>(x0 + CM::kChunk * c, v0 + CM::kVw * c);
      load_vec<CM::kVw>(x0 + ld + CM::kChunk * c, v1 + CM::kVw * c);
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      mma3(acc[i], p_big, p_small, v0[i], v1[i]);
  }
}

// rows r and r + 8 of out [rows, D] <- acc (as acc_rows leaves it), rows
// < n_rows only.
template <int D>
__device__ __forceinline__ void store_acc(float* __restrict__ out,
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
      float* dst = out + (size_t)row * D + CM::kChunk * c + 2 * CM::kVw * t;
      store_vec<CM::kVw>(dst, x);
      store_vec<CM::kVw>(dst + CM::kVw, x + CM::kVw);
    }
  }
}

// acc [NQ][4] = A B^T over d by 3xTF32: A rows g and g + 8 of [*, ld], B
// [8 NQ, ld]; k position t <-> d = 8s + t, t + 4 <-> 8s + t + 4 (ld = 4
// mod 32: the scalar reads of a warp fall into distinct banks).
template <int D, int NQ>
__device__ __forceinline__ void dot_rows(float acc[NQ][4], const float* A,
                                         const float* B, int ld, int g,
                                         int t) {
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
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
  // its [k0, k0 + n_valid) into dst [n], zeros past n_valid (the fp32
  // kernels' cp.async stages)
  template <int NT>
  __device__ void stage(float* dst, int k0, int n, int n_valid) const {
    if (f) async_vec<NT>(dst, f + k0, n, n_valid);
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

template <int D>
struct FwdCfg {
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;         // query rows a block
  static constexpr int kKeys = D == 128 ? 16 : 32;  // keys a tile
  // float2 reads along d of 16 lanes (rows g, columns 2t): no conflict
  static constexpr int kLdQ = D + 8, kLdK = D + 8;
  static constexpr int kLdV = D + 4;  // acc_rows' reads
  // smem bytes: q [kRows, kLdQ] once; two stages of K [kKeys, kLdK], V
  // [kKeys, kLdV] and the bias [kKeys]
  static constexpr int kQBytes = kRows * kLdQ * sizeof(float);
  static constexpr int kStageBytes =
      kKeys * (kLdK + kLdV) * sizeof(float) + kKeys * sizeof(float);
  static constexpr size_t kSmem = kQBytes + 2 * kStageBytes;
};

template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int H,
                 int Tq, int Tk, float scale, int causal, int n_qt) {
  using T = float;
  using C = FwdCfg<D>;
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
  const BiasRow<T> br(bias, nullptr, (size_t)(bh / H) * Tk);
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

    // S = (scale q) k^T, 16 rows x kKeys keys a warp, by 3xTF32; key 8j + g
    // is B column g of n-tile j, k position t standing for d = 8 ks + 2t,
    // t + 4 for 8 ks + 2t + 1 (float2 reads); A rows r0 (a0, a2) and r0 + 8
    // (a1, a3)
    float s[kN][4];
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
// dQ (fp32): one block per (b*h, 64 query rows), 4 warps of 16 rows each.
// ---------------------------------------------------------------------------

template <int D>
struct DqCfg {
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;         // query rows a block
  static constexpr int kKeys = D == 128 ? 16 : 32;  // keys a tile
  // one stride for every tile: dot_rows' reads along d (q, dO as A, k, v
  // as B) and acc_rows' reads of k (the X of dS k) are conflict-free
  static constexpr int kLd = D + 4;
  // smem bytes: q, dO [kRows, kLd] once; two stages of K, V [kKeys, kLd]
  // and the bias [kKeys]
  static constexpr int kQOBytes = 2 * kRows * kLd * sizeof(float);
  static constexpr int kStageBytes =
      2 * kKeys * kLd * sizeof(float) + kKeys * sizeof(float);
  static constexpr size_t kSmem = kQOBytes + 2 * kStageBytes;
};

template <int D>
__global__ void __launch_bounds__(DqCfg<D>::kThreads, 2)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int H, int Tq, int Tk, float scale, int causal, int n_qt) {
  using T = float;
  using C = DqCfg<D>;
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
  const BiasRow<T> br(bias, nullptr, (size_t)(bh / H) * Tk);
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

template <int D>
struct DkvCfg {
  static constexpr int kWarps = 4, kThreads = 32 * kWarps;
  static constexpr int kKeys = 16 * kWarps;      // keys a block
  static constexpr int kQ = D == 128 ? 16 : 32;  // queries a tile
  // reads along d and acc_rows'
  static constexpr int kLd = D + 4;
  // D = 128: dV, then dK, in two sweeps over the queries, so that one set
  // of accumulators (64 registers) is live at a time
  static constexpr bool kTwoSweeps = D == 128;
  // smem bytes: K, V [kKeys, kLd] once; two stages of q, dO [kQ, kLd], fp32
  // lse, delta [kQ]
  static constexpr int kKVBytes = 2 * kKeys * kLd * sizeof(float);
  static constexpr int kStageBytes =
      2 * kQ * kLd * sizeof(float) + 2 * kQ * sizeof(float);
  static constexpr size_t kSmem = kKVBytes + 2 * kStageBytes;
};

// What one sweep over a block's query tiles needs.
struct DkvSweep {
  const float* qb;      // q [Tq, D] of this head
  const float* ob;      // dO [Tq, D]
  const float* lb;      // lse [Tq]
  const float* db;      // delta [Tq]
  const float* Ks;      // this warp's K rows (raw, shared memory)
  const float* Vs;      // its V rows
  unsigned char* stages;  // two stages of q, dO, lse, delta
  int Tq, Tk, key, q_begin, n_qt, causal;
  float scale, bias_k[2];
};

// One sweep: dV (kDv) and/or dK (kDk) of this lane's keys key + 8h into
// dv_acc / dk_acc (dK unscaled).
template <int D, bool kDv, bool kDk>
__device__ __forceinline__ void dkv_sweep(const DkvSweep& w,
                                          float dv_acc[D / 8][4],
                                          float dk_acc[D / 8][4], int g,
                                          int t) {
  using T = float;
  using C = DkvCfg<D>;
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

template <int D>
__global__ void __launch_bounds__(DkvCfg<D>::kThreads, 2)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int H, int Tq, int Tk, float scale,
                 int causal, int n_kt) {
  using T = float;
  using C = DkvCfg<D>;
  constexpr int kDn = D / 8, NT = C::kThreads, LD = C::kLd;
  extern __shared__ __align__(16) unsigned char smem[];  // carved by bytes
  const int bh = blockIdx.x / n_kt, k0 = (blockIdx.x % n_kt) * C::kKeys;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kr = 16 * (threadIdx.x >> 5);  // this warp's first key (local)
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + C::kKeys * LD;
  const BiasRow<T> br(bias, nullptr, (size_t)(bh / H) * Tk);

  DkvSweep w;
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
    dkv_sweep<D, true, false>(w, dv_acc, dk_acc, g, t);
    store_acc<D>(dv_out, dv_acc, w.key, Tk, t);
    dkv_sweep<D, false, true>(w, dv_acc, dk_acc, g, t);
  } else {
    dkv_sweep<D, true, true>(w, dv_acc, dk_acc, g, t);
    store_acc<D>(dv_out, dv_acc, w.key, Tk, t);
  }
#pragma unroll
  for (int i = 0; i < kDn; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] *= scale;
  store_acc<D>(dk_out, dk_acc, w.key, Tk, t);
}

// ---------------------------------------------------------------------------
// bf16 / fp16 forward and dK/dV: wgmma and TMA (flash_sm90.cuh).  A block is
// two consumer warpgroups of 64 rows each and a producer warpgroup whose
// first warp fills a ring of kStages stages (TMA, and its own loads of the
// small rows), full and empty mbarriers guarding each stage.
// ---------------------------------------------------------------------------

// A head's width D as panels of kP elements, one swizzled row of kSpan bytes
// each (two panels at D = 128, where a row of 256 bytes passes the widest
// swizzle), kSteps k steps of 16 a panel.
template <int D>
struct Panels {
  static constexpr int kP = D < 64 ? D : 64;
  static constexpr int kSpan = 2 * kP;
  static constexpr int kN = D / kP;
  static constexpr int kSteps = kP / 16;
};

// 2^x in one MUFU instruction (results below fp32's normal range flush to
// 0, as P's smallest weights may).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x0, x1 as hi = T(x) and lo = T(x - hi), each a packed pair: hi + lo keeps
// ~16 bits of x (bf16; 22 in fp16 while lo is normal).
template <typename T>
__device__ __forceinline__ void split_hi_lo(float x0, float x1, uint32_t& hi,
                                            uint32_t& lo) {
  hi = Low<T>::pack(x0, x1);
  const float2 h = Low<T>::unpack(hi);
  lo = Low<T>::pack(x0 - h.x, x1 - h.y);
}

// The m64n64 accumulator d (S, or S^T / dP^T in dK/dV) as the A fragments
// of its four 16-column steps, hi and lo (flash_sm90.cuh: a[e] = the pair
// d[8 kk + 2 e], d[8 kk + 2 e + 1]).
template <typename T>
__device__ __forceinline__ void a_hi_lo(const float (&d)[32],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_hi_lo<T>(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1], hi[kk][e],
                     lo[kk][e]);
}

// acc [kN][kP / 2] (64 rows x D, panel by panel) += A B over 64 k: A the
// four 16-wide steps as hi and lo fragments, lo first, B [64, D] MN-major
// at B (panels of 64 rows x kSpan bytes).
template <typename T, int D>
__device__ __forceinline__ void acc_hi_lo(
    float (&acc)[Panels<D>::kN][Panels<D>::kP / 2], const uint32_t (&hi)[4][4],
    const uint32_t (&lo)[4][4], const unsigned char* B) {
  using Pn = Panels<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int pn = 0; pn < Pn::kN; ++pn) {
      const uint64_t b = sm90::desc_mn<Pn::kSpan>(
          B + pn * 64 * Pn::kSpan + kk * 16 * Pn::kSpan);
      sm90::Wgmma<T, Pn::kP>::rs(acc[pn], lo[kk], b);
      sm90::Wgmma<T, Pn::kP>::rs(acc[pn], hi[kk], b);
    }
}

// d [64 rows, 64 cols] = A B^T over D: A [64, D] and B [64, D] K-major in
// shared memory (panels of 64 rows x kSpan bytes).
template <typename T, int D>
__device__ __forceinline__ void dot_wg(float (&d)[32], const unsigned char* A,
                                       const unsigned char* B) {
  using Pn = Panels<D>;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int off = (ks / Pn::kSteps) * 64 * Pn::kSpan + (ks % Pn::kSteps) * 32;
    sm90::Wgmma<T, 64>::ss(d, sm90::desc_k<Pn::kSpan>(A + off),
                           sm90::desc_k<Pn::kSpan>(B + off), ks > 0);
  }
}

template <int D>
__device__ __forceinline__ void fence_acc(
    float (&acc)[Panels<D>::kN][Panels<D>::kP / 2]) {
#pragma unroll
  for (int pn = 0; pn < Panels<D>::kN; ++pn) sm90::fence_regs(acc[pn]);
}

// rows r and r + 8 of out [rows, D] <- acc (a warpgroup accumulator as
// acc_hi_lo leaves it), rows < n_rows only.
template <typename T, int D>
__device__ __forceinline__ void store_wg(
    T* __restrict__ out, const float (&acc)[Panels<D>::kN][Panels<D>::kP / 2],
    int r, int n_rows, int t) {
  using Pn = Panels<D>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= n_rows) continue;
#pragma unroll
    for (int pn = 0; pn < Pn::kN; ++pn)
#pragma unroll
      for (int j = 0; j < Pn::kP / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * D + pn * Pn::kP +
                                     8 * j + 2 * t) =
            Low<T>::pack(acc[pn][4 * j + 2 * h], acc[pn][4 * j + 2 * h + 1]);
  }
}

// A warpgroup's accumulator (64 rows x D, as acc_hi_lo leaves it) rounded
// to T into `tile` in the layout TMA gives a [64, D] box (panels of 64 rows
// x kSpan bytes, swizzled: the 16-byte chunk c of row r at c ^ ((r kSpan
// >> 7) % (kSpan / 16)), where a warp's 4-byte writes fall into 32
// distinct banks), then stored by one TMA store through `map` at
// (row0, bh): whole rows, coalesced, and nothing past the tensor's end.
// `tile` must be free (no wgmma still reading it); grp names the group's
// barrier.
template <typename T, int D>
__device__ __forceinline__ void store_tile(
    const float (&acc)[Panels<D>::kN][Panels<D>::kP / 2], unsigned char* tile,
    const CUtensorMap* map, int row0, int bh, int grp, int wq, int g,
    int t) {
  using Pn = Panels<D>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * wq + g + 8 * h;
    const int swz = ((row * Pn::kSpan) >> 7) % (Pn::kSpan / 16);
#pragma unroll
    for (int pn = 0; pn < Pn::kN; ++pn)
#pragma unroll
      for (int j = 0; j < Pn::kP / 8; ++j)
        *reinterpret_cast<uint32_t*>(tile + pn * 64 * Pn::kSpan +
                                     row * Pn::kSpan + ((j ^ swz) << 4) +
                                     4 * t) =
            Low<T>::pack(acc[pn][4 * j + 2 * h], acc[pn][4 * j + 2 * h + 1]);
  }
  sm90::fence_async_smem();
  sm90::bar_sync(1 + grp, 128);
  if (wq == 0 && g == 0 && t == 0) {
#pragma unroll
    for (int pn = 0; pn < Pn::kN; ++pn)
      sm90::tma_store_3d(map, tile + pn * 64 * Pn::kSpan, pn * Pn::kP, row0,
                         bh);
    sm90::tma_store_commit();
    sm90::tma_store_wait();
  }
}

// The online softmax of one tile's scores s (rows r0, r0 + 8; keys k0
// ..): in base 2, x = S scale log2(e) + bias log2(e) (Bs, the tile's bias x
// log2(e)), the running max m and row-sum share l, o rescaled, and P as hi
// + lo in T.  Masks (kEdge) only in a tile at Tk's edge or across the
// causal diagonal; both are template flags, so that a tile without them
// carries no per-element selects.
template <typename T, int D, bool kEdge, bool kBias>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], float (&m)[2], float (&l)[2],
    float (&o)[Panels<D>::kN][Panels<D>::kP / 2], uint32_t (&hi)[4][4],
    uint32_t (&lo)[4][4], const unsigned char* bias_tile, int causal,
    float scale_log2, int r0, int k0, int Tk, int t) {
  using Pn = Panels<D>;
  const float* Bs = reinterpret_cast<const float*>(bias_tile);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const int kc = 8 * (i >> 2) + 2 * t + (i & 1);
    float x = s[i] * scale_log2;
    if constexpr (kBias) x += Bs[kc];
    if constexpr (kEdge) {
      if (causal && r0 + 8 * h < k0 + kc) x = kNegInf * kLog2e;
      if (k0 + kc >= Tk) x = -INFINITY;  // keys past Tk: weight exactly 0
    }
    s[i] = x;
    mx[h] = fmaxf(mx[h], x);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    const float corr = exp2_ftz(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr;  // this lane's share of the row sum
#pragma unroll
    for (int pn = 0; pn < Pn::kN; ++pn)
#pragma unroll
      for (int j = 0; j < Pn::kP / 8; ++j) {
        o[pn][4 * j + 2 * h] *= corr;
        o[pn][4 * j + 2 * h + 1] *= corr;
      }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = exp2_ftz(s[i] - m[(i >> 1) & 1]);
    s[i] = p;
    l[(i >> 1) & 1] += p;
  }
  a_hi_lo<T>(s, hi, lo);
}

// Registers a thread: the producer warpgroup drops to its config's
// kProducerRegs, the two consumer warpgroups rise to kConsumerRegs with
// what it frees.  Each quarter of an SM holds 16384 registers and one warp
// of each warpgroup of a block: one block an SM starts its three
// warpgroups at 168, two blocks at 80.  launch_* check the sum on the
// kernel's actual count before a launch.
template <int D>
struct FwdWg {
  using Pn = Panels<D>;
  static constexpr int kGroups = 2;   // consumer warpgroups
  static constexpr int kRows = 64;    // query rows a group
  static constexpr int kKeys = 64;    // keys a tile
  // D <= 64: two blocks an SM, each with every K/V tile of a 256-key row
  // in flight at once; D = 128: one block, a double buffer
  static constexpr int kStages = D <= 64 ? 4 : 2;
  static constexpr int kBlocksPerSm = D <= 64 ? 2 : 1;
  static constexpr int kProducerRegs = 32;
  static constexpr int kConsumerRegs = kBlocksPerSm == 2 ? 104 : 232;
  static constexpr int kThreads = 128 * (kGroups + 1);  // + the producer
  static constexpr int kQBytes = kRows * 2 * D;  // a group's q tile
  static constexpr int kQBufBytes = kGroups * kQBytes;  // a block's
  static constexpr int kKBytes = kKeys * 2 * D;  // a K (V) tile
  static constexpr int kBiasBytes = 1024;        // kKeys fp32, padded
  static constexpr int kStageBytes = 2 * kKBytes + kBiasBytes;
  // two q buffers (the next work item's q loads while this one's out
  // leaves through the other), then the ring
  static constexpr int kBarOffset = 2 * kQBufBytes + kStages * kStageBytes;
  // + the slack to align the tiles to 1024 bytes; full, empty, q full, q
  // empty barriers
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 4);
};

// Work item w of the forward and dQ: query tile n_qt - 1 - w % n_qt (the
// last first) of head bh = w / n_qt, from row q0, over n_kt key tiles.
template <typename C>
__device__ __forceinline__ void fwd_item(int w, int n_qt, int causal, int Tk,
                                         int& bh, int& q0, int& n_kt) {
  bh = w / n_qt;
  q0 = (n_qt - 1 - w % n_qt) * (C::kGroups * C::kRows);
  const int k_end = causal ? min(Tk, q0 + C::kGroups * C::kRows) : Tk;
  n_kt = (k_end + C::kKeys - 1) / C::kKeys;
}

// Persistent: a grid of about kBlocksPerSm blocks an SM walks the work
// items (b*h, 128 query rows), block x taking items x, x + gridDim.x, ...;
// the producer runs ahead into the next item while the consumers finish
// this one.  Items go head by head, the last (causally heaviest) rows of a
// head first, so that a head's q tiles run side by side and share its K
// and V in L2; the grid is odd, so that a block's items alternate between
// heavy and light causal tiles.  On an H100 SXM (700 W) at B 64, H 8, T 256,
// D 64 this takes 0.043 ms a bf16 call against 0.047 for the same code run
// as a block per item (padding case; causal 0.034 against 0.035), from CUDA
// graph replays in turns (tools/flash_ab.py).
template <typename T, int D>
__global__ void __launch_bounds__(FwdWg<D>::kThreads, FwdWg<D>::kBlocksPerSm)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap out_map,
                       const float* __restrict__ bias,
                       const T* __restrict__ bias_low,
                       float* __restrict__ lse, int BH, int H, int Tq, int Tk,
                       float scale, int causal, int n_qt) {
  using C = FwdWg<D>;
  using Pn = Panels<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + C::kStages;
  uint64_t* q_full = empty + C::kStages;
  uint64_t* q_empty = q_full + 2;
  unsigned char* stages = smem + 2 * C::kQBufBytes;
  const int n_items = BH * n_qt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool has_bias = bias != nullptr || bias_low != nullptr;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      // the TMA bytes' arrival, and the bias's (the producer's loads)
      sm90::mbar_init(&full[s], has_bias ? 2 : 1);
      sm90::mbar_init(&empty[s], 4 * C::kGroups);  // a consumer warp each
    }
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(&q_full[b], 1);
      sm90::mbar_init(&q_empty[b], C::kGroups);  // a thread of each group
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C::kGroups) {
    // producer: its first warp brings each item's q, then K and V by TMA
    // and the bias (widened to fp32 by the warp's loads) tile by tile
    sm90::regs_dec<C::kProducerRegs>();
    if (warp == 4 * C::kGroups) {
      int tile = 0;  // the ring's count of tiles over all items
      for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
        int bh, q0, n_kt;
        fwd_item<C>(w, n_qt, causal, Tk, bh, q0, n_kt);
        const int qb = n & 1;
        if (lane == 0) {
          if (n >= 2) sm90::mbar_wait(&q_empty[qb], ((n >> 1) - 1) & 1);
          sm90::mbar_expect_tx(&q_full[qb], C::kQBufBytes);
          for (int grp = 0; grp < C::kGroups; ++grp)
            for (int pn = 0; pn < Pn::kN; ++pn)
              sm90::tma_load_3d(smem + qb * C::kQBufBytes + grp * C::kQBytes +
                                    pn * C::kRows * Pn::kSpan,
                                &q_map, &q_full[qb], pn * Pn::kP,
                                q0 + grp * C::kRows, bh);
        }
        // the bias x log2(e) of tile kt's keys, two a lane, read one tile
        // ahead so that its latency hides behind the ring
        const BiasRow<T> br(bias, bias_low, (size_t)(bh / H) * Tk);
        float b0 = 0.f, b1 = 0.f;
        if (has_bias) {
          b0 = lane < Tk ? br.at(lane) * kLog2e : 0.f;
          b1 = lane + 32 < Tk ? br.at(lane + 32) * kLog2e : 0.f;
        }
        for (int kt = 0; kt < n_kt; ++kt, ++tile) {
          const int s = tile % C::kStages, round = tile / C::kStages;
          if (round > 0) sm90::mbar_wait(&empty[s], (round - 1) & 1);
          unsigned char* st = stages + s * C::kStageBytes;
          if (lane == 0) {
            sm90::mbar_expect_tx(&full[s], 2 * C::kKBytes);
            for (int pn = 0; pn < Pn::kN; ++pn) {
              sm90::tma_load_3d(st + pn * C::kKeys * Pn::kSpan, &k_map,
                                &full[s], pn * Pn::kP, kt * C::kKeys, bh);
              sm90::tma_load_3d(st + C::kKBytes + pn * C::kKeys * Pn::kSpan,
                                &v_map, &full[s], pn * Pn::kP, kt * C::kKeys,
                                bh);
            }
          }
          if (has_bias) {
            float* Bs = reinterpret_cast<float*>(st + 2 * C::kKBytes);
            Bs[lane] = b0;
            Bs[lane + 32] = b1;
            const int key = (kt + 1) * C::kKeys + lane;
            b0 = kt + 1 < n_kt && key < Tk ? br.at(key) * kLog2e : 0.f;
            b1 = kt + 1 < n_kt && key + 32 < Tk ? br.at(key + 32) * kLog2e
                                                 : 0.f;
            __syncwarp();  // the warp's stores before lane 0's arrival
            if (lane == 0) sm90::mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {
    sm90::regs_inc<C::kConsumerRegs>();
    const int grp = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
    const float scale_log2 = scale * kLog2e;

    int tile = 0;
    for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
      int bh, q0, n_kt;
      fwd_item<C>(w, n_qt, causal, Tk, bh, q0, n_kt);
      const int qb = n & 1;
      const int row0 = q0 + grp * C::kRows;  // the group's first row
      const int r0 = row0 + 16 * wq + g;     // this thread's rows r0, r0 + 8
      unsigned char* Qs = smem + qb * C::kQBufBytes + grp * C::kQBytes;
      // tiles at or past k_live hold no key the group's rows see (causal)
      const int k_live = row0 >= Tq ? 0 : causal ? row0 + C::kRows : Tk;
      // the row max in base 2 (m), this lane's share of the row sum (l)
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
      float o[Pn::kN][Pn::kP / 2], s[32];
#pragma unroll
      for (int pn = 0; pn < Pn::kN; ++pn)
#pragma unroll
        for (int i = 0; i < Pn::kP / 2; ++i) o[pn][i] = 0.f;
      sm90::mbar_wait(&q_full[qb], (n >> 1) & 1);

      uint32_t hi[4][4], lo[4][4];
      for (int kt = 0; kt < n_kt; ++kt, ++tile) {
        const int si = tile % C::kStages, k0 = kt * C::kKeys;
        const unsigned char* st = stages + si * C::kStageBytes;
        sm90::mbar_wait(&full[si], (tile / C::kStages) & 1);
        if (k0 < k_live) {
          // S = q k^T: c_i holds row r0 + 8 ((i >> 1) & 1), key k0 + 8 (i
          // >> 2) + 2t + (i & 1)
          sm90::fence_regs(s);
          sm90::wg_fence();
          dot_wg<T, D>(s, Qs, st);
          sm90::wg_commit();
          sm90::wg_wait<0>();
          sm90::fence_regs(s);
          const unsigned char* Bs = st + 2 * C::kKBytes;
          if (k0 + C::kKeys > Tk || (causal && k0 + C::kKeys - 1 > row0)) {
            if (has_bias)
              softmax_tile<T, D, true, true>(s, m, l, o, hi, lo, Bs, causal,
                                             scale_log2, r0, k0, Tk, t);
            else
              softmax_tile<T, D, true, false>(s, m, l, o, hi, lo, Bs, causal,
                                              scale_log2, r0, k0, Tk, t);
          } else if (has_bias) {
            softmax_tile<T, D, false, true>(s, m, l, o, hi, lo, Bs, causal,
                                            scale_log2, r0, k0, Tk, t);
          } else {
            softmax_tile<T, D, false, false>(s, m, l, o, hi, lo, Bs, causal,
                                             scale_log2, r0, k0, Tk, t);
          }
          // o += P V
          fence_acc<D>(o);
          sm90::fence_regs(hi);
          sm90::fence_regs(lo);
          sm90::wg_fence();
          acc_hi_lo<T, D>(o, hi, lo, st + C::kKBytes);
          sm90::wg_commit();
          sm90::wg_wait<0>();
          fence_acc<D>(o);
          sm90::fence_regs(hi);
          sm90::fence_regs(lo);
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[si]);  // the stage is free
      }

      if (row0 < Tq) {
        float inv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float lf = fmaxf(quad_sum(l[h]), 1e-30f);
          inv[h] = 1.f / lf;
          if (t == 0 && r0 + 8 * h < Tq)
            lse[(size_t)bh * Tq + r0 + 8 * h] = m[h] / kLog2e + logf(lf);
        }
#pragma unroll
        for (int pn = 0; pn < Pn::kN; ++pn)
#pragma unroll
          for (int i = 0; i < Pn::kP / 2; ++i) o[pn][i] *= inv[(i >> 1) & 1];
        // out through the group's q tile, which no wgmma reads any more;
        // then the q buffer is free for the item after next
        store_tile<T, D>(o, Qs, &out_map, row0, bh, grp, wq, g, t);
      }
      if (wq == 0 && lane == 0) sm90::mbar_arrive(&q_empty[qb]);
    }
  }
}

template <int D>
struct DkvWg {
  using Pn = Panels<D>;
  static constexpr int kGroups = 2;  // consumer warpgroups
  static constexpr int kKeys = 64;   // keys a group
  static constexpr int kQ = 64;      // queries a tile
  // D <= 64: every q tile of a 256-query head in flight at once
  static constexpr int kStages = D <= 64 ? 4 : 2;
  static constexpr int kBlocksPerSm = 1;
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr int kThreads = 128 * (kGroups + 1);  // + the producer
  // D = 128: dV, then dK, in two sweeps over the queries, so that one
  // accumulator (64 registers) is live at a time
  static constexpr bool kTwoSweeps = D == 128;
  static constexpr int kKBytes = kKeys * 2 * D;  // a group's K (V) rows
  static constexpr int kQBytes = kQ * 2 * D;     // a q (dO) tile
  static constexpr int kRowBytes = 1024;         // lse, delta: kQ fp32 each
  static constexpr int kStageBytes = 2 * kQBytes + kRowBytes;
  static constexpr int kBarOffset =
      2 * kGroups * kKBytes + kStages * kStageBytes;
  // + the alignment slack; full, empty, K/V barriers
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 1);
};

// What a consumer warpgroup's sweep over the query tiles needs.
struct DkvWgCtx {
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  const unsigned char* Ks;  // the group's K rows, V rows
  const unsigned char* Vs;
  int Tq, Tk, q_begin, n_qt, causal;
  int key0;  // the group's first key
  int kr;    // this thread's keys kr, kr + 8
  bool live;
  float scale_log2, bias_log2[2];  // scale and the keys' bias, x log2(e)
};

// P^T = 2^(S^T scale log2(e) + bias log2(e) - lse log2(e)) in place (Ls:
// the tile's lse x log2(e)); masks (kEdge) only at Tq's or Tk's edge or
// across the causal diagonal, a template flag, so that the other tiles
// carry no per-element branches.
template <bool kEdge>
__device__ __forceinline__ void dkv_probs(float (&sT)[32], const DkvWgCtx& c,
                                          const float* Ls, int q0, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 lq = *reinterpret_cast<const float2*>(Ls + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, h = e >> 1;
      float pe = exp2_ftz(sT[i] * c.scale_log2 + c.bias_log2[h] -
                          ((e & 1) ? lq.y : lq.x));
      if constexpr (kEdge) {
        const int key = c.kr + 8 * h, query = q0 + 8 * j + 2 * t + (e & 1);
        if (query >= c.Tq || key >= c.Tk || (c.causal && query < key))
          pe = 0.f;
      }
      sT[i] = pe;
    }
  }
}

// fp16: dS^T (dK/dV) or dS (dQ) row by row times 2^-ex, ex the least
// exponent that keeps the row's largest |dS| under 2^15 so far (it only
// grows); the accumulator's row (dK's or dQ's), kept in units of 2^ex, is
// rescaled exactly when it grows.
template <int D>
__device__ __forceinline__ void scale_ds_rows(
    float (&ds)[32], float (&dk)[Panels<D>::kN][Panels<D>::kP / 2],
    int (&ex)[2]) {
  using Pn = Panels<D>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(fabsf(ds[4 * j + 2 * h]),
                           fabsf(ds[4 * j + 2 * h + 1])));
    mx = quad_max(mx);
    const int need = (int)((__float_as_uint(mx) >> 23) & 0xff) - 141;
    if (need > ex[h]) {
      const float f =
          __uint_as_float((uint32_t)max(127 + ex[h] - need, 0) << 23);
#pragma unroll
      for (int pn = 0; pn < Pn::kN; ++pn)
#pragma unroll
        for (int j = 0; j < Pn::kP / 8; ++j) {
          dk[pn][4 * j + 2 * h] *= f;
          dk[pn][4 * j + 2 * h + 1] *= f;
        }
      ex[h] = need;
    }
    const float inv = __uint_as_float((uint32_t)(127 - ex[h]) << 23);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ds[4 * j + 2 * h] *= inv;
      ds[4 * j + 2 * h + 1] *= inv;
    }
  }
}

// One sweep: dV (kDv) and/or dK (kDk) of this thread's keys; `it` counts
// the ring's tiles across sweeps; ex is dK's per-row power-of-two exponent
// (fp16).  A tile's products go in three batches so that the tensor cores
// work while the threads do: S^T and dP^T (P^T computed as soon as S^T is
// in), dV (dS^T computed meanwhile), dK.
template <typename T, int D, bool kDv, bool kDk>
__device__ __forceinline__ void dkv_wg_sweep(
    const DkvWgCtx& c, int& it, float (&dv)[Panels<D>::kN][Panels<D>::kP / 2],
    float (&dk)[Panels<D>::kN][Panels<D>::kP / 2], int (&ex)[2], int t,
    int lane) {
  using C = DkvWg<D>;
  float sT[32], dpT[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sT[i] = dpT[i] = 0.f;
  for (int qt = 0; qt < c.n_qt; ++qt, ++it) {
    const int si = it % C::kStages, q0 = c.q_begin + qt * C::kQ;
    const unsigned char* st = c.stages + si * C::kStageBytes;
    sm90::mbar_wait(&c.full[si], (it / C::kStages) & 1);
    // dead for the group: its keys past Tk, or (causal) every query of the
    // tile before its first key
    if (c.live && !(c.causal && q0 + C::kQ <= c.key0)) {
      const unsigned char* Qs = st;
      const unsigned char* Os = st + C::kQBytes;
      // lse log2(e) and delta of the tile's queries
      const float* Ls = reinterpret_cast<const float*>(st + 2 * C::kQBytes);
      const float* Ds = Ls + C::kQ;
      // masks only at Tq's or Tk's edge or across the causal diagonal
      const bool edge = q0 + C::kQ > c.Tq || c.key0 + C::kKeys > c.Tk ||
                        (c.causal && q0 < c.key0 + C::kKeys);
      // S^T = K q^T, then dP^T = V dO^T: c_i holds key kr + 8 ((i >> 1) &
      // 1), query q0 + 8 (i >> 2) + 2t + (i & 1)
      sm90::fence_regs(sT);
      if constexpr (kDk) sm90::fence_regs(dpT);
      sm90::wg_fence();
      dot_wg<T, D>(sT, c.Ks, Qs);
      sm90::wg_commit();
      if constexpr (kDk) {
        dot_wg<T, D>(dpT, c.Vs, Os);
        sm90::wg_commit();
        sm90::wg_wait<1>();
      } else {
        sm90::wg_wait<0>();
      }
      sm90::fence_regs(sT);
      // P^T = 2^(S^T scale log2(e) + bias log2(e) - lse log2(e))
      if (edge)
        dkv_probs<true>(sT, c, Ls, q0, t);
      else
        dkv_probs<false>(sT, c, Ls, q0, t);
      uint32_t p_hi[4][4], p_lo[4][4], d_hi[4][4], d_lo[4][4];
      if constexpr (kDk) {
        sm90::wg_wait<0>();
        sm90::fence_regs(dpT);
      }
      if constexpr (kDv) {
        // dV += P^T dO: A hi + lo in T, B read MN-major
        a_hi_lo<T>(sT, p_hi, p_lo);
        fence_acc<D>(dv);
        sm90::fence_regs(p_hi);
        sm90::fence_regs(p_lo);
        sm90::wg_fence();
        acc_hi_lo<T, D>(dv, p_hi, p_lo, Os);
        sm90::wg_commit();
      }
      if constexpr (kDk) {
        // dS^T = P^T (dP^T - delta); dK += dS^T q
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dq =
              *reinterpret_cast<const float2*>(Ds + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            dpT[i] = sT[i] * (dpT[i] - ((e & 1) ? dq.y : dq.x));
          }
        }
        if constexpr (std::is_same_v<T, __half>) scale_ds_rows<D>(dpT, dk, ex);
        a_hi_lo<T>(dpT, d_hi, d_lo);
        fence_acc<D>(dk);
        sm90::fence_regs(d_hi);
        sm90::fence_regs(d_lo);
        sm90::wg_fence();
        acc_hi_lo<T, D>(dk, d_hi, d_lo, Qs);
        sm90::wg_commit();
      }
      sm90::wg_wait<0>();
      // (the A registers too: read by the batches until here)
      if constexpr (kDv) {
        fence_acc<D>(dv);
        sm90::fence_regs(p_hi);
        sm90::fence_regs(p_lo);
      }
      if constexpr (kDk) {
        fence_acc<D>(dk);
        sm90::fence_regs(d_hi);
        sm90::fence_regs(d_lo);
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&c.empty[si]);  // the stage is free
  }
}

// dK = scale dS^T q (dQ = scale dS k) from its accumulator, whose rows are
// in units of 2^ex in fp16.
template <typename T, int D>
__device__ __forceinline__ void scale_acc(
    float (&acc)[Panels<D>::kN][Panels<D>::kP / 2], const int (&ex)[2],
    float scale) {
  using Pn = Panels<D>;
  float f[2] = {scale, scale};
  if constexpr (std::is_same_v<T, __half>) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      f[h] *= __uint_as_float((uint32_t)(127 + ex[h]) << 23);
  }
#pragma unroll
  for (int pn = 0; pn < Pn::kN; ++pn)
#pragma unroll
    for (int i = 0; i < Pn::kP / 2; ++i) acc[pn][i] *= f[(i >> 1) & 1];
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvWg<D>::kThreads, DkvWg<D>::kBlocksPerSm)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap dk_map,
                       const __grid_constant__ CUtensorMap dv_map,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const float* __restrict__ bias,
                       const T* __restrict__ bias_low, T* __restrict__ dv,
                       int H, int Tq, int Tk, float scale, int causal,
                       int n_kt) {
  using C = DkvWg<D>;
  using Pn = Panels<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + C::kStages;
  uint64_t* kv_bar = empty + C::kStages;
  unsigned char* stages = smem + 2 * C::kGroups * C::kKBytes;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * (C::kGroups * C::kKeys);
  // causal: query tiles whose last row is above this block's first key
  // are dead (k0 is a multiple of kQ)
  const int q_begin = causal ? k0 : 0;
  const int n_qt = q_begin < Tq ? (Tq - q_begin + C::kQ - 1) / C::kQ : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * C::kGroups);  // a consumer warp each
    }
    sm90::mbar_init(kv_bar, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C::kGroups) {
    // producer: its first warp brings K and V once by TMA, then q and dO
    // by TMA and lse and delta (the warp's loads) tile by tile
    sm90::regs_dec<C::kProducerRegs>();
    if (warp == 4 * C::kGroups && n_qt > 0) {
      if (lane == 0) {
        sm90::mbar_expect_tx(kv_bar, 2 * C::kGroups * C::kKBytes);
        for (int w = 0; w < C::kGroups; ++w)
          for (int pn = 0; pn < Pn::kN; ++pn) {
            const int off = w * C::kKBytes + pn * C::kKeys * Pn::kSpan;
            sm90::tma_load_3d(smem + off, &k_map, kv_bar, pn * Pn::kP,
                              k0 + w * C::kKeys, bh);
            sm90::tma_load_3d(smem + C::kGroups * C::kKBytes + off, &v_map,
                              kv_bar, pn * Pn::kP, k0 + w * C::kKeys, bh);
          }
      }
      const float* lb = lse + (size_t)bh * Tq;
      const float* db = delta + (size_t)bh * Tq;
      const int n_it = (C::kTwoSweeps ? 2 : 1) * n_qt;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % C::kStages, round = it / C::kStages;
        const int q0 = q_begin + (it % n_qt) * C::kQ;
        if (round > 0) sm90::mbar_wait(&empty[s], (round - 1) & 1);
        unsigned char* st = stages + s * C::kStageBytes;
        float* Ls = reinterpret_cast<float*>(st + 2 * C::kQBytes);
        for (int i = lane; i < C::kQ; i += 32) {
          const bool ok = q0 + i < Tq;
          Ls[i] = ok ? lb[q0 + i] * kLog2e : 0.f;
          Ls[C::kQ + i] = ok ? db[q0 + i] : 0.f;
        }
        __syncwarp();  // the warp's stores before lane 0's arrival
        if (lane == 0) {
          sm90::mbar_expect_tx(&full[s], 2 * C::kQBytes);
          for (int pn = 0; pn < Pn::kN; ++pn) {
            sm90::tma_load_3d(st + pn * C::kQ * Pn::kSpan, &q_map, &full[s],
                              pn * Pn::kP, q0, bh);
            sm90::tma_load_3d(st + C::kQBytes + pn * C::kQ * Pn::kSpan,
                              &do_map, &full[s], pn * Pn::kP, q0, bh);
          }
        }
      }
    }
  } else {
    sm90::regs_inc<C::kConsumerRegs>();
    const int grp = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
    DkvWgCtx c;
    c.stages = stages;
    c.full = full;
    c.empty = empty;
    c.Ks = smem + grp * C::kKBytes;
    c.Vs = smem + (C::kGroups + grp) * C::kKBytes;
    c.Tq = Tq;
    c.Tk = Tk;
    c.q_begin = q_begin;
    c.n_qt = n_qt;
    c.causal = causal;
    c.key0 = k0 + grp * C::kKeys;
    c.kr = c.key0 + 16 * wq + g;
    c.live = c.key0 < Tk;
    c.scale_log2 = scale * kLog2e;
    const BiasRow<T> br(bias, bias_low, (size_t)(bh / H) * Tk);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      c.bias_log2[h] = c.kr + 8 * h < Tk ? br.at(c.kr + 8 * h) * kLog2e : 0.f;
    if (n_qt > 0) sm90::mbar_wait(kv_bar, 0);

    // dK and dV through the group's K and V tiles once no wgmma reads them
    unsigned char* k_tile = smem + grp * C::kKBytes;
    unsigned char* v_tile = smem + (C::kGroups + grp) * C::kKBytes;
    int it = 0, ex[2] = {-64, -64};
    if constexpr (C::kTwoSweeps) {
      {
        // (sweep 2 still reads V: dV by the threads' own stores)
        float acc[Pn::kN][Pn::kP / 2] = {};
        dkv_wg_sweep<T, D, true, false>(c, it, acc, acc, ex, t, lane);
        store_wg<T, D>(dv + (size_t)bh * Tk * D, acc, c.kr, Tk, t);
      }
      float acc[Pn::kN][Pn::kP / 2] = {};
      dkv_wg_sweep<T, D, false, true>(c, it, acc, acc, ex, t, lane);
      scale_acc<T, D>(acc, ex, scale);
      if (c.live)
        store_tile<T, D>(acc, k_tile, &dk_map, c.key0, bh, grp, wq, g, t);
    } else {
      float dv_acc[Pn::kN][Pn::kP / 2] = {}, dk_acc[Pn::kN][Pn::kP / 2] = {};
      dkv_wg_sweep<T, D, true, true>(c, it, dv_acc, dk_acc, ex, t, lane);
      scale_acc<T, D>(dk_acc, ex, scale);
      if (c.live) {
        store_tile<T, D>(dv_acc, v_tile, &dv_map, c.key0, bh, grp, wq, g, t);
        store_tile<T, D>(dk_acc, k_tile, &dk_map, c.key0, bh, grp, wq, g, t);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ (bf16 / fp16): a block per (b*h, 128 query rows), the forward's blocks
// with the roles of the dK/dV kernel's tiles.
// ---------------------------------------------------------------------------

template <int D>
struct DqWg {
  using Pn = Panels<D>;
  static constexpr int kGroups = 2;  // consumer warpgroups
  static constexpr int kRows = 64;   // query rows a group
  static constexpr int kKeys = 64;   // keys a tile
  // D <= 64: every K/V tile of a 256-key head in flight at once
  static constexpr int kStages = D <= 64 ? 4 : 2;
  static constexpr int kBlocksPerSm = 1;
  // (a producer at 24 spills once it walks the items)
  static constexpr int kProducerRegs = 32, kConsumerRegs = 232;
  static constexpr int kThreads = 128 * (kGroups + 1);  // + the producer
  static constexpr int kQBytes = kRows * 2 * D;  // a group's q (dO) tile
  // a buffer: both groups' q tiles, then their dO tiles
  static constexpr int kQOBytes = 2 * kGroups * kQBytes;
  static constexpr int kKBytes = kKeys * 2 * D;  // a K (V) tile
  static constexpr int kBiasBytes = 1024;        // kKeys fp32, padded
  static constexpr int kStageBytes = 2 * kKBytes + kBiasBytes;
  // two q / dO buffers (the next item's loads while this one's dQ leaves
  // through the other), then the ring
  static constexpr int kBarOffset = 2 * kQOBytes + kStages * kStageBytes;
  // + the alignment slack; full, empty, q full, q empty barriers
  static constexpr size_t kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 4);
};

// P = 2^(S scale log2(e) + bias log2(e) - lse log2(e)) in place: s holds
// rows r0 + 8 ((i >> 1) & 1), keys k0 + 8 (i >> 2) + 2t + (i & 1); Bs the
// tile's bias x log2(e) by key (kBias), lse2 the two rows' lse x log2(e).
// Masks (kEdge) only at Tq's or Tk's edge or across the causal diagonal,
// template flags, so that the other tiles carry no per-element selects.
template <bool kEdge, bool kBias>
__device__ __forceinline__ void dq_probs(float (&s)[32], const float* Bs,
                                         const float (&lse2)[2],
                                         float scale_log2, int causal, int r0,
                                         int k0, int Tq, int Tk, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 b = make_float2(0.f, 0.f);
    if constexpr (kBias) b = *reinterpret_cast<const float2*>(Bs + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, h = e >> 1;
      float x = s[i] * scale_log2;
      if constexpr (kBias) x += (e & 1) ? b.y : b.x;
      float pe = exp2_ftz(x - lse2[h]);
      if constexpr (kEdge) {
        const int row = r0 + 8 * h, key = k0 + 8 * j + 2 * t + (e & 1);
        if (row >= Tq || key >= Tk || (causal && row < key)) pe = 0.f;
      }
      s[i] = pe;
    }
  }
}

// Persistent, as the forward: a grid of about one block an SM walks the
// work items (b*h, 128 query rows) head by head, block x taking items x, x
// + gridDim.x, ...; the producer loads the next item's q and dO into the
// other buffer and runs ahead into its K/V tiles while the consumers
// finish this one.  Each consumer warpgroup holds its 64 rows' q and dO
// tiles, lse and delta, and dQ in registers.  Per 64-key tile S = q k^T
// and dP = dO v^T (two wgmma batches, both operands K-major), P as soon as
// S is in while dP is still in flight, dS = P (dP - delta), then dQ += dS
// k with dS as hi + lo in T from the registers and k read MN-major from
// the same tile that S read.  In fp16 each query row of dS takes the
// power-of-two exponent of scale_ds_rows first.  dQ leaves through the
// group's q tile by one TMA store.  On an H100 SXM (700 W) at B 64, H 8,
// T 256, D 64 this takes 0.057 ms a bf16 call against 0.075 for the same
// code launched as a block per item (padding case; causal 0.042 against
// 0.050), from CUDA graph replays in turns (tools/flash_ab.py): one block
// an SM leaves it idle while a new block's first tiles arrive.
template <typename T, int D>
__global__ void __launch_bounds__(DqWg<D>::kThreads, DqWg<D>::kBlocksPerSm)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap dq_map,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ bias,
                      const T* __restrict__ bias_low, int BH, int H, int Tq,
                      int Tk, float scale, int causal, int n_qt) {
  using C = DqWg<D>;
  using Pn = Panels<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + C::kStages;
  uint64_t* q_full = empty + C::kStages;
  uint64_t* q_empty = q_full + 2;
  unsigned char* stages = smem + 2 * C::kQOBytes;
  const int n_items = BH * n_qt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool has_bias = bias != nullptr || bias_low != nullptr;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      // the TMA bytes' arrival, and the bias's (the producer's loads)
      sm90::mbar_init(&full[s], has_bias ? 2 : 1);
      sm90::mbar_init(&empty[s], 4 * C::kGroups);  // a consumer warp each
    }
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(&q_full[b], 1);
      sm90::mbar_init(&q_empty[b], C::kGroups);  // a thread of each group
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C::kGroups) {
    // producer: its first warp brings each item's q and dO by TMA, then K
    // and V by TMA and the bias (widened to fp32 by the warp's loads) tile
    // by tile
    sm90::regs_dec<C::kProducerRegs>();
    if (warp == 4 * C::kGroups) {
      int tile = 0;  // the ring's count of tiles over all items
      for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
        int bh, q0, n_kt;
        fwd_item<C>(w, n_qt, causal, Tk, bh, q0, n_kt);
        const int qb = n & 1;
        unsigned char* qo = smem + qb * C::kQOBytes;
        if (lane == 0) {
          if (n >= 2) sm90::mbar_wait(&q_empty[qb], ((n >> 1) - 1) & 1);
          sm90::mbar_expect_tx(&q_full[qb], C::kQOBytes);
          for (int grp = 0; grp < C::kGroups; ++grp)
            for (int pn = 0; pn < Pn::kN; ++pn) {
              const int off = grp * C::kQBytes + pn * C::kRows * Pn::kSpan;
              const int row = q0 + grp * C::kRows;
              sm90::tma_load_3d(qo + off, &q_map, &q_full[qb], pn * Pn::kP,
                                row, bh);
              sm90::tma_load_3d(qo + C::kGroups * C::kQBytes + off, &do_map,
                                &q_full[qb], pn * Pn::kP, row, bh);
            }
        }
        // the bias x log2(e) of tile kt's keys, two a lane, read one tile
        // ahead so that its latency hides behind the ring
        const BiasRow<T> br(bias, bias_low, (size_t)(bh / H) * Tk);
        float b0 = 0.f, b1 = 0.f;
        if (has_bias) {
          b0 = lane < Tk ? br.at(lane) * kLog2e : 0.f;
          b1 = lane + 32 < Tk ? br.at(lane + 32) * kLog2e : 0.f;
        }
        for (int kt = 0; kt < n_kt; ++kt, ++tile) {
          const int s = tile % C::kStages, round = tile / C::kStages;
          if (round > 0) sm90::mbar_wait(&empty[s], (round - 1) & 1);
          unsigned char* st = stages + s * C::kStageBytes;
          if (lane == 0) {
            sm90::mbar_expect_tx(&full[s], 2 * C::kKBytes);
            for (int pn = 0; pn < Pn::kN; ++pn) {
              sm90::tma_load_3d(st + pn * C::kKeys * Pn::kSpan, &k_map,
                                &full[s], pn * Pn::kP, kt * C::kKeys, bh);
              sm90::tma_load_3d(st + C::kKBytes + pn * C::kKeys * Pn::kSpan,
                                &v_map, &full[s], pn * Pn::kP, kt * C::kKeys,
                                bh);
            }
          }
          if (has_bias) {
            float* Bs = reinterpret_cast<float*>(st + 2 * C::kKBytes);
            Bs[lane] = b0;
            Bs[lane + 32] = b1;
            const int key = (kt + 1) * C::kKeys + lane;
            b0 = kt + 1 < n_kt && key < Tk ? br.at(key) * kLog2e : 0.f;
            b1 = kt + 1 < n_kt && key + 32 < Tk ? br.at(key + 32) * kLog2e
                                                 : 0.f;
            __syncwarp();  // the warp's stores before lane 0's arrival
            if (lane == 0) sm90::mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {
    sm90::regs_inc<C::kConsumerRegs>();
    const int grp = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
    const float scale_log2 = scale * kLog2e;
    int tile = 0;
    for (int w = blockIdx.x, n = 0; w < n_items; w += gridDim.x, ++n) {
      int bh, q0, n_kt;
      fwd_item<C>(w, n_qt, causal, Tk, bh, q0, n_kt);
      const int qb = n & 1;
      const int row0 = q0 + grp * C::kRows;  // the group's first row
      const int r0 = row0 + 16 * wq + g;     // this thread's rows r0, r0 + 8
      unsigned char* Qs = smem + qb * C::kQOBytes + grp * C::kQBytes;
      const unsigned char* Os = Qs + C::kGroups * C::kQBytes;
      // tiles at or past k_live hold no key the group's rows see (causal)
      const int k_live = row0 >= Tq ? 0 : causal ? row0 + C::kRows : Tk;
      // the rows' lse x log2(e) and delta
      float lse2[2], dlt[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        lse2[h] = row < Tq ? lse[(size_t)bh * Tq + row] * kLog2e : 0.f;
        dlt[h] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
      }
      float acc[Pn::kN][Pn::kP / 2] = {}, s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      int ex[2] = {-64, -64};  // fp16: dQ's rows in units of 2^ex
      sm90::mbar_wait(&q_full[qb], (n >> 1) & 1);

      for (int kt = 0; kt < n_kt; ++kt, ++tile) {
        const int si = tile % C::kStages, k0 = kt * C::kKeys;
        const unsigned char* st = stages + si * C::kStageBytes;
        sm90::mbar_wait(&full[si], (tile / C::kStages) & 1);
        if (k0 < k_live) {
          // S = q k^T, then dP = dO v^T: c_i holds row r0 + 8 ((i >> 1) &
          // 1), key k0 + 8 (i >> 2) + 2t + (i & 1)
          sm90::fence_regs(s);
          sm90::fence_regs(dp);
          sm90::wg_fence();
          dot_wg<T, D>(s, Qs, st);
          sm90::wg_commit();
          dot_wg<T, D>(dp, Os, st + C::kKBytes);
          sm90::wg_commit();
          sm90::wg_wait<1>();
          sm90::fence_regs(s);
          const float* Bs =
              reinterpret_cast<const float*>(st + 2 * C::kKBytes);
          if (k0 + C::kKeys > Tk || row0 + C::kRows > Tq ||
              (causal && k0 + C::kKeys - 1 > row0)) {
            if (has_bias)
              dq_probs<true, true>(s, Bs, lse2, scale_log2, causal, r0, k0,
                                   Tq, Tk, t);
            else
              dq_probs<true, false>(s, Bs, lse2, scale_log2, causal, r0, k0,
                                    Tq, Tk, t);
          } else if (has_bias) {
            dq_probs<false, true>(s, Bs, lse2, scale_log2, causal, r0, k0,
                                  Tq, Tk, t);
          } else {
            dq_probs<false, false>(s, Bs, lse2, scale_log2, causal, r0, k0,
                                   Tq, Tk, t);
          }
          sm90::wg_wait<0>();
          sm90::fence_regs(dp);
          // dS = P (dP - delta); dQ += dS k
#pragma unroll
          for (int i = 0; i < 32; ++i)
            dp[i] = s[i] * (dp[i] - dlt[(i >> 1) & 1]);
          if constexpr (std::is_same_v<T, __half>)
            scale_ds_rows<D>(dp, acc, ex);
          uint32_t hi[4][4], lo[4][4];
          a_hi_lo<T>(dp, hi, lo);
          fence_acc<D>(acc);
          sm90::fence_regs(hi);
          sm90::fence_regs(lo);
          sm90::wg_fence();
          acc_hi_lo<T, D>(acc, hi, lo, st);
          sm90::wg_commit();
          sm90::wg_wait<0>();
          fence_acc<D>(acc);
          sm90::fence_regs(hi);
          sm90::fence_regs(lo);
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[si]);  // the stage is free
      }

      scale_acc<T, D>(acc, ex, scale);
      // dQ through the group's q tile, which no wgmma reads any more; then
      // the buffer is free for the item after next
      if (row0 < Tq)
        store_tile<T, D>(acc, Qs, &dq_map, row0, bh, grp, wq, g, t);
      if (wq == 0 && lane == 0) sm90::mbar_arrive(&q_empty[qb]);
    }
  }
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

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias,
               void* out, void* lse, const Dims& d) {
  using C = FwdCfg<D>;
  cudaError_t e = allow_smem(flash_fwd_kernel<D>, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (d.Tq + C::kRows - 1) / C::kRows;
  flash_fwd_kernel<D><<<(unsigned)((long long)d.B * d.H * n_qt), C::kThreads,
                        C::kSmem, d.stream>>>(
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
  using C = DqCfg<D>;
  cudaError_t e = allow_smem(flash_dq_kernel<D>, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (d.Tq + C::kRows - 1) / C::kRows;
  flash_dq_kernel<D><<<(unsigned)((long long)d.B * d.H * n_qt), C::kThreads,
                       C::kSmem, d.stream>>>(
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
  using C = DkvCfg<D>;
  cudaError_t e = allow_smem(flash_dkv_kernel<D>, C::kSmem);
  if (e != cudaSuccess) return (int)e;
  const int n_kt = (d.Tk + C::kKeys - 1) / C::kKeys;
  flash_dkv_kernel<D><<<(unsigned)((long long)d.B * d.H * n_kt), C::kThreads,
                        C::kSmem, d.stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), d.H, d.Tq, d.Tk, d.scale, d.causal, n_kt);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host side of the wgmma kernels: tensor maps, built at each launch inside
// the C entry, and the register check.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver API, found at run time, so
// that the library links against the runtime alone.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T>
struct MapType;

template <>
struct MapType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kValue =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <>
struct MapType<__half> {
  static constexpr CUtensorMapDataType kValue = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// [n_heads, rows, D] of T (q, k, v, dO) in boxes of one panel x 64 rows,
// swizzled by the panel's span.  Rows past `rows` load as zeros, so a tile
// at a head's ragged end never reads the next head.
template <typename T, int D>
cudaError_t head_map(CUtensorMap* map, const void* p, int n_heads, int rows) {
  using Pn = Panels<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)n_heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)rows * D * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)Pn::kP, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      Pn::kSpan == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : Pn::kSpan == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, MapType<T>::kValue, 3, const_cast<void*>(p), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// setmaxnreg moves registers between the warpgroups of a block: the two
// consumer warpgroups' rise to consumer_regs must fit in what the producer
// warpgroup's drop to producer_regs frees, from the count the kernel
// starts with; else the rise would wait forever, so the launch is refused.
template <typename Kernel>
cudaError_t check_regs(Kernel kernel, int producer_regs, int consumer_regs,
                       int groups) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, (const void*)kernel);
  if (e != cudaSuccess) return e;
  return a.numRegs - producer_regs >= groups * (consumer_regs - a.numRegs)
             ? cudaSuccess
             : cudaErrorInvalidConfiguration;
}

template <typename T, int D>
int launch_fwd_wg(const void* q, const void* k, const void* v,
                  const void* bias, void* out, void* lse, const Dims& d) {
  using C = FwdWg<D>;
  const auto kernel = flash_fwd_wgmma_kernel<T, D>;
  const int n_heads = d.B * d.H;
  CUtensorMap q_map, k_map, v_map, out_map;
  cudaError_t e = allow_smem(kernel, C::kSmem);
  static const cudaError_t regs =
      check_regs(kernel, C::kProducerRegs, C::kConsumerRegs, C::kGroups);
  if (e == cudaSuccess) e = regs;
  if (e == cudaSuccess) e = head_map<T, D>(&q_map, q, n_heads, d.Tq);
  if (e == cudaSuccess) e = head_map<T, D>(&k_map, k, n_heads, d.Tk);
  if (e == cudaSuccess) e = head_map<T, D>(&v_map, v, n_heads, d.Tk);
  if (e == cudaSuccess) e = head_map<T, D>(&out_map, out, n_heads, d.Tq);
  if (e != cudaSuccess) return (int)e;
  const int rows = C::kGroups * C::kRows;
  const int n_qt = (d.Tq + rows - 1) / rows;
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long n_items = (long long)n_heads * n_qt;
  const long long slots = (long long)C::kBlocksPerSm * sms - 1 +
                          (C::kBlocksPerSm * sms) % 2;  // odd
  const int grid = (int)(n_items < slots ? n_items : slots);
  kernel<<<grid, C::kThreads, C::kSmem, d.stream>>>(
      q_map, k_map, v_map, out_map, bias_f32(bias, d), bias_t<T>(bias, d),
      static_cast<float*>(lse), n_heads, d.H, d.Tq, d.Tk, d.scale, d.causal,
      n_qt);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq_wg(const void* q, const void* k, const void* v,
                 const void* bias, const void* dout, const void* lse,
                 const void* delta, void* dq, const Dims& d) {
  using C = DqWg<D>;
  const auto kernel = flash_dq_wgmma_kernel<T, D>;
  const int n_heads = d.B * d.H;
  CUtensorMap q_map, do_map, k_map, v_map, dq_map;
  cudaError_t e = allow_smem(kernel, C::kSmem);
  static const cudaError_t regs =
      check_regs(kernel, C::kProducerRegs, C::kConsumerRegs, C::kGroups);
  if (e == cudaSuccess) e = regs;
  if (e == cudaSuccess) e = head_map<T, D>(&q_map, q, n_heads, d.Tq);
  if (e == cudaSuccess) e = head_map<T, D>(&do_map, dout, n_heads, d.Tq);
  if (e == cudaSuccess) e = head_map<T, D>(&k_map, k, n_heads, d.Tk);
  if (e == cudaSuccess) e = head_map<T, D>(&v_map, v, n_heads, d.Tk);
  if (e == cudaSuccess) e = head_map<T, D>(&dq_map, dq, n_heads, d.Tq);
  if (e != cudaSuccess) return (int)e;
  const int rows = C::kGroups * C::kRows;
  const int n_qt = (d.Tq + rows - 1) / rows;
  int device = 0, sms = 0;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long long n_items = (long long)n_heads * n_qt;
  const long long slots = (long long)C::kBlocksPerSm * sms - 1 +
                          (C::kBlocksPerSm * sms) % 2;  // odd
  const int grid = (int)(n_items < slots ? n_items : slots);
  kernel<<<grid, C::kThreads, C::kSmem, d.stream>>>(
      q_map, do_map, k_map, v_map, dq_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), bias_f32(bias, d), bias_t<T>(bias, d),
      n_heads, d.H, d.Tq, d.Tk, d.scale, d.causal, n_qt);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv_wg(const void* q, const void* k, const void* v,
                  const void* bias, const void* dout, const void* lse,
                  const void* delta, void* dk, void* dv, const Dims& d) {
  using C = DkvWg<D>;
  const auto kernel = flash_dkv_wgmma_kernel<T, D>;
  const int n_heads = d.B * d.H;
  CUtensorMap q_map, do_map, k_map, v_map, dk_map, dv_map;
  cudaError_t e = allow_smem(kernel, C::kSmem);
  static const cudaError_t regs =
      check_regs(kernel, C::kProducerRegs, C::kConsumerRegs, C::kGroups);
  if (e == cudaSuccess) e = regs;
  if (e == cudaSuccess) e = head_map<T, D>(&q_map, q, n_heads, d.Tq);
  if (e == cudaSuccess) e = head_map<T, D>(&do_map, dout, n_heads, d.Tq);
  if (e == cudaSuccess) e = head_map<T, D>(&k_map, k, n_heads, d.Tk);
  if (e == cudaSuccess) e = head_map<T, D>(&v_map, v, n_heads, d.Tk);
  if (e == cudaSuccess) e = head_map<T, D>(&dk_map, dk, n_heads, d.Tk);
  if (e == cudaSuccess) e = head_map<T, D>(&dv_map, dv, n_heads, d.Tk);
  if (e != cudaSuccess) return (int)e;
  const int keys = C::kGroups * C::kKeys;
  const int n_kt = (d.Tk + keys - 1) / keys;
  kernel<<<(unsigned)((long long)n_heads * n_kt), C::kThreads, C::kSmem,
           d.stream>>>(q_map, do_map, k_map, v_map, dk_map, dv_map,
                       static_cast<const float*>(lse),
                       static_cast<const float*>(delta), bias_f32(bias, d),
                       bias_t<T>(bias, d), static_cast<T*>(dv), d.H, d.Tq,
                       d.Tk, d.scale, d.causal, n_kt);
  return (int)cudaGetLastError();
}

// Blocks of one kernel that fit an SM at once (kind 0 forward, 1 dQ, 2
// dK/dV), from its threads, registers and shared memory.
template <typename Kernel>
int occupancy(Kernel kernel, int threads, size_t smem_bytes, int* blocks) {
  cudaError_t e = allow_smem(kernel, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, threads, smem_bytes);
}

template <typename T, int D>
int blocks_per_sm(int kind, int* blocks) {
  if constexpr (kIsF32<T>) {
    if (kind == 0)
      return occupancy(flash_fwd_kernel<D>, FwdCfg<D>::kThreads,
                       FwdCfg<D>::kSmem, blocks);
    if (kind == 1)
      return occupancy(flash_dq_kernel<D>, DqCfg<D>::kThreads,
                       DqCfg<D>::kSmem, blocks);
    if (kind == 2)
      return occupancy(flash_dkv_kernel<D>, DkvCfg<D>::kThreads,
                       DkvCfg<D>::kSmem, blocks);
  } else {
    if (kind == 0)
      return occupancy(flash_fwd_wgmma_kernel<T, D>, FwdWg<D>::kThreads,
                       FwdWg<D>::kSmem, blocks);
    if (kind == 1)
      return occupancy(flash_dq_wgmma_kernel<T, D>, DqWg<D>::kThreads,
                       DqWg<D>::kSmem, blocks);
    if (kind == 2)
      return occupancy(flash_dkv_wgmma_kernel<T, D>, DkvWg<D>::kThreads,
                       DkvWg<D>::kSmem, blocks);
  }
  return (int)cudaErrorInvalidValue;
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
    constexpr int kD = decltype(n)::value;
    if constexpr (kIsF32<T>) {
      return launch_fwd<kD>(q, k, v, bias, out, lse, d);
    } else {
      return launch_fwd_wg<T, kD>(q, k, v, bias, out, lse, d);
    }
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
    constexpr int kD = decltype(n)::value;
    if constexpr (kIsF32<T>) {
      return launch_dq<kD>(q, k, v, bias, dout, lse, delta, dq, d);
    } else {
      return launch_dq_wg<T, kD>(q, k, v, bias, dout, lse, delta, dq, d);
    }
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
    constexpr int kD = decltype(n)::value;
    if constexpr (kIsF32<T>) {
      return launch_dkv<kD>(q, k, v, bias, dout, lse, delta, dk, dv, d);
    } else {
      return launch_dkv_wg<T, kD>(q, k, v, bias, dout, lse, delta, dk, dv, d);
    }
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
