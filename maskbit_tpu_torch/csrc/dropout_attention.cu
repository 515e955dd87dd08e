// Training attention with in-kernel attention-probability dropout, forward and
// backward, on Hopper (sm_90a):
//     out = (keep(row, col, seed) * softmax(q k^T / sqrt(d)) / (1 - p)) v
//
// Replaces the TPU kernels of maskbit_tpu/nn/pallas_attention.py:
//   * _dropattn_fwd_kernel (dropout_attention -> _dropout_attention_fwd), by
//     attn_fwd_kernel<true>;
//   * _dropattn_bwd_kernel (_dropout_attention_bwd), by attn_bwd_delta_kernel,
//     attn_bwd_dkdv_kernel and attn_bwd_dq_kernel;
//   * _attention_kernel (fused_attention), by attn_fwd_kernel<false>: the same
//     forward with the mask compiled out.
//
// The keep mask is the TPU kernel's, bit for bit: a pure function of the
// unpadded query index (row), key index (col) and the (batch, head) slot's
// 32-bit seed, keep iff murmur3_fmix(row * 0x9E3779B1 + col * 0x85EBCA77 +
// seed * 0xC2B2AE3D) >= threshold, all uint32 arithmetic that wraps. The
// threshold min(floor(p * 2^32), 2^32 - 1) is computed by the caller on the
// host. The backward regenerates the same mask, so it never exists in memory.
//
// What bounds it on the H100. At the flagship training shape, q, k, v of
// (32, 257, 16, 64) bf16 (16.8 MB each), the forward reads three tensors and
// writes one (67 MB, 20 us at 3.35 TB/s) for 8.7 GFLOP of products (9 us at
// 989 TFLOP/s); the backward reads q, k, v, out and the incoming gradient and
// writes dq, dk, dv (135 MB, 40 us) for 21.6 GFLOP of the TPU kernel's
// products. Both are bound by device memory, so the (n, n) probabilities,
// the mask and the score gradients stay on chip: one pass over q, k and v
// forward, flash-style.
//   * Forward: one block per (batch*head, 64-query tile), 4 warps of 16
//     queries; 64-key tiles of K and V streamed through shared memory; an
//     online f32 softmax whose row sum runs over ALL keys before dropout; the
//     mask and 1/(1-p) multiply the unnormalised weights, which are rounded
//     to bf16 for the value product (the TPU kernel rounds the normalised
//     ones: a relative difference of one bf16 rounding, 2^-9); the row
//     log-sum-exp is saved, (batch*head, n) f32, for the backward.
//   * Backward, three launches, no atomics (deterministic):
//       delta = rowsum(g * out) in f32 (the identity rowsum(dw * P) = g . O
//         holds with dropout; O is the forward's bf16 output, which costs one
//         bf16 rounding of O against the TPU kernel's f32 row sum);
//       dk, dv: one block per (batch*head, 64-key tile) looping over query
//         tiles (Hopper blocks carry no state between them, so the sums over
//         queries stay inside one block);
//       dq: one block per (batch*head, 64-query tile) looping over key tiles.
//     Both recompute P from q, k and the log-sum-exp and regenerate the mask.
//     The TPU kernel's rounding points are kept: the dropped weights are
//     rounded to bf16 before dv, the score gradient before dq and dk.
// Products are bf16 mma.sync.m16n8k16 with f32 accumulation; the accumulator
// layout of one product is the A-operand layout of the next, so logits,
// weights and score gradients never leave registers. Operands read
// transposed (V, and Q, K, the gradient in the backward) come through
// ldmatrix.trans from row-major tiles.
//
// Layouts: q, k, v are (b, n, h, 64) bf16 read through strides (batch, row,
// head; the last dimension contiguous), so the QKV projection's (b, n, 3, h,
// 64) view needs no transposes. out, the incoming gradient, dq, dk and dv are
// contiguous (b, n, h, 64) bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int HD = 64;        // head dim (checked by the wrapper)
constexpr int TILE = 64;      // queries or keys per tile
constexpr int LD = HD + 8;    // padded bf16 row (144 bytes): conflict-free fragment reads
constexpr int THREADS = 128;  // 4 warps of 16 rows

struct Strides {
  long long b, n, h;  // in elements; the head dim is contiguous
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate. Fragment
// layout (PTX ISA, mma.m16n8k16), with g = lane / 4 and t = lane % 4:
//   a[0] = A[g][2t..2t+1]   a[1] = A[g+8][2t..2t+1]
//   a[2] = A[g][2t+8..+9]   a[3] = A[g+8][2t+8..+9]
//   b0 = B[2t..2t+1][g]     b1 = B[2t+8..+9][g]
//   d[0..1] = D[g][2t..2t+1]   d[2..3] = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give
// the row addresses of matrix i, and each thread receives rows 2 * (lane % 4)
// and + 1 of column lane / 4, i.e. the b0 / b1 fragment of a B operand stored
// row-major as [k][n].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// acc[j] += A(16 x 64 from the row-major accumulators s, as bf16) @ X where X
// is a row-major (64 x 64) tile in shared memory: the k dimension runs over
// X's rows, the output columns over X's columns.
__device__ __forceinline__ void mma_rows_by_tile(float (&acc)[HD / 8][4],
                                                 const float (&s)[TILE / 8][4],
                                                 const bf16* xs, int lane) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    const bf16* rows = xs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < HD / 8; j += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, rows + j * 8);
      mma_16816(acc[j], pa, r[0], r[1]);
      mma_16816(acc[j + 1], pa, r[2], r[3]);
    }
  }
}

// s[j] = A(16 rows x 64, fragments a) @ X^T where X is a row-major (64 x 64)
// tile in shared memory: output column c is X's row c.
__device__ __forceinline__ void mma_frag_by_tile_t(float (&s)[TILE / 8][4],
                                                   const uint32_t (&a)[HD / 16][4],
                                                   const bf16* xs, int g, int t) {
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    const bf16* xr = xs + (j * 8 + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) mma_16816(s[j], a[kk], ld32(xr + kk * 16), ld32(xr + kk * 16 + 8));
  }
}

// A fragments of the warp's 16 rows of a row-major (64 x 64) tile.
__device__ __forceinline__ void load_frag(uint32_t (&a)[HD / 16][4], const bf16* xs, int warp,
                                          int g, int t) {
  const bf16* xw = xs + warp * 16 * LD;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    a[kk][0] = ld32(xw + g * LD + kk * 16 + 2 * t);
    a[kk][1] = ld32(xw + (g + 8) * LD + kk * 16 + 2 * t);
    a[kk][2] = ld32(xw + g * LD + kk * 16 + 2 * t + 8);
    a[kk][3] = ld32(xw + (g + 8) * LD + kk * 16 + 2 * t + 8);
  }
}

// rows r0 .. r0 + 63 of one (batch, head) slice into a padded row-major
// tile; rows past n are zero-filled. `row_stride` in elements.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int r0, int n) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = threadIdx.x; c < TILE * (HD / 8); c += THREADS) {
    const int r = c >> 3, cc = (c & 7) * 8;
    const uint4 v = r0 + r < n
        ? *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + cc)
        : zero;
    *reinterpret_cast<uint4*>(dst + r * LD + cc) = v;
  }
}

// The TPU kernel's keep hash, without the seed term (`seed_mix` is
// seed * 0xC2B2AE3D, computed once per block).
__device__ __forceinline__ uint32_t keep_hash(uint32_t row, uint32_t col, uint32_t seed_mix) {
  uint32_t x = row * 0x9E3779B1u + col * 0x85EBCA77u + seed_mix;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// ------------------------------------------------------------- forward ----

template <bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, Strides st, const int* __restrict__ seeds,
                bf16* __restrict__ out, float* __restrict__ lse, int n, int H, float scale,
                uint32_t threshold, float keep_scale) {
  __shared__ __align__(128) bf16 qs[TILE * LD];
  __shared__ __align__(128) bf16 ks[TILE * LD];
  __shared__ __align__(128) bf16 vs[TILE * LD];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long off = b * st.b + h * st.h;
  const int q0 = blockIdx.x * TILE;
  const uint32_t row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t seed_mix = DROPOUT ? static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du : 0u;

  load_tile(qs, q + off, st.n, q0, n);
  __syncthreads();
  uint32_t qa[HD / 16][4];
  load_frag(qa, qs, warp, g, t);

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;

  for (int kv0 = 0; kv0 < n; kv0 += TILE) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(ks, k + off, st.n, kv0, n);
    load_tile(vs, v + off, st.n, kv0, n);
    __syncthreads();

    float s[TILE / 8][4];
    mma_frag_by_tile_t(s, qa, ks, g, t);

    // online softmax over all keys; the four lanes of a group share a row
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = kv0 + j * 8 + 2 * t + (e & 1) < n;
        s[j][e] = valid ? s[j][e] * scale : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
      }
    float alpha[2], tsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m_run[i], tmax[i]);  // finite: key kv0 is valid
      alpha[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_run[e >> 1]);
        tsum[e >> 1] += p;  // the row sum runs before dropout
        if (DROPOUT) {
          const uint32_t col = kv0 + j * 8 + 2 * t + (e & 1);
          s[j][e] = keep_hash(row0 + 8 * (e >> 1), col, seed_mix) >= threshold ? p * keep_scale
                                                                                 : 0.0f;
        } else {
          s[j][e] = p;
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tsum[i] += __shfl_xor_sync(0xffffffffu, tsum[i], 1);
      tsum[i] += __shfl_xor_sync(0xffffffffu, tsum[i], 2);
      l_run[i] = l_run[i] * alpha[i] + tsum[i];
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    mma_rows_by_tile(o, s, vs, lane);  // O += bf16(weights) V
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row < n) {
      const float inv = 1.0f / l_run[i];
      bf16* dst = out + (((long long)b * n + row) * H + h) * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
      if (lse != nullptr && t == 0) lse[(long long)bh * n + row] = m_run[i] + logf(l_run[i]);
    }
  }
}

// ------------------------------------------------------------ backward ----

// delta[bh, row] = sum_d g[b, row, h, d] * out[b, row, h, d], f32; one warp
// per (b, row, h) row of 64 values.
__global__ void __launch_bounds__(THREADS)
attn_bwd_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ grad,
                      float* __restrict__ delta, int n, int H, long long rows) {
  const long long r = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + r * HD + 2 * lane));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(grad + r * HD + 2 * lane));
  float s = a.x * c.x + a.y * c.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = static_cast<int>(r % H);
    const long long bn = r / H;  // b * n + row
    const long long b = bn / n, row = bn % n;
    delta[(b * H + h) * n + row] = s;
  }
}

// dk, dv for one (batch*head, 64-key tile); each warp owns 16 keys and loops
// over all query tiles. Products are taken transposed (keys as rows):
//   S^T = K Q^T, dP^T = V G^T, P^T = exp(S^T * scale - lse[query]),
//   dV += bf16(keep * P^T / (1-p)) G,
//   dS^T = P^T (keep * dP^T / (1-p) - delta[query]) * scale, dK += bf16(dS^T) Q.
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, Strides st, const bf16* __restrict__ grad,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ seeds, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int n, int H, float scale, uint32_t threshold,
                     float keep_scale) {
  __shared__ __align__(128) bf16 qs[TILE * LD];
  __shared__ __align__(128) bf16 gs[TILE * LD];
  __shared__ float lse_s[TILE];
  __shared__ float delta_s[TILE];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long off = b * st.b + h * st.h;
  const bf16* gb = grad + ((long long)b * n * H + h) * HD;  // contiguous (b, n, h, d)
  const long long g_row = (long long)H * HD;
  const int k0 = blockIdx.x * TILE;
  const uint32_t key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const uint32_t seed_mix = static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du;

  // the block's K and V tiles, once, into A fragments
  load_tile(qs, k + off, st.n, k0, n);
  load_tile(gs, v + off, st.n, k0, n);
  __syncthreads();
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_frag(ka, qs, warp, g, t);
  load_frag(va, gs, warp, g, t);

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;

  for (int q0 = 0; q0 < n; q0 += TILE) {
    __syncthreads();  // every warp is done with the previous tiles (and the fragments above)
    load_tile(qs, q + off, st.n, q0, n);
    load_tile(gs, gb, g_row, q0, n);
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      const bool valid = q0 + i < n;
      lse_s[i] = valid ? lse[(long long)bh * n + q0 + i] : 0.0f;
      delta_s[i] = valid ? delta[(long long)bh * n + q0 + i] : 0.0f;
    }
    __syncthreads();

    float s[TILE / 8][4], dp[TILE / 8][4];
    mma_frag_by_tile_t(s, ka, qs, g, t);   // S^T
    mma_frag_by_tile_t(dp, va, gs, g, t);  // dP^T
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);  // query within the tile
        const bool valid = q0 + qi < n;
        const float p = valid ? expf(s[j][e] * scale - lse_s[qi]) : 0.0f;
        const bool keep =
            keep_hash(q0 + qi, key0 + 8 * (e >> 1), seed_mix) >= threshold;
        const float dw = keep ? dp[j][e] * keep_scale : 0.0f;
        s[j][e] = keep ? p * keep_scale : 0.0f;           // dropped weights, for dV
        dp[j][e] = p * (dw - delta_s[qi]) * scale;        // score gradient, for dK
      }
    mma_rows_by_tile(dv_acc, s, gs, lane);
    mma_rows_by_tile(dk_acc, dp, qs, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key < n) {
      const long long o = (((long long)b * n + key) * H + h) * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + o + j * 8) =
            __floats2bfloat162_rn(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + o + j * 8) =
            __floats2bfloat162_rn(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
      }
    }
  }
}

// dq for one (batch*head, 64-query tile); each warp owns 16 queries and loops
// over all key tiles: S = Q K^T, dP = G V^T, P = exp(S * scale - lse),
// dS = P (keep * dP / (1-p) - delta) * scale, dQ += bf16(dS) K.
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, Strides st, const bf16* __restrict__ grad,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const int* __restrict__ seeds, bf16* __restrict__ dq, int n, int H,
                   float scale, uint32_t threshold, float keep_scale) {
  __shared__ __align__(128) bf16 ks[TILE * LD];
  __shared__ __align__(128) bf16 vs[TILE * LD];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long off = b * st.b + h * st.h;
  const bf16* gb = grad + ((long long)b * n * H + h) * HD;
  const int q0 = blockIdx.x * TILE;
  const uint32_t row0 = q0 + warp * 16 + g;
  const uint32_t seed_mix = static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du;

  // the block's Q and gradient tiles, once, into A fragments
  load_tile(ks, q + off, st.n, q0, n);
  load_tile(vs, gb, (long long)H * HD, q0, n);
  __syncthreads();
  uint32_t qa[HD / 16][4], ga[HD / 16][4];
  load_frag(qa, ks, warp, g, t);
  load_frag(ga, vs, warp, g, t);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool valid = row0 + 8 * i < static_cast<uint32_t>(n);
    lse_r[i] = valid ? lse[(long long)bh * n + row0 + 8 * i] : 0.0f;
    delta_r[i] = valid ? delta[(long long)bh * n + row0 + 8 * i] : 0.0f;
  }

  float dq_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.0f;

  for (int kv0 = 0; kv0 < n; kv0 += TILE) {
    __syncthreads();
    load_tile(ks, k + off, st.n, kv0, n);
    load_tile(vs, v + off, st.n, kv0, n);
    __syncthreads();

    float s[TILE / 8][4], dp[TILE / 8][4];
    mma_frag_by_tile_t(s, qa, ks, g, t);   // S
    mma_frag_by_tile_t(dp, ga, vs, g, t);  // dP
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t col = kv0 + j * 8 + 2 * t + (e & 1);
        const float p = col < static_cast<uint32_t>(n) ? expf(s[j][e] * scale - lse_r[e >> 1]) : 0.0f;
        const bool keep = keep_hash(row0 + 8 * (e >> 1), col, seed_mix) >= threshold;
        const float dw = keep ? dp[j][e] * keep_scale : 0.0f;
        s[j][e] = p * (dw - delta_r[e >> 1]) * scale;
      }
    mma_rows_by_tile(dq_acc, s, ks, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row < n) {
      bf16* dst = dq + (((long long)b * n + row) * H + h) * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(dq_acc[j][2 * i], dq_acc[j][2 * i + 1]);
    }
  }
}

}  // namespace

// Forward on `stream`. q, k, v: (B, n, H, 64) bf16 with element strides
// (sb, sn, sh); out: contiguous (B, n, H, 64) bf16; lse: (B*H, n) f32 or
// null; seeds: (B*H,) int32 (the uint32 seeds' bits), ignored when
// dropout == 0, which compiles the mask out. Returns the launch error
// (cudaSuccess == 0).
extern "C" int mb_dropout_attention_fwd(const void* q, const void* k, const void* v,
                                        long long sb, long long sn, long long sh,
                                        const void* seeds, void* out, void* lse, int B, int n,
                                        int H, unsigned int threshold, float keep_scale,
                                        int dropout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st{sb, sn, sh};
  const dim3 grid((n + TILE - 1) / TILE, B * H);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  if (dropout) {
    attn_fwd_kernel<true><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), st,
        static_cast<const int*>(seeds), static_cast<bf16*>(out), static_cast<float*>(lse), n, H,
        scale, threshold, keep_scale);
  } else {
    attn_fwd_kernel<false><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), st,
        nullptr, static_cast<bf16*>(out), static_cast<float*>(lse), n, H, scale, 0u, 1.0f);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward on `stream`: dq, dk, dv (contiguous (B, n, H, 64) bf16) from q,
// k, v (strided as in the forward), the forward's out and lse, the incoming
// gradient grad (contiguous bf16) and the seeds. delta: (B*H, n) f32
// scratch. Returns the first launch error (cudaSuccess == 0).
extern "C" int mb_dropout_attention_bwd(const void* q, const void* k, const void* v,
                                        long long sb, long long sn, long long sh,
                                        const void* out, const void* grad, const void* lse,
                                        const void* seeds, void* dq, void* dk, void* dv,
                                        void* delta, int B, int n, int H,
                                        unsigned int threshold, float keep_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st{sb, sn, sh};
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const long long rows = static_cast<long long>(B) * n * H;
  cudaError_t err;

  attn_bwd_delta_kernel<<<static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32)),
                          THREADS, 0, s>>>(static_cast<const bf16*>(out),
                                           static_cast<const bf16*>(grad),
                                           static_cast<float*>(delta), n, H, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((n + TILE - 1) / TILE, B * H);
  attn_bwd_dkdv_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), st,
      static_cast<const bf16*>(grad), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seeds), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n, H, scale, threshold, keep_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  attn_bwd_dq_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), st,
      static_cast<const bf16*>(grad), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(seeds), static_cast<bf16*>(dq), n,
      H, scale, threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}
