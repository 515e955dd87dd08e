// Postnorm BERT attention block for inference on Hopper (sm_90a):
//     out = LayerNorm(x + OutProj(MultiHeadAttention(QKV(x))))
//
// Replaces the TPU kernel maskbit_tpu/nn/pallas_attention.py::_attention_block_kernel
// (reached through fused_attention_block -> _fused_attention_block_local).
// It keeps that kernel's rounding points: qkv is rounded to bf16 after the f32
// bias add; the softmax runs in f32 and its weights are rounded to bf16 before
// the value product; the concatenated head outputs are rounded to bf16 before
// the output projection; the output projection stays f32 through the bias,
// the residual add and the LayerNorm (eps from the caller), and only the
// normalised row is rounded to bf16.
//
// What bounds it on the H100. At serving shapes (x is (b*n, E) with
// b*n ~ 4k-12k rows, E = 1024) the two projections carry 4*E^2 multiply-adds
// per token: they are matmul-bound and belong on the tensor cores. The
// attention itself is small (n = 257, d = 64: about a tenth of the block's
// FLOPs) and is bound by bandwidth and latency, not by arithmetic. The TPU
// kernel kept the whole (n, 3E) f32 qkv and the (group, n, n) f32 logits in
// VMEM; neither fits the 227 KB of shared memory an SM offers, so this is a
// chain of four kernels instead of one:
//   1. gemm_bias_kernel: qkv = bf16(x @ Wqkv^T + bqkv), bf16 tensor-core
//      products (ldmatrix + mma.sync.m16n8k16) with f32 accumulation,
//      128x256x32 block tiles (8 warps of 64x64), a three-stage cp.async
//      ring, the epilogue straight from the accumulator registers.
//   2. attention_kernel: one block per (batch, head, 64-query tile). It streams
//      64-key tiles of K and V with an online (running max and sum) f32
//      softmax, so that any n works (257 and 1025 included); bf16
//      mma.sync.m16n8k16 products keep logits, weights and the output in
//      registers. Ragged keys are masked by bounds, not by padding: rows past
//      n are zero-filled and their logits are -inf.
//   3. gemm_bias_kernel again: y = x + (attn @ Wo^T + bo), written as an f32
//      scratch (b*n, E) so the projection is never rounded before the norm.
//   4. layernorm_kernel: one block per row, f32 in, bf16 out.
// The qkv and attention scratch tensors round-trip through device memory
// (about 8 bytes per token per channel); at these sizes that is a few
// percent of the projections' time. Fusing them away (wgmma, TMA, a
// persistent kernel) is later work.
//
// Weights are in the PyTorch nn.Linear layout, (out_features, in_features)
// row-major, i.e. the transpose of the JAX kernels; the wrapper passes
// in_proj_weight and out_proj.weight as they are stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------------------------- GEMM ----

constexpr int GM_BM = 128;
constexpr int GM_BN = 256;
constexpr int GM_BK = 32;
constexpr int GM_LD = GM_BK + 8;  // padded row, 80 bytes: 16-byte chunks, no bank conflicts
constexpr int GM_STAGES = 3;      // cp.async ring depth
constexpr int GM_THREADS = 256;   // 8 warps: 2 along M x 4 along N, 64x64 each
constexpr int GM_TM = GM_BM / 2 / 16;  // m16 tiles per warp (warp tile 64 x 64)
constexpr int GM_TN = GM_BN / 4 / 8;   // n8 tiles per warp
constexpr int GM_STAGE = (GM_BM + GM_BN) * GM_LD;
constexpr int GM_SMEM_BYTES = GM_STAGES * GM_STAGE * 2;  // 92,160: dynamic shared memory

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_size = valid ? 16 : 0;  // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_size));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and each thread receives row lane / 4, columns
// 2 * (lane % 4) .. + 1 of every matrix (the mma fragment layout below).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate. Fragment
// layout (PTX ISA, mma.m16n8k16), with g = lane / 4 and t = lane % 4:
//   a[0] = A[g][2t..2t+1]   a[1] = A[g+8][2t..2t+1]
//   a[2] = A[g][2t+8..+9]   a[3] = A[g+8][2t+8..+9]
//   b[0] = B[2t..2t+1][g]   b[1] = B[2t+8..+9][g]
//   d[0..1] = D[g][2t..2t+1]   d[2..3] = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// C[M, N] = A[M, K] @ W[N, K]^T + bias[N] (f32 accumulate), then either
//   out_bf16[m, n] = bf16(C)                         (resid == nullptr), or
//   out_f32[m, n]  = C + float(resid[m, n])          (resid != nullptr).
// Requires K % 8 == 0, N % 8 == 0 and 16-byte aligned rows and bias.
__global__ void __launch_bounds__(GM_THREADS, 1)
gemm_bias_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 const float* __restrict__ bias, const bf16* __restrict__ resid,
                 bf16* __restrict__ out_bf16, float* __restrict__ out_f32,
                 int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char gm_smem[];
  bf16* smem = reinterpret_cast<bf16*>(gm_smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * GM_BM;
  const int n0 = blockIdx.x * GM_BN;
  const int wm = (warp >> 2) * (GM_TM * 16);
  const int wn = (warp & 3) * (GM_TN * 8);
  const int ktiles = (K + GM_BK - 1) / GM_BK;

  // one k-tile of A (BM x BK) and W (BN x BK) into a ring slot; rows past
  // M or N and columns past K are zero-filled
  auto load_tile = [&](int kt) {
    if (kt < ktiles) {
      bf16* as = smem + (kt % GM_STAGES) * GM_STAGE;
      bf16* bs = as + GM_BM * GM_LD;
      const int k0 = kt * GM_BK;
      for (int c = tid; c < GM_BM * (GM_BK / 8); c += GM_THREADS) {
        const int r = c >> 2, kc = (c & 3) * 8;
        const int gr = m0 + r, gk = k0 + kc;
        const bool ok = gr < M && gk < K;
        cp_async16(as + r * GM_LD + kc, ok ? A + (size_t)gr * K + gk : A, ok);
      }
      for (int c = tid; c < GM_BN * (GM_BK / 8); c += GM_THREADS) {
        const int r = c >> 2, kc = (c & 3) * 8;
        const int gn = n0 + r, gk = k0 + kc;
        const bool ok = gn < N && gk < K;
        cp_async16(bs + r * GM_LD + kc, ok ? W + (size_t)gn * K + gk : W, ok);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  float acc[GM_TM][GM_TN][4];
#pragma unroll
  for (int i = 0; i < GM_TM; ++i)
#pragma unroll
    for (int j = 0; j < GM_TN; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

#pragma unroll
  for (int s = 0; s < GM_STAGES - 1; ++s) load_tile(s);
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<GM_STAGES - 2>();  // tile kt has landed (for this thread)
    __syncthreads();                 // ... for every thread; slot kt-1 is free
    load_tile(kt + GM_STAGES - 1);
    const bf16* as = smem + (kt % GM_STAGES) * GM_STAGE;
    const bf16* bs = as + GM_BM * GM_LD;
#pragma unroll
    for (int kk = 0; kk < GM_BK; kk += 16) {
      // A: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15) of each m16 tile
      uint32_t af[GM_TM][4];
#pragma unroll
      for (int i = 0; i < GM_TM; ++i)
        ldmatrix_x4(af[i], as + (wm + i * 16 + (lane & 15)) * GM_LD + kk + (lane >> 4) * 8);
      // W rows are B's columns: matrices (n 0-7, k 0-7), (n 0-7, k 8-15),
      // (n 8-15, k 0-7), (n 8-15, k 8-15) give two n8 tiles' b0, b1
      uint32_t bfr[GM_TN][2];
#pragma unroll
      for (int j = 0; j < GM_TN; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, bs + (wn + j * 8 + (lane & 7) + (lane >> 4) * 8) * GM_LD + kk +
                           ((lane >> 3) & 1) * 8);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < GM_TM; ++i)
#pragma unroll
        for (int j = 0; j < GM_TN; ++j) mma_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
  }
  cp_async_wait<0>();

  // Epilogue from registers: rows g and g + 8 of each m16 tile, columns
  // 2t and 2t + 1 of each n8 tile (N % 8 == 0, so a pair is in or out).
#pragma unroll
  for (int j = 0; j < GM_TN; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= N) continue;
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int i = 0; i < GM_TM; ++i) {
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int row = m0 + wm + i * 16 + g + 8 * hrow;
        if (row >= M) continue;
        const float v0 = acc[i][j][2 * hrow] + bb.x;
        const float v1 = acc[i][j][2 * hrow + 1] + bb.y;
        const size_t o = (size_t)row * N + col;
        if (resid != nullptr) {
          const float2 rr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + o));
          *reinterpret_cast<float2*>(out_f32 + o) = make_float2(v0 + rr.x, v1 + rr.y);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out_bf16 + o) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// ----------------------------------------------------------- attention ----

constexpr int AT_D = 64;        // head dim (checked by the wrapper)
constexpr int AT_BQ = 64;       // queries per block, 16 per warp
constexpr int AT_BKV = 64;      // keys per streamed tile
constexpr int AT_LD = AT_D + 8; // padded bf16 row (144 bytes): conflict-free fragment reads
constexpr int AT_THREADS = 128;

// qkv: (B, n, 3E) bf16 with q | k | v column blocks, head h at columns h*64.
// out: (B, n, E) bf16, head h at columns h*64.
// Each warp owns 16 queries; logits, softmax weights and the output
// accumulator stay in registers (the mma accumulator layout doubles as the
// next product's A-operand layout), so only Q, K and V pass through shared
// memory. V is stored transposed so its B fragments are 32-bit reads.
__global__ void __launch_bounds__(AT_THREADS)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                 int n, int E, int H, float scale) {
  __shared__ __align__(128) bf16 qs[AT_BQ * AT_LD];
  __shared__ __align__(128) bf16 ks[AT_BKV * AT_LD];
  __shared__ __align__(128) bf16 vt[AT_D * AT_LD];  // vt[d][key]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * AT_BQ;
  const size_t row_stride = (size_t)3 * E;
  const bf16* base = qkv + (size_t)b * n * row_stride;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Q tile, row-major; rows past n are zero-filled
  for (int c = tid; c < AT_BQ * (AT_D / 8); c += AT_THREADS) {
    const int r = c >> 3, cc = (c & 7) * 8;
    const uint4 v = q0 + r < n
        ? *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * row_stride + h * AT_D + cc)
        : zero;
    *reinterpret_cast<uint4*>(qs + r * AT_LD + cc) = v;
  }
  __syncthreads();
  const bf16* qw = qs + warp * 16 * AT_LD;
  uint32_t qa[AT_D / 16][4];
#pragma unroll
  for (int kk = 0; kk < AT_D / 16; ++kk) {
    qa[kk][0] = ld32(qw + g * AT_LD + kk * 16 + 2 * t);
    qa[kk][1] = ld32(qw + (g + 8) * AT_LD + kk * 16 + 2 * t);
    qa[kk][2] = ld32(qw + g * AT_LD + kk * 16 + 2 * t + 8);
    qa[kk][3] = ld32(qw + (g + 8) * AT_LD + kk * 16 + 2 * t + 8);
  }

  // running max and sum for rows g and g + 8, and the 16 x 64 output
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  float o[AT_D / 8][4];
#pragma unroll
  for (int j = 0; j < AT_D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;

  for (int kv0 = 0; kv0 < n; kv0 += AT_BKV) {
    __syncthreads();  // every warp is done with the previous K/V tile
    // K row-major (key, d); V transposed (d, key); keys past n zero-filled.
    // Consecutive threads take consecutive K chunks of a row, and
    // consecutive keys of V, so that the transposed stores do not collide.
    for (int c = tid; c < AT_BKV * (AT_D / 8); c += AT_THREADS) {
      const int r = c >> 3, cc = (c & 7) * 8;
      const uint4 v = kv0 + r < n
          ? *reinterpret_cast<const uint4*>(base + (size_t)(kv0 + r) * row_stride + E + h * AT_D + cc)
          : zero;
      *reinterpret_cast<uint4*>(ks + r * AT_LD + cc) = v;
    }
    for (int c = tid; c < AT_BKV * (AT_D / 8); c += AT_THREADS) {
      const int r = c & (AT_BKV - 1), cc = (c / AT_BKV) * 8;
      uint4 v = kv0 + r < n
          ? *reinterpret_cast<const uint4*>(base + (size_t)(kv0 + r) * row_stride + 2 * E + h * AT_D + cc)
          : zero;
      const bf16* e8 = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(cc + e) * AT_LD + r] = e8[e];
    }
    __syncthreads();

    // logits S = Q K^T: 8 n-tiles of 8 keys; B[d][key] = K[key][d]
    float sfr[AT_BKV / 8][4];
#pragma unroll
    for (int j = 0; j < AT_BKV / 8; ++j) {
      sfr[j][0] = sfr[j][1] = sfr[j][2] = sfr[j][3] = 0.0f;
      const bf16* kr = ks + (j * 8 + g) * AT_LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < AT_D / 16; ++kk)
        mma_16816(sfr[j], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    // online softmax; the four lanes of a group share rows g and g + 8
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < AT_BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = kv0 + j * 8 + 2 * t + (e & 1) < n;
        sfr[j][e] = valid ? sfr[j][e] * scale : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], sfr[j][e]);
      }
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
    for (int j = 0; j < AT_BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sfr[j][e] = expf(sfr[j][e] - m_run[e >> 1]);
        tsum[e >> 1] += sfr[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tsum[i] += __shfl_xor_sync(0xffffffffu, tsum[i], 1);
      tsum[i] += __shfl_xor_sync(0xffffffffu, tsum[i], 2);
      l_run[i] = l_run[i] * alpha[i] + tsum[i];
    }

    // O = alpha * O + P V, with the bf16-rounded weights as the A operand
#pragma unroll
    for (int j = 0; j < AT_D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < AT_BKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sfr[2 * kk][0], sfr[2 * kk][1]),
                              pack_bf16(sfr[2 * kk][2], sfr[2 * kk][3]),
                              pack_bf16(sfr[2 * kk + 1][0], sfr[2 * kk + 1][1]),
                              pack_bf16(sfr[2 * kk + 1][2], sfr[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < AT_D / 8; ++j) {
        const bf16* vr = vt + (j * 8 + g) * AT_LD + kk * 16 + 2 * t;
        mma_16816(o[j], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float inv[2] = {1.0f / l_run[0], 1.0f / l_run[1]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + warp * 16 + g + 8 * i;
    if (q < n) {
      bf16* dst = out + ((size_t)b * n + q) * E + h * AT_D + 2 * t;
#pragma unroll
      for (int j = 0; j < AT_D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[j][2 * i] * inv[i], o[j][2 * i + 1] * inv[i]);
    }
  }
}

// ----------------------------------------------------------- LayerNorm ----

constexpr int LN_THREADS = 256;
constexpr int LN_VEC = 4;  // float4 per thread per pass; E <= 4 * 4 * 256

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red is reused between calls
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < LN_THREADS / 32; ++w) t += red[w];
  return t;
}

// out[row] = bf16((y - mean) * rsqrt(var + eps) * gamma + beta), f32 math.
// Requires E % 4 == 0, E <= 4096 and 16-byte aligned rows.
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const float* __restrict__ y, const float* __restrict__ gamma,
                 const float* __restrict__ beta, bf16* __restrict__ out, int E, float eps) {
  __shared__ float red[LN_THREADS / 32];
  const float* yr = y + (size_t)blockIdx.x * E;
  float4 v[LN_VEC];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < LN_VEC; ++k) {
    const int i = (threadIdx.x + k * LN_THREADS) * 4;
    v[k] = i < E ? *reinterpret_cast<const float4*>(yr + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  }
  const float mean = block_sum(s, red) / E;
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < LN_VEC; ++k) {
    const int i = (threadIdx.x + k * LN_THREADS) * 4;
    if (i < E) {
      const float a = v[k].x - mean, b = v[k].y - mean, c = v[k].z - mean, d = v[k].w - mean;
      q += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / E + eps);
  bf16* orow = out + (size_t)blockIdx.x * E;
#pragma unroll
  for (int k = 0; k < LN_VEC; ++k) {
    const int i = (threadIdx.x + k * LN_THREADS) * 4;
    if (i < E) {
      const float4 g = *reinterpret_cast<const float4*>(gamma + i);
      const float4 bb = *reinterpret_cast<const float4*>(beta + i);
      *reinterpret_cast<__nv_bfloat162*>(orow + i) = __floats2bfloat162_rn(
          (v[k].x - mean) * rstd * g.x + bb.x, (v[k].y - mean) * rstd * g.y + bb.y);
      *reinterpret_cast<__nv_bfloat162*>(orow + i + 2) = __floats2bfloat162_rn(
          (v[k].z - mean) * rstd * g.z + bb.z, (v[k].w - mean) * rstd * g.w + bb.w);
    }
  }
}

}  // namespace

// Runs the chain on `stream`. x, out: (B*n, E) bf16; w_qkv: (3E, E) bf16;
// w_o: (E, E) bf16; b_qkv (3E), b_o, ln_g, ln_b (E) f32. Scratch, allocated
// by the caller: qkv (B*n, 3E) bf16, attn (B*n, E) bf16, y (B*n, E) f32.
// Returns the first launch error (cudaSuccess == 0 when all four launched).
extern "C" int mb_attention_block(const void* x, const void* w_qkv, const void* b_qkv,
                                  const void* w_o, const void* b_o, const void* ln_g,
                                  const void* ln_b, void* qkv, void* attn, void* y, void* out,
                                  int B, int n, int E, int H, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * n;
  cudaError_t err;
  // Dynamic shared memory above 48 KB needs an opt-in, which holds per
  // device: set it on every call, for whichever device is current.
  err = cudaFuncSetAttribute(gemm_bias_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GM_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);

  dim3 g_qkv((3 * E + GM_BN - 1) / GM_BN, (M + GM_BM - 1) / GM_BM);
  gemm_bias_kernel<<<g_qkv, GM_THREADS, GM_SMEM_BYTES, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_qkv),
      static_cast<const float*>(b_qkv), nullptr, static_cast<bf16*>(qkv), nullptr, M, 3 * E, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  dim3 g_att((n + AT_BQ - 1) / AT_BQ, B * H);
  attention_kernel<<<g_att, AT_THREADS, 0, s>>>(static_cast<const bf16*>(qkv),
                                                static_cast<bf16*>(attn), n, E, H,
                                                1.0f / sqrtf(static_cast<float>(AT_D)));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  dim3 g_out((E + GM_BN - 1) / GM_BN, (M + GM_BM - 1) / GM_BM);
  gemm_bias_kernel<<<g_out, GM_THREADS, GM_SMEM_BYTES, s>>>(
      static_cast<const bf16*>(attn), static_cast<const bf16*>(w_o),
      static_cast<const float*>(b_o), static_cast<const bf16*>(x), nullptr,
      static_cast<float*>(y), M, E, E);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  layernorm_kernel<<<M, LN_THREADS, 0, s>>>(static_cast<const float*>(y),
                                            static_cast<const float*>(ln_g),
                                            static_cast<const float*>(ln_b),
                                            static_cast<bf16*>(out), E, eps);
  return static_cast<int>(cudaGetLastError());
}
