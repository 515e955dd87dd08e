// The attention forward on Hopper (sm_90a), shared by two libraries:
//   * csrc/dropout_attention.cu: attn_fwd_kernel<true> replaces the TPU kernel
//     _dropattn_fwd_kernel (maskbit_tpu/nn/pallas_attention.py, dropout_attention
//     -> _dropout_attention_fwd), and attn_fwd_kernel<false> replaces
//     _attention_kernel (fused_attention);
//   * csrc/attention_block.cu: attn_fwd_kernel<false> is the attention core of
//     the serving block, over its QKV projection's output.
// See dropout_attention.cu for the design and what bounds it.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int HD = 64;                      // head dim (checked by the wrappers)
constexpr int TILE = 64;                    // queries or keys per tile: wgmma's M
constexpr int TILE_BYTES = TILE * HD * 2;   // one bf16 tile, 8 KB, 64 rows of 128 B
constexpr int CONSUMERS = 128;              // one warpgroup
constexpr int THREADS = CONSUMERS + 32;     // and one producer warp
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The consumer warpgroup's own barrier (the producer warp does not take part).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// The murmur3 finaliser of the TPU kernel's keep hash; the callers form its
// argument row * 0x9E3779B1 + col * 0x85EBCA77 + seed * 0xC2B2AE3D from
// per-row and per-column terms computed once.
__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Shared memory: Q | K[0] V[0] | K[1] V[1] | barriers.
constexpr int FWD_SMEM = TILE_BYTES * (1 + 2 * STAGES) + 64 + 1024;

template <bool DROPOUT>
__global__ void __launch_bounds__(THREADS, 3)
attn_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const int* __restrict__ seeds,
                bf16* __restrict__ out, float* __restrict__ lse, int n, int H, float scale_log2,
                uint32_t threshold, float keep_scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + TILE_BYTES * (1 + 2 * STAGES));
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  auto ks = [&](int s) { return reinterpret_cast<bf16*>(smem + TILE_BYTES * (1 + 2 * s)); };
  auto vs = [&](int s) { return reinterpret_cast<bf16*>(smem + TILE_BYTES * (2 + 2 * s)); };

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TILE;
  const int ntiles = (n + TILE - 1) / TILE;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warp: one lane issues every copy
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, TILE_BYTES);
      tma_load_tile(qs, &tq, q_full, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * TILE_BYTES);
        tma_load_tile(ks(s), &tk, &full[s], t * TILE, h, b);
        tma_load_tile(vs(s), &tv, &full[s], t * TILE, h, b);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const uint32_t row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t seed_mix = DROPOUT ? static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du : 0u;
  const uint32_t rmix[2] = {row0 * 0x9E3779B1u, (row0 + 8) * 0x9E3779B1u};

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;

  mbar_wait(q_full, 0);
  const uint64_t dq_desc = desc_kmajor(qs);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const int kv0 = t * TILE;
    mbar_wait(&full[s], (t / STAGES) & 1);

    float sc[32];
    fence_regs(o);
    wgmma_fence();
    const uint64_t dk_desc = desc_kmajor(ks(s));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sc, dq_desc + 2 * kk, dk_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax over all keys in log2 units; the 4 lanes of a group share a row
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool valid = kv0 + 8 * (i >> 2) + 2 * c + (i & 1) < n;
      sc[i] = valid ? sc[i] * scale_log2 : -INFINITY;
      tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
    }
    float alpha[2], tsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m_run[r], tmax[r]);  // finite: key kv0 is valid
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(sc[i] - m_run[r]);  // 0 past n
      tsum[r] += p;  // the row sum runs before dropout
      if (DROPOUT) {
        const uint32_t col = kv0 + 8 * (i >> 2) + 2 * c + (i & 1);
        sc[i] = fmix(rmix[r] + col * 0x85EBCA77u + seed_mix) >= threshold ? p * keep_scale : 0.0f;
      } else {
        sc[i] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 1);
      tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 2);
      l_run[r] = l_run[r] * alpha[r] + tsum[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];

    uint32_t pa[4][4];
    acc_to_afrag(pa, sc);
    fence_regs(o);
    wgmma_fence();
    const uint64_t dv_desc = desc_mnmajor(vs(s));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(o, pa[kk], dv_desc + 128 * kk);  // O += bf16(w) V
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < n) {
      const float inv = 1.0f / l_run[r];
      bf16* dst = out + (((long long)b * n + row) * H + h) * HD + 2 * c;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      if (lse != nullptr && c == 0)
        lse[(long long)bh * n + row] = (m_run[r] + log2f(l_run[r])) * LN2;
    }
  }
}

// A (b, n, h, 64) bf16 tensor with element strides (sb, sn, sh) as a rank-4
// (d, n, h, b) map of (64 x 64) boxes, 128-byte swizzled; rows past n read 0.
bool tile_map(CUtensorMap* map, const void* base, int B, int n, int H, long long sb, long long sn,
              long long sh) {
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {HD, TILE, 1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// The forward on `stream`. q, k, v: (B, n, H, 64) bf16 with element strides
// (sb, sn, sh); out: contiguous (B, n, H, 64) bf16; lse: (B*H, n) f32 or
// null; seeds: (B*H,) int32 (the uint32 seeds' bits), ignored without
// dropout, which compiles the mask out. Returns the launch error
// (cudaSuccess == 0), or cudaErrorInvalidValue if a tensor map is refused.
int attention_forward(const void* q, const void* k, const void* v, long long sb, long long sn,
                      long long sh, const void* seeds, void* out, void* lse, int B, int n, int H,
                      unsigned int threshold, float keep_scale, bool dropout, cudaStream_t s) {
  static unsigned long long smem_set[2];
  CUtensorMap tq, tk, tv;
  if (!current_context() || !tile_map(&tq, q, B, n, H, sb, sn, sh) ||
      !tile_map(&tk, k, B, n, H, sb, sn, sh) || !tile_map(&tv, v, B, n, H, sb, sn, sh))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + TILE - 1) / TILE, B * H);
  const float scale_log2 = LOG2E / sqrtf(static_cast<float>(HD));
  cudaError_t err;
  if (dropout) {
    if ((err = ensure_smem(attn_fwd_kernel<true>, FWD_SMEM, smem_set[1])) != cudaSuccess)
      return static_cast<int>(err);
    attn_fwd_kernel<true><<<grid, THREADS, FWD_SMEM, s>>>(
        tq, tk, tv, static_cast<const int*>(seeds), static_cast<bf16*>(out),
        static_cast<float*>(lse), n, H, scale_log2, threshold, keep_scale);
  } else {
    if ((err = ensure_smem(attn_fwd_kernel<false>, FWD_SMEM, smem_set[0])) != cudaSuccess)
      return static_cast<int>(err);
    attn_fwd_kernel<false><<<grid, THREADS, FWD_SMEM, s>>>(
        tq, tk, tv, nullptr, static_cast<bf16*>(out), static_cast<float*>(lse), n, H, scale_log2,
        0u, 1.0f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
