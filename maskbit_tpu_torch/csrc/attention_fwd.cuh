// The attention forward on Hopper (sm_90a), shared by two libraries:
//   * csrc/dropout_attention.cu: attn_fwd_kernel<true> replaces the TPU kernel
//     _dropattn_fwd_kernel (maskbit_tpu/nn/pallas_attention.py, dropout_attention
//     -> _dropout_attention_fwd), and attn_fwd_kernel<false> replaces
//     _attention_kernel (fused_attention);
//   * csrc/attention_block.cu: attn_fwd_kernel<false> is the attention core of
//     the serving block, over its QKV projection's output.
// Those take head dim 64; attn_fwd_mma_kernel<D, DROPOUT> (below) replaces
// the same TPU kernels at every other head dim that is a multiple of 16 in
// [16, 128], and attention_forward picks one by D. See dropout_attention.cu
// for the d = 64 design and what bounds it.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int HD = 64;                      // head dim (checked by the wrappers)
constexpr int TILE = 64;                    // queries or keys per tile: wgmma's M
constexpr int TILE_BYTES = TILE * HD * 2;   // one bf16 tile, 8 KB, 64 rows of 128 B
constexpr int CONSUMERS = 128;              // one warpgroup
constexpr int THREADS = CONSUMERS + 32;     // and one producer warp
constexpr int STAGES = 2;

// The consumer warpgroup's own barrier (the producer warp does not take part).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// One 64-key tile of the online softmax, in log2 units, over the scores sc
// of this thread's two rows in the accumulator layout (element i: row
// 8 * ((i >> 1) & 1) of the thread's pair, key kv0 + 8 * (i >> 2) + 2c +
// (i & 1); the 4 lanes of a group share a row): scales them, masks keys past
// n, updates the running max m_run and sum l_run (the sum runs before
// dropout), leaves the weights in sc (with DROPOUT the kept ones times
// keep_scale, the dropped ones 0) and the output rows' rescale in alpha.
template <bool DROPOUT>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int kv0, int n,
                                             int c, float scale_log2, const uint32_t (&rmix)[2],
                                             uint32_t seed_mix, uint32_t threshold,
                                             float keep_scale) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool valid = kv0 + 8 * (i >> 2) + 2 * c + (i & 1) < n;
    sc[i] = valid ? sc[i] * scale_log2 : -INFINITY;
    tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
  }
  float tsum[2] = {0.0f, 0.0f};
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

    float alpha[2];
    softmax_tile<DROPOUT>(sc, m_run, l_run, alpha, kv0, n, c, scale_log2, rmix, seed_mix,
                          threshold, keep_scale);
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

// ------------------------------------------- every other head width ----
//
// Head dims d that are multiples of 16 in [16, 128] other than 64: the
// TPU kernels read d from their inputs, and the JAX package runs them at
// d = 16 in its own tests. The d = 64 design above is built around
// 128-byte rows (the TMA box, its swizzle and the wgmma descriptors); these
// kernels are the simple design that holds at every such width: one block
// of four warps per (batch*head, 64-row tile), the tiles copied from device
// memory into padded shared-memory rows by all threads with 16-byte loads,
// and the products as mma.sync m16n8k16 (bf16 in, f32 accumulate), each
// warp holding 16 rows. The online softmax (softmax_tile), the keep hash,
// the rounding points and the saved log-sum-exp are the d = 64 kernels'.
// The copies do not overlap the products within a block; blocks on one SM
// overlap each other's. At d = 32 and the training shape of the system
// check, (32, 257, 4, 32), the forward moves 4.2 MB (1.3 us at 3.35 TB/s)
// for 1.1 GFLOP (1.1 us at the bf16 peak): such a call is bound by its
// launch and its one wave of blocks, not by either rate.
//
// Shared-memory tiles: row-major [row][d] with rows D + 8 elements long,
// and transposed [d][row] with rows MMA_ROWS + 8 long: the 16 bytes of pad
// put the 8 rows a fragment load touches on distinct banks.

constexpr int MMA_ROWS = 64;     // queries or keys per tile
constexpr int MMA_THREADS = 128;  // four warps of 16 rows
constexpr int MMA_LDT = MMA_ROWS + 8;

template <int D>
struct MmaDims {
  static constexpr int LD = D + 8;
  static constexpr int TILE = MMA_ROWS * LD * 2;  // bytes of a row-major tile
  static constexpr int TILE_T = D * MMA_LDT * 2;  // bytes of a transposed tile
  static constexpr int FWD_SMEM = 2 * TILE + TILE_T;  // Q | K | V^T
};

// D(16 x 8, f32) += A(16 x 16) B(16 x 8), bf16 fragments in registers.
// Lane l (g = l / 4, c = l % 4) holds D[g][2c..2c+1] in d[0..1] and
// D[g + 8][2c..2c+1] in d[2..3], the wgmma accumulator's layout per warp.
__device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows r0..r0+15 and columns k0..k0+15 of a shared tile
// [row][col] whose rows are ld elements long.
__device__ __forceinline__ void load_afrag(uint32_t (&a)[4], const bf16* t, int ld, int r0, int k0,
                                           int g, int c) {
  const bf16* p = t + (r0 + g) * ld + k0 + 2 * c;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// The B fragment of output columns n0..n0+7 and depth k0..k0+15 from a
// shared tile that holds them as rows [column][depth], ld elements long.
__device__ __forceinline__ void load_bfrag(uint32_t& b0, uint32_t& b1, const bf16* t, int ld,
                                           int n0, int k0, int g, int c) {
  const bf16* p = t + (n0 + g) * ld + k0 + 2 * c;
  b0 = ld_pair(p);
  b1 = ld_pair(p + 8);
}

// Rows [0, 64) of a (rows, D) bf16 tile whose row r starts at src + r *
// stride (16-byte aligned, D contiguous) into shared memory: row-major
// (TRANSPOSE false) or as [d][row] (true); rows from `valid` on are zeros.
template <int D, bool TRANSPOSE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          long long stride, int valid) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < MMA_ROWS * CH; i += MMA_THREADS) {
    // a warp's transposed stores go to neighbouring rows of one d: no conflicts
    const int r = TRANSPOSE ? i % MMA_ROWS : i / CH, ch = TRANSPOSE ? i / MMA_ROWS : i % CH;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) x = __ldg(reinterpret_cast<const uint4*>(src + r * stride + ch * 8));
    if (TRANSPOSE) {
      const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(ch * 8 + j) * MMA_LDT + r] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + r * MmaDims<D>::LD + ch * 8) = x;
    }
  }
}

// The forward at head dim D: attn_fwd_kernel's arguments, with q, k, v
// read through their element strides (sb, sn, sh) instead of tensor maps.
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(MMA_THREADS)
attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, long long sb, long long sn, long long sh,
                    const int* __restrict__ seeds, bf16* __restrict__ out,
                    float* __restrict__ lse, int n, int H, float scale_log2, uint32_t threshold,
                    float keep_scale) {
  using M = MmaDims<D>;
  extern __shared__ __align__(16) uint8_t smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);
  bf16* ks = reinterpret_cast<bf16*>(smem_mma + M::TILE);
  bf16* vt = reinterpret_cast<bf16*>(smem_mma + 2 * M::TILE);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * MMA_ROWS;
  const long long head = b * sb + h * sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const uint32_t row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t seed_mix = DROPOUT ? static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du : 0u;
  const uint32_t rmix[2] = {row0 * 0x9E3779B1u, (row0 + 8) * 0x9E3779B1u};

  load_tile<D, false>(qs, q + head + q0 * sn, sn, n - q0);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_afrag(qa[kk], qs, M::LD, warp * 16, 16 * kk, g, c);

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;

  const int ntiles = (n + MMA_ROWS - 1) / MMA_ROWS;
  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = t * MMA_ROWS;
    __syncthreads();  // every warp is done with the previous K and V
    load_tile<D, false>(ks, k + head + kv0 * sn, sn, n - kv0);
    load_tile<D, true>(vt, v + head + kv0 * sn, sn, n - kv0);
    __syncthreads();

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b0, b1;
        load_bfrag(b0, b1, ks, M::LD, 8 * j, 16 * kk, g, c);
        mma16816(sc + 4 * j, qa[kk], b0, b1);
      }
    float alpha[2];
    softmax_tile<DROPOUT>(sc, m_run, l_run, alpha, kv0, n, c, scale_log2, rmix, seed_mix,
                          threshold, keep_scale);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    uint32_t pa[4][4];
    acc_to_afrag(pa, sc);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // O += bf16(w) V
        uint32_t b0, b1;
        load_bfrag(b0, b1, vt, MMA_LDT, 8 * j, 16 * kk, g, c);
        mma16816(o + 4 * j, pa[kk], b0, b1);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < n) {
      const float inv = 1.0f / l_run[r];
      bf16* dst = out + (((long long)b * n + row) * H + h) * D + 2 * c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      if (lse != nullptr && c == 0)
        lse[(long long)bh * n + row] = (m_run[r] + log2f(l_run[r])) * LN2;
    }
  }
}

template <int D>
int attention_forward_mma(const void* q, const void* k, const void* v, long long sb,
                          long long sn, long long sh, const void* seeds, void* out, void* lse,
                          int B, int n, int H, unsigned int threshold, float keep_scale,
                          bool dropout, cudaStream_t s) {
  static unsigned long long smem_set[2];
  const dim3 grid((n + MMA_ROWS - 1) / MMA_ROWS, B * H);
  const float scale_log2 = LOG2E / sqrtf(static_cast<float>(D));
  const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
             *bv = static_cast<const bf16*>(v);
  cudaError_t err;
  if (dropout) {
    if ((err = ensure_smem(attn_fwd_mma_kernel<D, true>, MmaDims<D>::FWD_SMEM, smem_set[1])) !=
        cudaSuccess)
      return static_cast<int>(err);
    attn_fwd_mma_kernel<D, true><<<grid, MMA_THREADS, MmaDims<D>::FWD_SMEM, s>>>(
        bq, bk, bv, sb, sn, sh, static_cast<const int*>(seeds), static_cast<bf16*>(out),
        static_cast<float*>(lse), n, H, scale_log2, threshold, keep_scale);
  } else {
    if ((err = ensure_smem(attn_fwd_mma_kernel<D, false>, MmaDims<D>::FWD_SMEM, smem_set[0])) !=
        cudaSuccess)
      return static_cast<int>(err);
    attn_fwd_mma_kernel<D, false><<<grid, MMA_THREADS, MmaDims<D>::FWD_SMEM, s>>>(
        bq, bk, bv, sb, sn, sh, nullptr, static_cast<bf16*>(out), static_cast<float*>(lse), n,
        H, scale_log2, 0u, 1.0f);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward on `stream`. q, k, v: (B, n, H, D) bf16 with element strides
// (sb, sn, sh), each a multiple of 8; out: contiguous (B, n, H, D) bf16;
// lse: (B*H, n) f32 or null; seeds: (B*H,) int32 (the uint32 seeds' bits),
// ignored without dropout, which compiles the mask out. D = 64 takes the
// Hopper kernel, every other multiple of 16 in [16, 128] the mma.sync one.
// Returns the launch error (cudaSuccess == 0), or cudaErrorInvalidValue if
// D is outside that range or a tensor map is refused.
int attention_forward(const void* q, const void* k, const void* v, long long sb, long long sn,
                      long long sh, const void* seeds, void* out, void* lse, int B, int n, int H,
                      int D, unsigned int threshold, float keep_scale, bool dropout,
                      cudaStream_t s) {
  switch (D) {
#define MB_FWD_CASE(W)                                                                         \
  case W:                                                                                     \
    return attention_forward_mma<W>(q, k, v, sb, sn, sh, seeds, out, lse, B, n, H, threshold, \
                                    keep_scale, dropout, s);
    MB_MMA_HEAD_DIMS(MB_FWD_CASE)
#undef MB_FWD_CASE
    case HD:
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
