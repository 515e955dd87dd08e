// The attention forward on Hopper (sm_90a), shared by two libraries:
//   * csrc/dropout_attention.cu: attn_fwd_kernel<D, true> replaces the TPU
//     kernel _dropattn_fwd_kernel (maskbit_tpu/nn/pallas_attention.py,
//     dropout_attention -> _dropout_attention_fwd), and attn_fwd_kernel<D,
//     false> replaces _attention_kernel (fused_attention);
//   * csrc/attention_block.cu: attn_fwd_kernel<D, false> is the attention
//     core of the serving block (_attention_block_kernel), over its QKV
//     projection's output.
// One template serves every head dim D that is a multiple of 16 in [16,
// 128] (the TPU kernels read d from their inputs); attention_forward picks
// the instantiation by D, and takes every other d in [1, 128] at d rounded
// up to 16 (pad_head_dim) on inputs the caller zero-pads per head, with the
// softmax scale of the unpadded d. See dropout_attention.cu for the design,
// what bounds it, and the backward. A d past 128 takes the TMA + wgmma
// kernels of attention_wide_bf16.cuh (included below, and by every library
// that includes this header: instantiated at widths 192 and 256, each score
// tile computed once up to d = 256, ceil(d / 256) times past it), at d
// rounded up to 16 in the same way; Panels<D> takes widths up to 256 for
// them.
//
// Head dims and the shared-memory layout. A tile is 64 rows of D bf16
// values. wgmma reads its shared-memory operands through descriptors of
// 128-, 64- or 32-byte swizzled rows, and a TMA box is at most one swizzle
// width wide, so a D-wide row is cut into column panels, each its own TMA
// box, stored one after the other: 64-wide panels (128-byte rows, 128-byte
// swizzle) first, then a 32-wide (64-byte swizzle) and a 16-wide (32-byte
// swizzle) remainder where D needs them (Panels below: 16 = 16, 32 = 32, 48
// = 32 + 16, 64 = 64, 80 = 64 + 16, 96 = 64 + 32, 112 = 64 + 32 + 16, 128 =
// 64 + 64). Every panel starts on a multiple of its swizzle's repeat (1024,
// 512 or 256 bytes), so TMA's swizzle and the descriptors' agree.
//   * Products that reduce over d (S = Q K^T, and in the backward S^T and
//     dP^T) walk d in 16-wide slabs; each slab lies in one panel, and its
//     K-major descriptor is that panel's, advanced 32 bytes a slab.
//   * Products whose output columns are d (O += P V, and in the backward
//     dV, dK and the dQ part) take V (G, Q, K) as an MN-major operand: one
//     wgmma m64nWk16 per panel of width W, whose accumulators, panel after
//     panel, are exactly those of one m64nD product (sm90.cuh's layout), so
//     the epilogues index them as one array.
// Each swizzle keeps the 8 rows a wgmma core matrix reads (16 bytes each)
// on distinct banks; at 64 and 32 bytes a warp's TMA box moves shorter
// rows, which costs the copy engine more requests for the same bytes.
//
// What bounds the forward, by width (H100: 3.35 TB/s, 989 TFLOP/s bf16).
// At the shapes chip_smoke.py times, batch 32 and n = 257: d = 64 over 16
// heads and d = 128 over 8 move 67 MB (20 us) for 8.7 GFLOP (9 us); d = 112
// over 8 heads 59 MB (18 us); d = 16 to 96 over 4 heads 4.3 to 25 MB (1.3
// to 7.6 us) in 640 blocks, under three waves, which the launch and the
// last wave bound more than either rate. Beside the products, every width
// spends about 20 f32 and integer operations a (query, key) pair on the
// CUDA cores (the online softmax, the keep hash), which no bound counts
// and which do not shrink with d. The design keeps the copies and the
// tensor cores off their path at every width: the producer warp keeps the
// next K and V tiles in flight, the score tile never leaves registers, and
// three blocks an SM up to d = 64 (two past it, where d / 2 f32 output
// accumulators a thread and 52 to 83 KB of shared memory leave room for no
// third) overlap one block's softmax with another's products.

#pragma once

#include <utility>

#include "sm90.cuh"

namespace {

constexpr int TILE = 64;                    // queries or keys per tile: wgmma's M
constexpr int CONSUMERS = 128;              // one warpgroup
constexpr int THREADS = CONSUMERS + 32;     // and one producer warp
constexpr int STAGES = 2;

// The column panels of a D-wide bf16 tile row (see the header); past 128
// (attention_wide_bf16.cuh) D is 192 or 256, all 64-wide panels.
template <int D>
struct Panels {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head dim");
  static constexpr int WIDE = D / 64;  // 64-column panels
  static constexpr bool HAS32 = (D & 32) != 0, HAS16 = (D & 16) != 0;
  static constexpr int COUNT = WIDE + HAS32 + HAS16;
  static constexpr int TILE_BYTES = TILE * D * 2;  // a 64-row tile, panels included
  __host__ __device__ static constexpr int width(int p) {
    return p < WIDE ? 64 : (p == WIDE && HAS32) ? 32 : 16;
  }
  __host__ __device__ static constexpr int col(int p) {  // first column
    return p < WIDE ? 64 * p : (p == WIDE) ? 64 * WIDE : D - 16;
  }
  // byte offset of panel p in a tile: the panels before it, 64 rows each
  __host__ __device__ static constexpr int offset(int p) { return TILE * col(p) * 2; }
  // the panel that holds column c (a multiple of 16)
  __host__ __device__ static constexpr int of(int c) {
    return c < 64 * WIDE ? c / 64 : (HAS32 && c < 64 * WIDE + 32) ? WIDE : COUNT - 1;
  }
};

// A tensor's maps, one per panel width: [0] 64 wide, [1] 32, [2] 16; the
// widths a D has no panel of are left unencoded.
struct TileMaps {
  CUtensorMap box[3];
};

__host__ __device__ constexpr int width_index(int w) { return w == 64 ? 0 : w == 32 ? 1 : 2; }

// Calls f(std::integral_constant<int, 0>{}), ..., f(<N - 1>): a loop whose
// index is a constant expression, so each panel's wgmma takes its width.
template <typename F, int... I>
__device__ __forceinline__ void static_for_impl(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// The accumulators of panel P within those of a m64nD product.
template <int D, int P, int N>
__device__ __forceinline__ float (&panel_acc(float (&acc)[N]))[Panels<D>::width(P) / 2] {
  return *reinterpret_cast<float(*)[Panels<D>::width(P) / 2]>(acc + Panels<D>::col(P) / 2);
}

// All panels of the 64-row tile at `row` into the tile at shared address
// `tile`, on barrier `bar` (which expects Panels<D>::TILE_BYTES).
template <int D>
__device__ __forceinline__ void tma_load_tile(uint32_t tile, const TileMaps& maps, uint32_t bar,
                                              int row, int h, int b) {
  using P = Panels<D>;
#pragma unroll
  for (int p = 0; p < P::COUNT; ++p)
    tma_load_box(tile + P::offset(p), &maps.box[width_index(P::width(p))], bar, P::col(p), row, h,
                 b);
}

// K-major descriptor of the 16-wide slab kk (columns 16kk..16kk+15) of a
// tile, from its row `row0` (a multiple of 8) on.
template <int D>
__device__ __forceinline__ uint64_t slab_desc(uint32_t tile, int kk, int row0 = 0) {
  using P = Panels<D>;
  const int p = P::of(16 * kk);
  return smem_desc(tile + P::offset(p) + (row0 * P::width(p) + 16 * kk - P::col(p)) * 2,
                   P::width(p) * 2, false);
}

// MN-major descriptor of rows 16kk..16kk+15 of panel p of a tile.
template <int D>
__device__ __forceinline__ uint64_t panel_desc(uint32_t tile, int p, int kk) {
  using P = Panels<D>;
  return smem_desc(tile + P::offset(p) + 16 * kk * P::width(p) * 2, P::width(p) * 2, true);
}

// The consumer warpgroup's own barrier (the producer warp does not take part).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// One key tile of the online softmax (2N keys: 64 in the bf16 kernels), in
// log2 units, over the scores sc of this thread's two rows in the
// accumulator layout (element i: row 8 * ((i >> 1) & 1) of the thread's
// pair, key kv0 + 8 * (i >> 2) + 2c + (i & 1); the 4 lanes of a group share
// a row): scales them, masks keys past n, updates the running max m_run and
// sum l_run (the sum runs before dropout), leaves the weights in sc (with
// DROPOUT the kept ones times keep_scale, the dropped ones 0) and the output
// rows' rescale in alpha.
template <bool DROPOUT, int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int kv0, int n,
                                             int c, float scale_log2, const uint32_t (&rmix)[2],
                                             uint32_t seed_mix, uint32_t threshold,
                                             float keep_scale) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) {
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
  for (int i = 0; i < N; ++i) {
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

template <int D>
struct FwdCfg {
  // Shared memory: Q | K[0] V[0] | K[1] V[1] | barriers (80 KB at d = 128).
  static constexpr int SMEM = Panels<D>::TILE_BYTES * (1 + 2 * STAGES) + 64 + 1024;
  // Three blocks an SM up to d = 64 (136 registers a thread at most; 128
  // at d = 64 with the mask), two past it, where the d / 2 f32 output
  // accumulators a thread (40 to 64) would not fit 136 without spilling.
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 2;
};

template <int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS, FwdCfg<D>::MIN_BLOCKS)
attn_fwd_kernel(const __grid_constant__ TileMaps tq, const __grid_constant__ TileMaps tk,
                const __grid_constant__ TileMaps tv, const int* __restrict__ seeds,
                bf16* __restrict__ out, float* __restrict__ lse, int n, int H, float scale_log2,
                uint32_t threshold, float keep_scale) {
  using P = Panels<D>;
  constexpr int TB = P::TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + TB * (1 + 2 * STAGES));
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  auto ks = [&](int s) { return smem + TB * (1 + 2 * s); };
  auto vs = [&](int s) { return smem + TB * (2 + 2 * s); };

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
      const uint32_t base = smem_u32(smem), bar0 = smem_u32(bars);
      mbar_expect_tx(bar0, TB);
      tma_load_tile<D>(base, tq, bar0, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        const uint32_t full_s = bar0 + 8 * (1 + s), k_s = base + TB * (1 + 2 * s);
        mbar_wait(full_s + 8 * STAGES, ((t / STAGES) & 1) ^ 1);  // empty[s]
        mbar_expect_tx(full_s, 2 * TB);
        tma_load_tile<D>(k_s, *opaque(&tk), full_s, t * TILE, h, b);
        tma_load_tile<D>(k_s + TB, *opaque(&tv), full_s, t * TILE, h, b);
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
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;

  mbar_wait(q_full, 0);
  const uint32_t q_base = smem_u32(qs);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const int kv0 = t * TILE;
    mbar_wait(&full[s], (t / STAGES) & 1);

    float sc[32];
    fence_regs(o);
    wgmma_fence();
    const uint32_t q_addr = opaque(q_base), k_addr = smem_u32(ks(s));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<0, 0>(sc, slab_desc<D>(q_addr, kk), slab_desc<D>(k_addr, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    float alpha[2];
    softmax_tile<DROPOUT>(sc, m_run, l_run, alpha, kv0, n, c, scale_log2, rmix, seed_mix,
                          threshold, keep_scale);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    uint32_t pa[4][4];
    acc_to_afrag(pa, sc);
    fence_regs(o);
    wgmma_fence();
    const uint32_t v_addr = smem_u32(vs(s));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // O += bf16(w) V, a wgmma per panel
      static_for<P::COUNT>([&](auto pc) {
        constexpr int p = decltype(pc)::value;
        wgmma_rs<1>(panel_acc<D, p>(o), pa[kk], panel_desc<D>(v_addr, p, kk));
      });
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

// A (b, n, h, D) bf16 tensor with element strides (sb, sn, sh) as rank-4
// (d, n, h, b) maps of (W x 64) boxes, one for each panel width W of D,
// swizzled at W * 2 bytes; rows past n read 0.
template <int D>
bool tile_maps(TileMaps* maps, const void* base, int B, int n, int H, long long sb, long long sn,
               long long sh) {
  using P = Panels<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  memset(maps, 0, sizeof(*maps));
  for (int p = 0; p < P::COUNT; ++p) {
    const int w = P::width(p);
    if (p > 0 && w == P::width(p - 1)) continue;  // the 64-wide panels share a map
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(w), TILE, 1, 1};
    const CUtensorMapSwizzle swizzle = w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                       : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
    if (!encode_tiled(&maps->box[width_index(w)], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                      strides, box, swizzle))
      return false;
  }
  return true;
}

template <int D, bool DROPOUT>
int attention_forward_at(const void* q, const void* k, const void* v, long long sb, long long sn,
                         long long sh, const void* seeds, void* out, void* lse, int B, int n,
                         int H, int d, unsigned int threshold, float keep_scale, cudaStream_t s) {
  static unsigned long long smem_set;
  TileMaps tq, tk, tv;
  if (!current_context() || !tile_maps<D>(&tq, q, B, n, H, sb, sn, sh) ||
      !tile_maps<D>(&tk, k, B, n, H, sb, sn, sh) || !tile_maps<D>(&tv, v, B, n, H, sb, sn, sh))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = ensure_smem(attn_fwd_kernel<D, DROPOUT>, FwdCfg<D>::SMEM, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + TILE - 1) / TILE, B * H);
  attn_fwd_kernel<D, DROPOUT><<<grid, THREADS, FwdCfg<D>::SMEM, s>>>(
      tq, tk, tv, static_cast<const int*>(seeds), static_cast<bf16*>(out),
      static_cast<float*>(lse), n, H, LOG2E / sqrtf(static_cast<float>(d)), threshold,
      keep_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Head dims past 128: the backward's row stats (and WIDE_MIN_D), and the
// bf16 kernels (attention_f32.cu includes the float32 ones).
#include "attention_wide.cuh"
#include "attention_wide_bf16.cuh"

namespace {

// The forward on `stream` at head dim d >= 1. q, k, v: (B, n, H, D) bf16
// with D = pad_head_dim(d), zero past d, element strides (sb, sn, sh), each
// a multiple of 8; out: contiguous (B, n, H, D) bf16; lse: (B*H, n) f32 or
// null; seeds: (B*H,) int32 (the uint32 seeds' bits), ignored without
// dropout, which compiles the mask out. d <= 128 takes attn_fwd_kernel<D,
// dropout>, a wider d attn_fwd_wide_bf16_kernel (attention_wide_bf16.cuh).
// WITH_DROPOUT false builds only the dropout-free kernels (the attention
// block needs no other) and refuses `dropout`. Returns the launch error
// (cudaSuccess == 0), or cudaErrorInvalidValue if d < 1 or a tensor map is
// refused.
template <bool WITH_DROPOUT>
int attention_forward(const void* q, const void* k, const void* v, long long sb, long long sn,
                      long long sh, const void* seeds, void* out, void* lse, int B, int n, int H,
                      int d, unsigned int threshold, float keep_scale, bool dropout,
                      cudaStream_t s) {
  if ((!WITH_DROPOUT && dropout) || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (d >= WIDE_MIN_D) {
    if constexpr (WITH_DROPOUT)
      if (dropout)
        return attention_forward_wide_bf16<true>(
            q, k, v, sb, sn, sh, static_cast<const int*>(seeds), static_cast<bf16*>(out),
            static_cast<float*>(lse), B, n, H, d, threshold, keep_scale, s);
    return attention_forward_wide_bf16<false>(q, k, v, sb, sn, sh, nullptr,
                                              static_cast<bf16*>(out), static_cast<float*>(lse),
                                              B, n, H, d, 0u, 1.0f, s);
  }
  switch (pad_head_dim(d)) {
#define MB_FWD_CASE(W)                                                                       \
  case W:                                                                                   \
    if constexpr (WITH_DROPOUT)                                                             \
      if (dropout)                                                                          \
        return attention_forward_at<W, true>(q, k, v, sb, sn, sh, seeds, out, lse, B, n, H, \
                                             d, threshold, keep_scale, s);                  \
    return attention_forward_at<W, false>(q, k, v, sb, sn, sh, nullptr, out, lse, B, n, H,  \
                                          d, 0u, 1.0f, s);
    MB_HEAD_DIMS(MB_FWD_CASE)
#undef MB_FWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
