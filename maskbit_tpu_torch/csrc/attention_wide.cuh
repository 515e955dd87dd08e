// The float32 attention kernels at head dims past 128 on Hopper (sm_90a),
// and the backward's row-stats kernel, which the bf16 backward past 128
// (attention_wide_bf16.cuh) launches too. Included by attention_fwd.cuh
// after softmax_tile; attention_f32.cu launches the float32 kernels. They
// replace, at those widths, the same TPU kernels of
// maskbit_tpu/nn/pallas_attention.py as the templates for d <= 128:
//   * _dropattn_fwd_kernel and _attention_kernel (dropout_attention,
//     fused_attention, and the attention core of _attention_block_kernel),
//     by attn_fwd_wide_kernel<float, DROPOUT>;
//   * _dropattn_bwd_kernel, by attn_bwd_wide_prep_kernel<float> and
//     attn_bwd_wide_kernel<float, MODE> (dV, dK, then dQ).
// The templates keep their type parameter T, which only float takes now
// (bf16 past 128 runs attention_wide_bf16.cuh's TMA and wgmma kernels),
// so that these kernels keep their names and code; the prep kernel also
// takes bf16. d is any width (the wrappers pad it to a multiple of 16 per
// head, as below 128, and pass the unpadded d for the scale).
//
// Why another design past 128. The float32 templates for d <= 128 hold a
// 64-row Q tile, or K and V tiles, whole in shared memory and the d-wide
// f32 output (or dK and dV) in registers, and their operands' TF32 hi and
// lo halves leave no plan under 227 KB from d = 144 (forward) or 160
// (backward). Here the work is cut along d in panels of PANEL = 64
// columns, the widths the narrow templates already take, so that no block
// holds more than one panel of anything:
//   * products that sum over d (S = Q K^T, dP = G V^T, and their transposes
//     in the dK and dV passes) take d a 64-wide chunk at a time, both
//     operands' chunks streamed through a two-stage ring of shared memory
//     (cp.async, zero-filled past n and past d); each chunk's 3xTF32 sum
//     goes to a fresh accumulator that is added to the scores on the CUDA
//     cores, as the narrow float32 forward adds its long sums, so that no
//     truncating tensor-core accumulator runs over all of d;
//   * products whose columns are d (O = P V, dV = P^T G, dK = dS^T Q, dQ =
//     dS K) are computed one 64-column output panel per block: the grid's z
//     axis runs over the panels, and each block recomputes the scores over
//     the whole of d for its panel. At d = 256 that is 2.5 times the
//     forward's products of one pass, the price of holding 32 output f32 a
//     thread at every width (each tile's products over the sequence go to
//     a fresh accumulator first, added to the running sum on the CUDA
//     cores);
//   * the backward takes passes over the same recomputation: blocks per
//     (key tile, panel) sum dV, then dK, over the query tiles (the operands'
//     TF32 halves leave no registers for two sums beside S^T and dP^T: one
//     pass spilled 52 bytes; the dV pass needs no dP), blocks per (query
//     tile, panel) sum dQ over the key tiles. Each output is written once,
//     by one block, in a fixed order: no atomics, no tickets, and the
//     result is the same bit for bit on every call.
// Products are warp-level mma.sync (three tf32 m16n8k8, f32 accumulate):
// four warps of 16 rows each, operands loaded from padded shared-memory
// rows (4 floats past 64, so that a warp's fragment loads hit 32 banks).
// mma.sync reaches about half of wgmma's rate on this card; it keeps the
// design simple, with any operand readable transposed from shared memory,
// which float32's K-major-only wgmma would need splitter warps and
// transposed copies for (PERF.md and ROADMAP.md hold the times and the
// redesign).
//
// What bounds them on the H100, at b = 32, n = 257, 4 heads of d = 256 (the
// flagship's hidden 1024 at 4 heads): the forward's 3xTF32 products are 26
// GFLOP (53 us at 495 TFLOP/s) for 135 MB (40 us at 3.35 TB/s); the
// backward's 65 GFLOP (131 us) for 270 MB (81 us). The recomputed scores
// are not in these counts. Float32 rounds at none of the bf16 kernels'
// rounding points.

#pragma once

#include <type_traits>

namespace {

constexpr int PANEL = 64;         // columns of d: a chunk of a sum, an output panel
constexpr int WIDE_THREADS = 128;  // four warps of 16 rows: one 64-row tile
constexpr int WIDE_MIN_D = 129;    // the narrowest head dim these kernels run

// Elements a shared-memory row of one (64 x PANEL) tile takes: PANEL and a
// pad of 16 bytes, so that rows 16 bytes apart in the bank order fall on
// other banks.
template <typename T>
__host__ __device__ constexpr int wide_pitch() {
  return PANEL + 16 / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int wide_tile_elems() {
  return TILE * wide_pitch<T>();
}
// Two stages of two tiles: 68 KB in float32.
template <typename T>
__host__ __device__ constexpr int wide_smem() {
  return 4 * wide_tile_elems<T>() * static_cast<int>(sizeof(T));
}

// ------------------------------------------------------ PTX wrappers ----

// 16 bytes from global to shared memory, or 16 zero bytes where !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mma.sync m16n8k8 tf32, f32 accumulate: c += a b. Lane l (g = l / 4, c =
// l % 4) holds C (g, 2c), (g, 2c+1), (g+8, 2c), (g+8, 2c+1): per warp the
// accumulator layout of sm90.cuh's wgmma.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo in TF32, each rounded to nearest (ties away) by integer
// operations, as cvt.rna would for finite x.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// An A fragment's TF32 halves.
struct Tf32Frag {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ Tf32Frag tf32_frag(const float (&a)[4]) {
  Tf32Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32_split(a[i], f.hi[i], f.lo[i]);
  return f;
}

// d += the three TF32 products of a and (b0, b1), the two small ones first.
__device__ __forceinline__ void mma3_tf32(float (&d)[4], const Tf32Frag& a, float b0, float b1) {
  uint32_t bhi[2], blo[2];
  tf32_split(b0, bhi[0], blo[0]);
  tf32_split(b1, bhi[1], blo[1]);
  mma_tf32(d, a.lo, bhi[0], bhi[1]);
  mma_tf32(d, a.hi, blo[0], blo[1]);
  mma_tf32(d, a.hi, bhi[0], bhi[1]);
}

__device__ __forceinline__ void zero_acc(float (&x)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[nt][j] = 0.0f;
}

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// ------------------------------------------------------ the tile steps ----

// Rows row0..row0+63 and columns col0..col0+PANEL-1 of one (b, h) slice of a
// (B, n, H, D) tensor (`base` at its row 0, row stride sn elements) into a
// padded tile at dst, by cp.async; zeros past n and past D (a multiple of
// 16, so a 16-byte chunk is all in or all out).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* base, long long sn, int row0, int n,
                                          int col0, int D) {
  constexpr int PER = 16 / sizeof(T);    // elements a chunk
  constexpr int CHUNKS = PANEL / PER;    // chunks a row
#pragma unroll
  for (int it = 0; it < TILE * CHUNKS / WIDE_THREADS; ++it) {
    const int i = threadIdx.x + it * WIDE_THREADS;
    const int r = i / CHUNKS, col = col0 + (i % CHUNKS) * PER;
    const bool in = row0 + r < n && col < D;
    cp_async16(dst + r * wide_pitch<T>() + (i % CHUNKS) * PER,
               in ? base + (row0 + r) * sn + col : base, in);
  }
}

// s (16 rows of this warp x 64 columns, as 8 m16n8 accumulators) += A B^T
// over one PANEL-wide chunk: A's rows r0..r0+15 and B's 64 rows, both
// [row][chunk column] tiles. The chunk's sum is taken apart and then added.
__device__ __forceinline__ void chunk_product(float (&s)[8][4], const float* a, const float* b,
                                              int r0, int g, int c) {
  constexpr int P = wide_pitch<float>();
  float t[8][4];
  zero_acc(t);
#pragma unroll
  for (int ks = 0; ks < PANEL / 8; ++ks) {
    const int k = 8 * ks + c;
    const Tf32Frag af = tf32_frag({a[(r0 + g) * P + k], a[(r0 + g + 8) * P + k],
                                   a[(r0 + g) * P + k + 4], a[(r0 + g + 8) * P + k + 4]});
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      mma3_tf32(t[nt], af, b[(8 * nt + g) * P + k], b[(8 * nt + g) * P + k + 4]);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[nt][j] += t[nt][j];
}

// o (16 rows x PANEL columns) += W V, W this warp's 16 x 64 weights in the
// accumulator layout (w, the product's A operand from registers) and V a
// [64 rows (the sum's index)][PANEL] tile: the tile's sum is taken apart
// and then added.
__device__ __forceinline__ void panel_product(float (&o)[8][4], const float (&w)[8][4],
                                              const float* v, int lane) {
  constexpr int P = wide_pitch<float>();
  const int g = lane >> 2, c = lane & 3;
  float t[8][4];
  zero_acc(t);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    // the weights' n-tile ks as the A fragment: its column c is key 8ks +
    // 2c and its column c + 4 key 8ks + 2c + 1, and V's rows are read in
    // that order, so the accumulator's values serve as they stand
    const Tf32Frag af = tf32_frag({w[ks][0], w[ks][2], w[ks][1], w[ks][3]});
#pragma unroll
    for (int nt = 0; nt < PANEL / 8; ++nt)
      mma3_tf32(t[nt], af, v[(8 * ks + 2 * c) * P + 8 * nt + g],
                v[(8 * ks + 2 * c + 1) * P + 8 * nt + g]);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] += t[nt][j];
}

// Columns col..col+1 of an output row.
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// ------------------------------------------------------------ forward ----

// One block per (64-query tile, batch*head, output panel): for each key
// tile, S over d chunk by chunk (Q and K chunks through the ring), the
// online softmax (softmax_tile), then O_panel += P V_panel. lse comes from
// panel 0's blocks (every panel computes the same scores).
template <typename T, bool DROPOUT>
__global__ void __launch_bounds__(WIDE_THREADS)
attn_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     long long sb, long long sn, long long sh, const int* __restrict__ seeds,
                     T* __restrict__ out, float* __restrict__ lse, int n, int H, int D,
                     float scale_log2, uint32_t threshold, float keep_scale) {
  extern __shared__ uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr int TE = wide_tile_elems<T>();
  const int q0 = blockIdx.x * TILE, bh = blockIdx.y, col0 = blockIdx.z * PANEL;
  const int b = bh / H, h = bh % H;
  const long long at = b * sb + h * sh;
  const T *qb = q + at, *kb = k + at, *vb = v + at;
  const int chunks = (D + PANEL - 1) / PANEL, steps = chunks + 1;  // a key tile's items
  const int total = (n + TILE - 1) / TILE * steps;

  // item i: chunk i % steps of key tile i / steps (Q and K), or its V panel
  auto load_item = [&](int i) {
    T* st = ring + (i & 1) * 2 * TE;
    const int t = i / steps, ch = i % steps;
    if (ch < chunks) {
      load_tile(st, qb, sn, q0, n, ch * PANEL, D);
      load_tile(st + TE, kb, sn, t * TILE, n, ch * PANEL, D);
    } else {
      load_tile(st, vb, sn, t * TILE, n, col0, D);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int r0 = 16 * warp;
  const uint32_t row0 = q0 + r0 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t seed_mix = DROPOUT ? static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du : 0u;
  const uint32_t rmix[2] = {row0 * 0x9E3779B1u, (row0 + 8) * 0x9E3779B1u};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  float o[8][4], s[8][4];
  zero_acc(o);

  load_item(0);
  for (int i = 0; i < total; ++i) {
    if (i + 1 < total) {
      load_item(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = ring + (i & 1) * 2 * TE;
    const int ch = i % steps;
    if (ch == 0) zero_acc(s);
    if (ch < chunks) {
      chunk_product(s, st, st + TE, r0, g, c);
    } else {
      float alpha[2];
      softmax_tile<DROPOUT>(reinterpret_cast<float(&)[32]>(s), m_run, l_run, alpha,
                            i / steps * TILE, n, c, scale_log2, rmix, seed_mix, threshold,
                            keep_scale);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[nt][j] *= alpha[j >> 1];
      panel_product(o, s, st, lane);
    }
    __syncthreads();  // the stage is free for item i + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    const float inv = 1.0f / l_run[r];
    T* dst = out + (((long long)b * n + row) * H + h) * D + col0 + 2 * c;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      if (col0 + 8 * nt < D) store_pair(dst + 8 * nt, o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
    if (lse != nullptr && c == 0 && blockIdx.z == 0)
      lse[(long long)bh * n + row] = (m_run[r] + log2f(l_run[r])) * LN2;
  }
}

// The forward at head dim d >= WIDE_MIN_D: the arguments of
// attention_forward (attention_fwd.cuh), the tensors T at D =
// pad_head_dim(d).
template <typename T, bool DROPOUT>
int attention_forward_wide_at(const T* q, const T* k, const T* v, long long sb, long long sn,
                              long long sh, const int* seeds, T* out, float* lse, int B, int n,
                              int H, int d, unsigned int threshold, float keep_scale,
                              cudaStream_t s) {
  static unsigned long long smem_set;
  const int D = pad_head_dim(d);
  const cudaError_t err = ensure_smem(attn_fwd_wide_kernel<T, DROPOUT>, wide_smem<T>(), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + TILE - 1) / TILE, B * H, (D + PANEL - 1) / PANEL);
  attn_fwd_wide_kernel<T, DROPOUT><<<grid, WIDE_THREADS, wide_smem<T>(), s>>>(
      q, k, v, sb, sn, sh, seeds, out, lse, n, H, D, LOG2E / sqrtf(static_cast<float>(d)),
      threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- backward ----

// Per (b, row, h), row over the padded length n_pad: stats[bh, row] =
// (lse * log2e, rowsum(g * out)) in f32, (0, 0) past n; one warp per row.
template <typename T>
__global__ void __launch_bounds__(128)
attn_bwd_wide_prep_kernel(const T* __restrict__ out, const T* __restrict__ grad,
                          const float* __restrict__ lse, float2* __restrict__ stats, int n,
                          int n_pad, int H, int D, long long rows) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (r >= rows) return;  // whole warps: a warp shares its row
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(r % H);
  const long long bn = r / H;  // b * n_pad + row
  const long long b = bn / n_pad;
  const int row = static_cast<int>(bn % n_pad);
  const long long bh = b * H + h;
  if (row >= n) {
    if (lane == 0) stats[bh * n_pad + row] = make_float2(0.0f, 0.0f);
    return;
  }
  const long long e = ((b * n + row) * H + h) * D;
  float s = 0.0f;
  for (int i = lane; i < D; i += 32) s += to_f32(out[e + i]) * to_f32(grad[e + i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) stats[bh * n_pad + row] = make_float2(lse[bh * n + row] * LOG2E, s);
}

// The backward passes (attn_bwd_wide_kernel's MODE): which gradients a
// block sums, over which side's tiles.
enum { BWD_DV = 1, BWD_DK = 2, BWD_DQ = 3 };

// One block per (64-row tile of its own, batch*head, output panel), looping
// over the other side's tiles:
//   BWD_DV, BWD_DK: own rows are keys, the loop runs over query tiles;
//     S^T = K Q^T (and for DK dP^T = V G^T) chunk by chunk, then dV_panel
//     += dropped^T G_panel or dK_panel += dS^T Q_panel: two passes, as the
//     operand halves leave no registers for two sums beside S^T and dP^T
//     (a combined pass spilled);
//   BWD_DQ: own rows are queries, the loop runs over key tiles; S = Q K^T
//     and dP = G V^T, then dQ_panel += dS K_panel.
// P = exp2(S scale log2e - lse log2e), dropped = keep P / (1 - p), dS = P
// (keep dP / (1 - p) - delta) scale, keys and queries past n weighing 0.
// q, k, v strided as in the forward; grad contiguous (B, n, H, D); da: dk
// for BWD_DK, dv for BWD_DV, dq for BWD_DQ, contiguous (B, n, H, D); db is
// not read (the parameter list is the one the kernels were built with
// when a bf16 pass wrote dk and dv together).
template <typename T, int MODE>
__global__ void __launch_bounds__(WIDE_THREADS)
attn_bwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     long long sb, long long sn, long long sh, const T* __restrict__ grad,
                     const float2* __restrict__ stats, const int* __restrict__ seeds,
                     T* __restrict__ da, T* __restrict__ db, int n, int H, int D, int n_pad,
                     float scale, float scale_log2, uint32_t threshold, float keep_scale) {
  constexpr bool DQ = MODE == BWD_DQ, WITH_DP = MODE != BWD_DV;
  extern __shared__ uint8_t smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  constexpr int TE = wide_tile_elems<T>();
  const int own0 = blockIdx.x * TILE, bh = blockIdx.y, col0 = blockIdx.z * PANEL;
  const int b = bh / H, h = bh % H;
  const long long at = b * sb + h * sh;
  const long long gsn = static_cast<long long>(H) * D;
  const T* gb = grad + (long long)b * n * gsn + (long long)h * D;
  // the own side's operands of S and dP, and the other side's
  const T* own_s = (DQ ? q : k) + at;
  const T* own_p = DQ ? gb : v + at;
  const T* oth_s = (DQ ? k : q) + at;
  const T* oth_p = DQ ? v + at : gb;
  const long long own_p_sn = DQ ? gsn : sn, oth_p_sn = DQ ? sn : gsn;
  const int chunks = (D + PANEL - 1) / PANEL, steps = (WITH_DP ? 2 : 1) * chunks + 1;
  const int total = (n + TILE - 1) / TILE * steps;

  // item i of other-side tile t = i / steps: chunk j of S (j < chunks), of
  // dP (chunks <= j < 2 chunks), then the panel operands of the updates
  auto load_item = [&](int i) {
    T* st = ring + (i & 1) * 2 * TE;
    const int t0 = i / steps * TILE, j = i % steps;
    if (j < chunks) {
      load_tile(st, own_s, sn, own0, n, j * PANEL, D);
      load_tile(st + TE, oth_s, sn, t0, n, j * PANEL, D);
    } else if (j < steps - 1) {
      load_tile(st, own_p, own_p_sn, own0, n, (j - chunks) * PANEL, D);
      load_tile(st + TE, oth_p, oth_p_sn, t0, n, (j - chunks) * PANEL, D);
    } else if (DQ) {
      load_tile(st, k + at, sn, t0, n, col0, D);
    } else if (MODE == BWD_DK) {
      load_tile(st, q + at, sn, t0, n, col0, D);
    } else {  // G's panel
      load_tile(st, gb, gsn, t0, n, col0, D);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int r0 = 16 * warp;
  const int own_row = own0 + r0 + g;  // this thread's rows: own_row, own_row + 8
  const uint32_t seed_mix = static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du;
  const float2* st_bh = stats + (long long)bh * n_pad;
  float2 own_stats[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
  if (DQ) own_stats[0] = st_bh[own_row], own_stats[1] = st_bh[own_row + 8];

  float acc_a[8][4], s[8][4], dp[8][4];
  zero_acc(acc_a);

  load_item(0);
  for (int i = 0; i < total; ++i) {
    if (i + 1 < total) {
      load_item(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = ring + (i & 1) * 2 * TE;
    const int t0 = i / steps * TILE, j = i % steps;
    if (j == 0) {
      zero_acc(s);
      if (WITH_DP) zero_acc(dp);
    }
    if (j < chunks) {
      chunk_product(s, st, st + TE, r0, g, c);
    } else if (j < steps - 1) {
      chunk_product(dp, st, st + TE, r0, g, c);
    } else {
      // the weights and the score gradient, in place of s and dp
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int own = own_row + 8 * (e >> 1), oth = t0 + 8 * nt + 2 * c + (e & 1);
          const float2 ld = DQ ? own_stats[e >> 1] : st_bh[oth];
          const uint32_t query = DQ ? own : oth, key = DQ ? oth : own;
          const float p = own < n && oth < n ? exp2f(fmaf(s[nt][e], scale_log2, -ld.x)) : 0.0f;
          const bool keep = fmix(query * 0x9E3779B1u + key * 0x85EBCA77u + seed_mix) >= threshold;
          s[nt][e] = keep ? p * keep_scale : 0.0f;  // dropped weights
          if (WITH_DP) {
            const float dw = keep ? dp[nt][e] * keep_scale : 0.0f;
            dp[nt][e] = p * (dw - ld.y) * scale;  // score gradient
          }
        }
      if (MODE == BWD_DV) {
        panel_product(acc_a, s, st, lane);  // dV += dropped^T G
      } else {
        panel_product(acc_a, dp, st, lane);  // dK += dS^T Q, or dQ += dS K
      }
    }
    __syncthreads();  // the stage is free for item i + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = own_row + 8 * r;
    if (row >= n) continue;
    const long long o = (((long long)b * n + row) * H + h) * D + col0 + 2 * c;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (col0 + 8 * nt >= D) continue;
      store_pair(da + o + 8 * nt, acc_a[nt][2 * r], acc_a[nt][2 * r + 1]);
    }
  }
}

// The float32 backward at head dim d >= WIDE_MIN_D: the row stats, then
// the passes dV, dK, dQ. The arguments of mb_dropout_attention_bwd_f32
// (stats (B*H, n_pad) float2 scratch; no tickets), the tensors T = float
// at D = pad_head_dim(d).
template <typename T>
int attention_backward_wide(const T* q, const T* k, const T* v, long long sb, long long sn,
                            long long sh, const T* out, const T* grad, const float* lse,
                            const int* seeds, T* dq, T* dk, T* dv, float2* stats, int B, int n,
                            int H, int d, unsigned int threshold, float keep_scale,
                            cudaStream_t s) {
  const int D = pad_head_dim(d);
  const int ntiles = (n + TILE - 1) / TILE, n_pad = ntiles * TILE;
  const long long rows = static_cast<long long>(B) * n_pad * H;
  attn_bwd_wide_prep_kernel<T><<<static_cast<unsigned>((rows * 32 + 127) / 128), 128, 0, s>>>(
      out, grad, lse, stats, n, n_pad, H, D, rows);
  cudaError_t err = cudaGetLastError();
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const dim3 grid(ntiles, B * H, (D + PANEL - 1) / PANEL);
  auto pass = [&](auto mode, T* da, T* db, unsigned long long& smem_set) {
    constexpr int M = decltype(mode)::value;
    if (err == cudaSuccess)
      err = ensure_smem(attn_bwd_wide_kernel<T, M>, wide_smem<T>(), smem_set);
    if (err != cudaSuccess) return;
    attn_bwd_wide_kernel<T, M><<<grid, WIDE_THREADS, wide_smem<T>(), s>>>(
        q, k, v, sb, sn, sh, grad, stats, seeds, da, db, n, H, D, n_pad, scale, scale * LOG2E,
        threshold, keep_scale);
    err = cudaGetLastError();
  };
  static_assert(std::is_same<T, float>::value, "bf16 runs attention_wide_bf16.cuh");
  static unsigned long long smem_dv, smem_dk, smem_dq;
  pass(std::integral_constant<int, BWD_DV>{}, dv, nullptr, smem_dv);
  pass(std::integral_constant<int, BWD_DK>{}, dk, nullptr, smem_dk);
  pass(std::integral_constant<int, BWD_DQ>{}, dq, nullptr, smem_dq);
  return static_cast<int>(err);
}

}  // namespace
