// The float32 attention kernels at head dims past 128 on Hopper (sm_90a):
// TMA into mbarrier-guarded shared memory, splitter warps, and every product
// 3xTF32 wgmma. Included by attention_f32.cu after its tf32 section (the
// wgmma_tf32 forms, F32Panels, slab_f32, afrag_t, split_tile, split_vt), which
// launches them. They replace, past d = 128, the same TPU kernels of
// maskbit_tpu/nn/pallas_attention.py as the float32 templates for d <= 128:
//   * _dropattn_fwd_kernel and _attention_kernel (dropout_attention,
//     fused_attention, and the attention core of _attention_block_kernel),
//     by attn_fwd_wide_tf32_kernel<W, DROPOUT, STREAM>;
//   * _dropattn_bwd_kernel, by attention_wide.cuh's row-stats kernel
//     attn_bwd_wide_prep_kernel<float>, then attn_bwd_wide_tf32_kernel<false,
//     STREAM> (dK and dV) and attn_bwd_wide_tf32_kernel<true, STREAM> (dQ).
//
// Why they differ from the bf16 kernels past 128 (attention_wide_bf16.cuh).
// A 64 x 256 f32 tile is 64 KB and its TF32 hi and lo halves 128 KB, of a
// block's 227 KB; and .tf32 wgmma takes its shared-memory operands K-major
// only. So no block holds Q, K and V (or K, V, Q and G) whole, and the
// operands whose reduction runs along their rows are transposed by splitter
// warps or read transposed into registers.
//
// Widths. A head dim d runs at its padded width D (d rounded up to 16; the
// wrapper zero-pads each head). The forward is instantiated at W = 192 (D <=
// 192) and 256, and for D past 256 at W = 256 with STREAM; the backward at
// D <= 256 and with STREAM past it. Tensor maps are D wide, so TMA fills the
// columns past D with zeros (a box may lie wholly past them) and the stores
// skip them. Products that reduce over d walk it in 64-column chunks.
//
// Forward: one block per (64 queries, batch*head, output panel), 256
// threads: one consumer warpgroup and a producer warpgroup whose thread 0
// issues every TMA copy and whose warps 1..3 split (the splitters).
//   * Q stays resident: its 64 x W tile, split once into hi and lo halves
//     (128 KB at W = 256). Keys come in tiles of 32: per key tile, W / 64
//     items of a K chunk (32 keys x 64 columns, split into hi and lo in
//     place), then W / 64 items of a raw V chunk (32 keys x 64 output
//     columns), which the splitters turn into V^T's hi and lo halves (64
//     columns of d x 32 keys, K-major for the value product, in the key
//     order of split_vt) in one of two V^T stages. Items pass through a
//     ring of NS 16 KB slots (NS = 4 at W = 256, 6 at 192): 128 + 64 + 32
//     KB = 224 KB at W = 256.
//   * The consumer warpgroup sums S = Q K^T chunk by chunk (A and B from
//     shared memory, wgmma m64n32k8): each chunk's large products (hi hi)
//     and small ones into two fresh accumulators, added to the scores on
//     the CUDA cores, so that no truncating tensor-core accumulator runs
//     over all of d; a chunk's products run while the chunk before it is
//     added. Then the online softmax (softmax_tile, 32 keys), the weights
//     split into hi and lo A fragments in registers, and per 64-column
//     output chunk O += P V^T into a fresh accumulator (A from registers,
//     m64n64k8), added to O (rescaled by the row's alpha) on the CUDA cores
//     (at W = 192, which leaves the registers for a second accumulator,
//     chunk ch + 1's product runs while chunk ch is added). The whole W-wide
//     output row stays in registers (W / 2 f32 a thread, 128 at W = 256),
//     so each (query tile, key tile) score tile is computed once up to d =
//     256.
//   * Past d = 256 (STREAM) no Q tile fits: a block owns output columns
//     col0..col0+255 (grid z, ceil(D / 256) panels), each S item carries a
//     64-column Q chunk beside the K chunk (48 KB slots), and the scores are
//     computed ceil(D / 256) times.
//   * lse is written by the blocks of output panel 0.
//   * The splitters bound it: without V^T's transposes it ran 28-31% faster,
//     without K's splits 17-20%, without S's products 13-19%, without the
//     value products 5-9%, without the softmax no faster.

// Backward: the row stats (attention_wide.cuh's prep kernel: lse log2 e and
// delta = rowsum(g out) per query, padded to whole 64-row tiles), then two
// launches of one template, each one block per (64 rows of its own side,
// batch*head, output panel), looping over the other side in steps of 16
// rows, with two consumer warpgroups and a producer warpgroup (thread 0 the
// TMA loader, warps 1..3 the splitters; setmaxnreg gives the consumers 232
// registers and the producer warpgroup 40):
//   * dK and dV (DQ false): own rows keys. Warpgroup 0 computes S^T = K Q^T
//     (64 keys x 16 queries), the weights P^T = exp2(S^T scale log2 e - lse
//     log2 e) (0 past n), passed to warpgroup 1 through shared memory (two 4
//     KB buffers, one named barrier of both warpgroups a step), and the
//     dropped weights keep P^T / (1 - p), and sums dV; warpgroup 1 computes
//     dP^T = V G^T, dS^T = P^T (keep dP^T / (1 - p) - delta) scale, and sums
//     dK. A block writes 128 columns of each (grid z, ceil(D / 128) panels).
//   * dQ (DQ true): own rows queries. Warpgroup 0 computes S = Q K^T and P,
//     warpgroup 1 dP = G V^T and dS (to both warpgroups through shared
//     memory, two buffers); each sums 128 columns of dQ, so a block writes
//     256 (grid z, ceil(D / 256) panels).
//   * The own side's two tiles stay resident raw (64 x 256 f32 each, 128 KB);
//     each score product takes them as its A operand from registers, loaded
//     and split into TF32 halves by the consumer for each step, two k8 slabs
//     at a time into two buffers, so that their hi and lo halves never take
//     shared memory. The other side's 16
//     rows come chunk by chunk (both tensors' 64-column chunks, split in
//     place by the splitters: 16 KB) through a ring of four slots; the
//     updates' A operands (the other side's tensor transposed: G^T, Q^T or
//     K^T, 64 columns of d by 16 rows a wgmma) are read from those chunks
//     into registers by afrag_t as they pass, so no transposed copy is
//     written. Each update's B operand is the warpgroup's weights (the dropped
//     weights or the score gradient) in [own][other] order, split and
//     written to shared memory by the warpgroup that computed them. Each
//     update sums 16 rows into a fresh accumulator (m64n64k8, 128 columns of
//     d by the 64 own rows) that is added to the gradient on the CUDA cores,
//     and each chunk of a score product goes to three fresh accumulators,
//     one per product of the 3xTF32 split (issued in turn, so that none
//     waits on the one before it), added on the CUDA cores: no wgmma
//     accumulator runs over all of d or over the sequence.
//   * Past d = 256 (STREAM) the own side's chunks come through the ring too
//     (48 KB slots, no resident tiles).
//   * S^T and dP^T are computed once per dK/dV panel and S and dP once per
//     dQ panel: at d = 256 three times each per (key tile, query tile), in
//     the 64-column panelled mma.sync kernels these replace twelve and
//     eight. Every output element is written once, by one block, after sums
//     in a fixed order: no atomics, the results the same bit for bit on
//     every call. Shared memory: 128 KB own tiles, 4 x 16 KB of ring, 8 KB
//     of exchanged weights and 16 KB of update tiles: 218 KB, one block an
//     SM.
//
// What bounds them on the H100 (495 TFLOP/s TF32, 3.35 TB/s), at b = 32, n =
// 257, 4 heads of d = 256 (the flagship's hidden 1024 at 4 heads): the
// forward's products as 3xTF32 are 26 GFLOP (53 us) for 135 MB (40 us), the
// backward's 65 GFLOP (131 us) for 270 MB (81 us): bound by the products.
// The recomputed scores and the padded tiles (n = 257 takes 288 keys in
// the forward and 320 rows a side in the backward) are not in these counts,
// nor the splits, the transposes and the 20-odd f32 and integer operations
// a (query, key) pair of the softmax, the keep hash and the score gradient
// on the CUDA cores, nor the operands' splits into TF32 halves in registers
// (the forward's Q for every key tile, the backward's own tiles for every
// step). The backward's score products are m64n16k8 wgmmas, 16 other rows a
// step, which is what the shared memory leaves room for beside the own
// tiles: small products whose issue, not their arithmetic, sets their
// rate.
//
// Float32 rounds at none of the bf16 kernels' rounding points. The keep mask
// is the TPU kernel's hash of the unpadded (query, key) indices and the
// (batch, head) seed, bit for bit (dropout_attention.cu's header).

#pragma once

namespace {

constexpr int WF_KT = 32;              // keys a forward tile
constexpr int WF_PANEL = 256;          // output columns a forward or dQ block owns past d = 256
constexpr int WF_CHUNK = 64 * 64 * 4;  // a 64 x 64 f32 tile: a Q chunk, an own chunk: 16 KB
constexpr int WF_SPLITTERS = 96;       // the producer warpgroup's warps 1..3
constexpr int WF_BARS = 512;           // bytes kept for a block's barriers
constexpr int WB_NQ = 16;              // other-side rows a backward step
constexpr int WB_GRAD_PANEL = 128;     // columns of dK and dV a block writes, of dQ a warpgroup
static_assert(WF_SPLITTERS == F32F_SPLITTERS, "split_vt's splitters");
// The blocks' setmaxnreg: a block of 384 threads gets 168 registers a
// thread (65536 / 384, rounded down to 8); its producer warpgroup (the
// loader and the splitters, which spilled at 24) keeps 40 and gives the
// rest to the two consumer warpgroups: 2 x 232 + 40 = 3 x 168.
constexpr int WF_PRODUCER_REGS = 40;
constexpr int WF_CONSUMER_REGS = (3 * 168 - WF_PRODUCER_REGS) / 2 / 8 * 8;

// A (b, n, h, D) f32 tensor with element strides (sb, sn, sh) as a rank-4
// (d, n, h, b) map of (32 x rows) boxes, 128-byte swizzled; columns past D
// and rows past n read 0.
bool wide_map_f32(CUtensorMap* map, const void* base, int B, int n, int H, int D, long long sb,
                  long long sn, long long sh, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 4, static_cast<cuuint64_t>(sh) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// The 64-column chunk at column col0 of a `rows`-row tile (two 32-wide
// boxes, F32Panels<64>'s layout) into shared address dst, on barrier bar.
__device__ __forceinline__ void tma_chunk_f32(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int rows, int col0, int row, int h, int b) {
  tma_load_box(dst, map, bar, col0, row, h, b);
  tma_load_box(dst + rows * 128, map, bar, col0 + 32, row, h, b);
}

// The A fragments of slabs kk0.. kk0 + NSLAB - 1 of a raw 64 x 64 f32 tile
// (F32Panels<64>: Q's or an own chunk, rows of the warpgroup's m64 block),
// split into TF32 halves in registers: the operand of a product that
// reduces over d.
template <int NSLAB>
__device__ __forceinline__ void raw_frags(uint32_t (&hi)[NSLAB][4], uint32_t (&lo)[NSLAB][4],
                                          const uint8_t* tile, int kk0, int warp, int g, int c) {
#pragma unroll
  for (int kk = 0; kk < NSLAB; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * warp + g + 8 * (e & 1), col = 8 * (kk0 + kk) + c + 4 * (e >> 1);
      split_tf32_int(*reinterpret_cast<const float*>(tile + F32Panels<64>::offset(64, row, col)),
                     hi[kk][e], lo[kk][e]);
    }
}

// ------------------------------------------------------------ forward ----

// The forward's shared memory at width W: resident Q's hi and lo halves
// (none when STREAM) | NS ring slots | two V^T stages | barriers. A slot
// holds a K chunk's hi and lo halves (and with STREAM a Q chunk's), or a
// raw V chunk.
template <int W, bool STREAM>
struct WideF32Fwd {
  static_assert(W == 192 || W == 256, "width");
  static_assert(!STREAM || W == 256, "the streamed form is 256 wide");
  static constexpr int VC = W / 64;              // output chunks, V items a key tile
  static constexpr int QT = 64 * W * 4;          // Q's hi half; the lo half follows
  static constexpr int KC = WF_KT * 64 * 4;      // a K or V chunk: 8 KB
  static constexpr int SLOT = 2 * KC + (STREAM ? 2 * WF_CHUNK : 0);
  static constexpr int VT = 2 * 64 * WF_KT * 4;  // a V^T chunk's hi | lo: 16 KB
  static constexpr int RING = STREAM ? 0 : 2 * QT;
  static constexpr int NS_FIT = (F32_SMEM_LIMIT - 1024 - WF_BARS - RING - 2 * VT) / SLOT;
  static constexpr int NS = NS_FIT < 8 ? NS_FIT : 8;
  static constexpr int VTS = RING + NS * SLOT, BARS = VTS + 2 * VT;
  static constexpr int SMEM = BARS + WF_BARS + 1024;
  static_assert(NS >= 3 && SMEM <= F32_SMEM_LIMIT, "shared memory");
};

// tq: Q's map of 64-row boxes; tk, tv: K's and V's of 32-row boxes (all
// wide_map_f32, D wide). lse: written by the blocks of output panel 0, where
// not null.
template <int W, bool DROPOUT, bool STREAM>
__global__ void __launch_bounds__(256, 1)
attn_fwd_wide_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const int* __restrict__ seeds,
                          float* __restrict__ out, float* __restrict__ lse, int n, int H, int D,
                          float scale_log2, uint32_t threshold, float keep_scale) {
  using C = WideF32Fwd<W, STREAM>;
  constexpr int NS = C::NS, VC = C::VC, QT = C::QT, KC = C::KC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  // barriers: q_full | q_ready | full[NS] | ready[NS] | empty[NS] | vt_empty[2]
  const uint32_t base = smem_u32(smem), bar0 = base + C::BARS;
  const uint32_t q_full = bar0, q_ready = bar0 + 8;
  auto full = [&](int i) { return bar0 + 8 * (2 + i % NS); };
  auto ready = [&](int i) { return bar0 + 8 * (2 + NS + i % NS); };
  auto empty = [&](int i) { return bar0 + 8 * (2 + 2 * NS + i % NS); };
  auto vt_empty = [&](int v) { return bar0 + 8 * (2 + 3 * NS + (v & 1)); };
  auto slot = [&](int i) { return C::RING + (i % NS) * C::SLOT; };  // item i's byte offset
  auto use = [&](int i) { return (i / NS) & 1; };                   // its phase parity

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * 64, col0 = blockIdx.z * WF_PANEL;
  const int ntiles = (n + WF_KT - 1) / WF_KT;
  const int chunks = STREAM ? (D + 63) / 64 : W / 64;  // S items a key tile
  const int items = chunks + VC;                       // items a key tile

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BARS);
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], WF_SPLITTERS);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&bars[2 + s], 1);
      mbar_init(&bars[2 + NS + s], WF_SPLITTERS);
      mbar_init(&bars[2 + 2 * NS + s], CONSUMERS);
    }
    mbar_init(&bars[2 + 3 * NS], CONSUMERS);
    mbar_init(&bars[3 + 3 * NS], CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    const int pt = threadIdx.x - CONSUMERS;
    if (pt == 0) {  // loader: Q once, then per key tile its K chunks and its V chunks
      if (!STREAM) {
        mbar_expect_tx(q_full, QT);
        for (int p = 0; p < W / 32; ++p)
          tma_load_box(base + p * 64 * 128, &tq, q_full, 32 * p, q0, h, b);
      }
      for (int t = 0, i = 0; t < ntiles; ++t)
        for (int j = 0; j < items; ++j, ++i) {
          mbar_wait(empty(i), use(i) ^ 1);
          const uint32_t st = base + slot(i), fs = full(i);
          if (j < chunks) {
            mbar_expect_tx(fs, STREAM ? KC + WF_CHUNK : KC);
            tma_chunk_f32(st, opaque(&tk), fs, WF_KT, 64 * j, t * WF_KT, h, b);
            if (STREAM) tma_chunk_f32(st + 2 * KC, opaque(&tq), fs, 64, 64 * j, q0, h, b);
          } else {
            mbar_expect_tx(fs, KC);
            tma_chunk_f32(st, opaque(&tv), fs, WF_KT, col0 + 64 * (j - chunks), t * WF_KT, h, b);
          }
        }
    } else if (pt >= 32) {
      // splitters: Q, each K chunk (and with STREAM each Q chunk) into hi (in
      // place) and lo halves, each V chunk into V^T's halves
      const int sp = pt - 32;
      if (!STREAM) {
        mbar_wait(q_full, 0);
        split_tile<true>(smem, QT, QT, sp, WF_SPLITTERS);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(q_ready);
      }
      for (int t = 0, i = 0, vi = 0; t < ntiles; ++t)
        for (int j = 0; j < items; ++j, ++i) {
          mbar_wait(full(i), use(i));
          uint8_t* st = smem + slot(i);
          if (j < chunks) {
            split_tile<true>(st, KC, KC, sp, WF_SPLITTERS);
            if (STREAM) split_tile<true>(st + 2 * KC, WF_CHUNK, WF_CHUNK, sp, WF_SPLITTERS);
          } else {
            mbar_wait(vt_empty(vi), ((vi >> 1) & 1) ^ 1);
            split_vt<64, WF_KT>(st, smem + C::VTS + (vi & 1) * C::VT, C::VT / 2, sp);
            ++vi;
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(ready(i));
        }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const uint32_t row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t seed_mix = DROPOUT ? static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du : 0u;
  const uint32_t rmix[2] = {row0 * 0x9E3779B1u, (row0 + 8) * 0x9E3779B1u};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  float o[W / 2];  // element 4j + 2r + e: row row0 + 8r, column col0 + 8j + 2c + e
#pragma unroll
  for (int x = 0; x < W / 2; ++x) o[x] = 0.0f;

  // S chunk j (item it) into fresh accumulators: the large products (hi hi)
  // into t, the two small ones into t2
  float sc[WF_KT / 2], ta[WF_KT / 2], ta2[WF_KT / 2], tb[WF_KT / 2], tb2[WF_KT / 2];
  auto s_issue = [&](int it, int j, float(&t)[WF_KT / 2], float(&t2)[WF_KT / 2]) {
    mbar_wait(ready(it), use(it));
    const uint32_t kh = opaque(base + slot(it));
    const uint32_t qh = STREAM ? kh + 2 * KC : opaque(base) + j * WF_CHUNK;
    const uint32_t ql = qh + (STREAM ? WF_CHUNK : QT);
    fence_regs(t);
    fence_regs(t2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {  // t2's two products apart, so neither waits on the other
      wgmma_tf32_ss(t2, slab_f32<64>(ql, 64, kk), slab_f32<64>(kh, WF_KT, kk), kk == 0 ? 0 : 1);
      wgmma_tf32_ss(t, slab_f32<64>(qh, 64, kk), slab_f32<64>(kh, WF_KT, kk), kk == 0 ? 0 : 1);
      wgmma_tf32_ss(t2, slab_f32<64>(qh, 64, kk), slab_f32<64>(kh + KC, WF_KT, kk), 1);
    }
    wgmma_commit();
  };
  // chunk j's sums added to the scores on the CUDA cores, its slot released
  auto s_add = [&](int it, int j, float(&t)[WF_KT / 2], float(&t2)[WF_KT / 2]) {
    fence_regs(t);
    fence_regs(t2);
#pragma unroll
    for (int x = 0; x < WF_KT / 2; ++x) sc[x] = j == 0 ? t[x] + t2[x] : sc[x] + (t[x] + t2[x]);
    mbar_arrive(empty(it));
  };

  if (!STREAM) mbar_wait(q_ready, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int it0 = t * items;
    if constexpr (STREAM) {
      for (int j = 0; j < chunks; ++j) {
        s_issue(it0 + j, j, ta, ta2);
        wgmma_wait_all();
        s_add(it0 + j, j, ta, ta2);
      }
    } else {  // chunk j + 1's products run while chunk j is added
      s_issue(it0, 0, ta, ta2);
      static_for<W / 64>([&](auto jc) {
        constexpr int j = decltype(jc)::value;
        float(&cur)[WF_KT / 2] = j & 1 ? tb : ta;
        float(&cur2)[WF_KT / 2] = j & 1 ? tb2 : ta2;
        if constexpr (j + 1 < W / 64) {
          s_issue(it0 + j + 1, j + 1, j & 1 ? ta : tb, j & 1 ? ta2 : tb2);
          wgmma_wait<1>();
        } else {
          wgmma_wait_all();
        }
        s_add(it0 + j, j, cur, cur2);
      });
    }

    float alpha[2];
    softmax_tile<DROPOUT>(sc, m_run, l_run, alpha, t * WF_KT, n, c, scale_log2, rmix, seed_mix,
                          threshold, keep_scale);
    // the weights as the value product's A fragments, hi and lo: slab j's
    // column c is key 8j + 2c, column c + 4 key 8j + 2c + 1 (split_vt's order)
    uint32_t phi[WF_KT / 8][4], plo[WF_KT / 8][4];
#pragma unroll
    for (int j = 0; j < WF_KT / 8; ++j) {
      split_tf32_int(sc[4 * j], phi[j][0], plo[j][0]);
      split_tf32_int(sc[4 * j + 2], phi[j][1], plo[j][1]);
      split_tf32_int(sc[4 * j + 1], phi[j][2], plo[j][2]);
      split_tf32_int(sc[4 * j + 3], phi[j][3], plo[j][3]);
    }
    // O chunk ch += P V^T chunk ch, into a fresh accumulator added on the
    // CUDA cores with the rows' rescale; at W = 192, which leaves the
    // registers for a second accumulator, chunk ch + 1's product runs while
    // chunk ch is added
    auto pv_issue = [&](int ch, float(&pv)[32]) {
      const int it = it0 + chunks + ch, vi = t * VC + ch;
      mbar_wait(ready(it), use(it));
      mbar_arrive(empty(it));  // the raw V chunk is split: its slot is free
      const uint32_t vt = opaque(base + C::VTS + (vi & 1) * C::VT);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < WF_KT / 8; ++j)
        mma3_rs(pv, phi[j], plo[j], slab_f32<WF_KT>(vt, 64, j),
                slab_f32<WF_KT>(vt + C::VT / 2, 64, j), j == 0);
      wgmma_commit();
    };
    auto pv_add = [&](int ch, float(&pv)[32]) {
      fence_regs(pv);
      mbar_arrive(vt_empty(t * VC + ch));
#pragma unroll
      for (int x = 0; x < 32; ++x)
        o[32 * ch + x] = fmaf(o[32 * ch + x], alpha[(x >> 1) & 1], pv[x]);
    };
    float pa[32];
    if constexpr (W == 192) {
      float pb[32];
      pv_issue(0, pa);
      static_for<VC>([&](auto cc) {
        constexpr int ch = decltype(cc)::value;
        if constexpr (ch + 1 < VC) {
          pv_issue(ch + 1, ch & 1 ? pa : pb);
          wgmma_wait<1>();
        } else {
          wgmma_wait_all();
        }
        pv_add(ch, ch & 1 ? pb : pa);
      });
    } else {
      static_for<VC>([&](auto cc) {
        constexpr int ch = decltype(cc)::value;
        pv_issue(ch, pa);
        wgmma_wait_all();
        pv_add(ch, pa);
      });
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    const float inv = 1.0f / l_run[r];
    float* dst = out + (((long long)b * n + row) * H + h) * D + col0 + 2 * c;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      if (col0 + 8 * j < D)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (lse != nullptr && c == 0 && blockIdx.z == 0)
      lse[(long long)bh * n + row] = (m_run[r] + log2f(l_run[r])) * LN2;
  }
}

template <int W, bool DROPOUT, bool STREAM>
int launch_forward_wide_f32(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                            const int* seeds, float* out, float* lse, int B, int n, int H, int D,
                            int d, unsigned int threshold, float keep_scale, cudaStream_t s) {
  using C = WideF32Fwd<W, STREAM>;
  static unsigned long long smem_set;
  const cudaError_t err =
      ensure_smem(attn_fwd_wide_tf32_kernel<W, DROPOUT, STREAM>, C::SMEM, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + 63) / 64, B * H, STREAM ? (D + WF_PANEL - 1) / WF_PANEL : 1);
  attn_fwd_wide_tf32_kernel<W, DROPOUT, STREAM><<<grid, 2 * CONSUMERS, C::SMEM, s>>>(
      tq, tk, tv, seeds, out, lse, n, H, D, LOG2E / sqrtf(static_cast<float>(d)), threshold,
      keep_scale);
  return static_cast<int>(cudaGetLastError());
}

// The float32 forward at head dim d >= WIDE_MIN_D: the arguments of
// attention_forward_f32, the tensors at D = pad_head_dim(d).
template <bool DROPOUT>
int attention_forward_wide_f32(const float* q, const float* k, const float* v, long long sb,
                               long long sn, long long sh, const int* seeds, float* out,
                               float* lse, int B, int n, int H, int d, unsigned int threshold,
                               float keep_scale, cudaStream_t s) {
  const int D = pad_head_dim(d);
  CUtensorMap tq, tk, tv;
  if (!current_context() || !wide_map_f32(&tq, q, B, n, H, D, sb, sn, sh, 64) ||
      !wide_map_f32(&tk, k, B, n, H, D, sb, sn, sh, WF_KT) ||
      !wide_map_f32(&tv, v, B, n, H, D, sb, sn, sh, WF_KT))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > 256)
    return launch_forward_wide_f32<256, DROPOUT, true>(tq, tk, tv, seeds, out, lse, B, n, H, D, d,
                                                       threshold, keep_scale, s);
  if (D > 192)
    return launch_forward_wide_f32<256, DROPOUT, false>(tq, tk, tv, seeds, out, lse, B, n, H, D,
                                                        d, threshold, keep_scale, s);
  return launch_forward_wide_f32<192, DROPOUT, false>(tq, tk, tv, seeds, out, lse, B, n, H, D, d,
                                                      threshold, keep_scale, s);
}

// ----------------------------------------------------------- backward ----

// The backward's shared memory: the own side's raw tiles (S's operand, then
// dP's; 256 columns each; none when STREAM) | NS ring slots | two buffers of
// exchanged weights P | two update B tiles | barriers. A slot holds the
// other side's chunks (S's operand, then dP's; hi and lo halves each) and,
// with STREAM, the own side's raw chunks.
template <bool STREAM>
struct WideF32Bwd {
  static constexpr int OC = WB_NQ * 64 * 4;              // an other-side chunk: 4 KB
  static constexpr int OWN = STREAM ? 0 : 2 * 4 * WF_CHUNK;
  static constexpr int SLOT = 4 * OC + (STREAM ? 2 * WF_CHUNK : 0);
  static constexpr int XF = 64 * WB_NQ * 4;              // P, f32: 4 KB
  static constexpr int WT = 2 * 64 * WB_NQ * 4;          // an update's B tile, hi | lo: 8 KB
  static constexpr int FIXED = OWN + 2 * XF + 2 * WT;
  static constexpr int NS_FIT = (F32_SMEM_LIMIT - 1024 - WF_BARS - FIXED) / SLOT;
  static constexpr int NS = NS_FIT < 8 ? NS_FIT : 8;
  static constexpr int RING = OWN, XFS = RING + NS * SLOT, WTS = XFS + 2 * XF, BARS = WTS + 2 * WT;
  static constexpr int SMEM = BARS + WF_BARS + 1024;
  static_assert(NS >= 3 && SMEM <= F32_SMEM_LIMIT, "shared memory");
};

// One block per (64-row tile of its own side, batch*head, output panel).
// DQ false: own rows keys; t_own_s, t_own_p: K's and V's maps of 64-row
// boxes, t_oth_s, t_oth_p: Q's and G's (the incoming gradient's) of 16-row
// boxes; out0 = dv, out1 = dk, 128-column panels. DQ true: own rows queries;
// Q and G own, K and V other; out0 = out1 = dq, 256-column panels (128 a
// warpgroup). stats: (B*H, n_pad) (lse log2 e, delta). All maps D wide
// (wide_map_f32), the outputs contiguous (B, n, H, D).
template <bool DQ, bool STREAM>
__global__ void __launch_bounds__(3 * CONSUMERS, 1)
attn_bwd_wide_tf32_kernel(const __grid_constant__ CUtensorMap t_own_s,
                          const __grid_constant__ CUtensorMap t_own_p,
                          const __grid_constant__ CUtensorMap t_oth_s,
                          const __grid_constant__ CUtensorMap t_oth_p,
                          const float2* __restrict__ stats, const int* __restrict__ seeds,
                          float* __restrict__ out0, float* __restrict__ out1, int n, int H, int D,
                          int n_pad, float scale, float scale_log2, uint32_t threshold,
                          float keep_scale) {
  using C = WideF32Bwd<STREAM>;
  constexpr int NS = C::NS, OC = C::OC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  // barriers: own_full | full[NS] | ready[NS] | empty[NS]
  const uint32_t base = smem_u32(smem), bar0 = base + C::BARS;
  auto full = [&](int i) { return bar0 + 8 * (1 + i % NS); };
  auto ready = [&](int i) { return bar0 + 8 * (1 + NS + i % NS); };
  auto empty = [&](int i) { return bar0 + 8 * (1 + 2 * NS + i % NS); };
  auto slot = [&](int i) { return C::RING + (i % NS) * C::SLOT; };
  auto use = [&](int i) { return (i / NS) & 1; };

  const int own0 = blockIdx.x * 64, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int steps = (n + WB_NQ - 1) / WB_NQ;
  const int chunks = (D + 63) / 64;  // score items a step (at most 4 without STREAM)
  const float2* st_bh = stats + (long long)bh * n_pad;

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BARS);
    mbar_init(&bars[0], 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + NS + s], WF_SPLITTERS);
      mbar_init(&bars[1 + 2 * NS + s], 2 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WF_PRODUCER_REGS) : "memory");
    const int pt = threadIdx.x - 2 * CONSUMERS;
    if (pt == 0) {  // loader: the own tiles once, then the other side's chunks a step
      if (!STREAM) {
        mbar_expect_tx(bar0, 2 * chunks * WF_CHUNK);
        for (int j = 0; j < chunks; ++j) {
          tma_chunk_f32(base + j * WF_CHUNK, &t_own_s, bar0, 64, 64 * j, own0, h, b);
          tma_chunk_f32(base + (4 + j) * WF_CHUNK, &t_own_p, bar0, 64, 64 * j, own0, h, b);
        }
      }
      for (int s = 0, i = 0; s < steps; ++s)
        for (int j = 0; j < chunks; ++j, ++i) {
          mbar_wait(empty(i), use(i) ^ 1);
          const uint32_t st = base + slot(i), fs = full(i);
          mbar_expect_tx(fs, 2 * OC + (STREAM ? 2 * WF_CHUNK : 0));
          tma_chunk_f32(st, opaque(&t_oth_s), fs, WB_NQ, 64 * j, s * WB_NQ, h, b);
          tma_chunk_f32(st + 2 * OC, opaque(&t_oth_p), fs, WB_NQ, 64 * j, s * WB_NQ, h, b);
          if (STREAM) {
            tma_chunk_f32(st + 4 * OC, opaque(&t_own_s), fs, 64, 64 * j, own0, h, b);
            tma_chunk_f32(st + 4 * OC + WF_CHUNK, opaque(&t_own_p), fs, 64, 64 * j, own0, h, b);
          }
        }
    } else if (pt >= 32) {  // splitters: both other-side chunks into hi (in place) and lo
      const int sp = pt - 32;
      for (int i = 0; i < steps * chunks; ++i) {
        mbar_wait(full(i), use(i));
        uint8_t* st = smem + slot(i);
        split_tile<true>(st, OC, OC, sp, WF_SPLITTERS);
        split_tile<true>(st + 2 * OC, OC, OC, sp, WF_SPLITTERS);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(ready(i));
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WF_CONSUMER_REGS) : "memory");
  const int wg = threadIdx.x / CONSUMERS, tid = threadIdx.x % CONSUMERS;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int own_row = own0 + warp * 16 + g;  // this thread's rows: own_row, own_row + 8
  const uint32_t seed_mix = static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du;
  // the own rows' terms of the keep hash, and (dQ) their stats
  const uint32_t own_mul = DQ ? 0x9E3779B1u : 0x85EBCA77u, oth_mul = DQ ? 0x85EBCA77u : 0x9E3779B1u;
  const uint32_t own_mix[2] = {static_cast<uint32_t>(own_row) * own_mul + seed_mix,
                               static_cast<uint32_t>(own_row + 8) * own_mul + seed_mix};
  float2 own_st[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
  if (DQ) own_st[0] = st_bh[own_row], own_st[1] = st_bh[own_row + 8];

  // this warpgroup's update: columns ucol.. ucol + 127 of its gradient, from
  // the other side's chunks uch and uch + 1 (those within D): G's (dV), Q's
  // (dK) or K's (dQ) part of a slot. Its wgmmas run whether or not the
  // columns lie within D (on zero fragments past it): a wgmma issued on a
  // path that depends on the warpgroup makes ptxas serialise them all
  const int ucol = DQ ? blockIdx.z * WF_PANEL + wg * WB_GRAD_PANEL : blockIdx.z * WB_GRAD_PANEL;
  const int uch = ucol / 64;
  const int usrc = !DQ && wg == 0 ? 2 * OC : 0;
  // the score product's operands: the own tile (raw, resident or in the
  // slot) and the other side's chunk in the slot (hi, lo OC after)
  const int own_off = STREAM ? 4 * OC + wg * WF_CHUNK : wg * 4 * WF_CHUNK;
  const int oth_off = wg * 2 * OC;

  float acc[2][32];  // the gradient's transpose: d rows ucol + 64 mb .., the 64 own rows
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[mb][x] = 0.0f;

  if (!STREAM) mbar_wait(bar0, 0);
  for (int s = 0, i = 0; s < steps; ++s) {
    const int oth0 = s * WB_NQ;
    // warpgroup 0: S (or S^T) = own_s oth_s^T; warpgroup 1: dP (or dP^T) =
    // own_p oth_p^T. Each 64-column chunk goes to three fresh accumulators,
    // one per product of the 3xTF32 split (so that no wgmma waits on the one
    // before it), added on the CUDA cores; its own-side fragments are loaded
    // and split two slabs at a time into two buffers, each refilled once the
    // wgmmas reading it are done.
    float x[WB_NQ / 2];
    uint32_t uh[2][2][4], ul[2][2][4];  // the update's A fragments [mb][kk]
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) uh[mb][kk][e] = ul[mb][kk][e] = 0u;
    float2 ost[4];  // the other rows' stats (dK/dV), loaded during the last chunk
    for (int j = 0; j < chunks; ++j, ++i) {
      mbar_wait(ready(i), use(i));
      const uint8_t* own = smem + (STREAM ? slot(i) : 0) + own_off + (STREAM ? 0 : j * WF_CHUNK);
      const uint32_t bo = opaque(base + slot(i) + oth_off);
      float t[WB_NQ / 2], ta[WB_NQ / 2], tb[WB_NQ / 2];
      uint32_t fh[2][2][4], fl[2][2][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= 2) wgmma_wait<1>();  // the wgmmas of slabs 2q - 4, 2q - 3 are done
        raw_frags<2>(fh[q & 1], fl[q & 1], own, 2 * q, warp, g, c);
        wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          const int kk = 2 * q + k2;
          wgmma_tf32_rs(ta, fl[q & 1][k2], slab_f32<64>(bo, WB_NQ, kk), kk == 0 ? 0 : 1);
          wgmma_tf32_rs(t, fh[q & 1][k2], slab_f32<64>(bo, WB_NQ, kk), kk == 0 ? 0 : 1);
          wgmma_tf32_rs(tb, fh[q & 1][k2], slab_f32<64>(bo + OC, WB_NQ, kk), kk == 0 ? 0 : 1);
        }
        wgmma_commit();
      }
      // the update's A fragments: this chunk's other-side rows read
      // transposed (64 columns of d by 16 rows), while the products run
      if (j == uch || j == uch + 1) {
        const uint8_t* src = smem + slot(i) + usrc;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (j == uch)
            afrag_t<64>(uh[0][kk], ul[0][kk], src, OC, WB_NQ, kk, 0, warp, g, c, D - 64 * j);
          else
            afrag_t<64>(uh[1][kk], ul[1][kk], src, OC, WB_NQ, kk, 0, warp, g, c, D - 64 * j);
        }
      }
      // element e of a score tile: own row own_row + 8 ((e >> 1) & 1), other
      // row oth0 + 8 (e >> 2) + 2c + (e & 1)
      if (!DQ && j == chunks - 1)
#pragma unroll
        for (int m = 0; m < 4; ++m) ost[m] = st_bh[oth0 + 8 * (m >> 1) + 2 * c + (m & 1)];
      wgmma_wait_all();
      fence_regs(t);
      fence_regs(ta);
      fence_regs(tb);
#pragma unroll
      for (int e = 0; e < WB_NQ / 2; ++e) {
        const float sum = t[e] + (ta[e] + tb[e]);
        x[e] = j == 0 ? sum : x[e] + sum;
      }
      mbar_arrive(empty(i));
    }

    float4* xf = reinterpret_cast<float4*>(smem + C::XFS + (s & 1) * C::XF);
    float w[WB_NQ / 2];  // the update's weights: dropped (dK/dV, warpgroup 0) or dS
    if (wg == 0) {
      // the weights, 0 past n, to warpgroup 1; the dropped weights
#pragma unroll
      for (int e = 0; e < WB_NQ / 2; ++e) {
        const int r = (e >> 1) & 1, oth = oth0 + 8 * (e >> 2) + 2 * c + (e & 1);
        const float lse2 = DQ ? own_st[r].x : ost[2 * (e >> 2) + (e & 1)].x;
        x[e] = own_row + 8 * r < n && oth < n ? exp2f(fmaf(x[e], scale_log2, -lse2)) : 0.0f;
      }
      xf[tid] = make_float4(x[0], x[1], x[2], x[3]);
      xf[CONSUMERS + tid] = make_float4(x[4], x[5], x[6], x[7]);
      if (!DQ)
#pragma unroll
        for (int e = 0; e < WB_NQ / 2; ++e) {
          const uint32_t oth = oth0 + 8 * (e >> 2) + 2 * c + (e & 1);
          w[e] = fmix(oth * oth_mul + own_mix[(e >> 1) & 1]) >= threshold ? x[e] * keep_scale
                                                                          : 0.0f;
        }
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * CONSUMERS) : "memory");
    } else {
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * CONSUMERS) : "memory");
      // dS = P (keep dP / (1 - p) - delta) scale
      const float4 p4[2] = {xf[tid], xf[CONSUMERS + tid]};
      const float p[8] = {p4[0].x, p4[0].y, p4[0].z, p4[0].w, p4[1].x, p4[1].y, p4[1].z, p4[1].w};
#pragma unroll
      for (int e = 0; e < WB_NQ / 2; ++e) {
        const int r = (e >> 1) & 1;
        const uint32_t oth = oth0 + 8 * (e >> 2) + 2 * c + (e & 1);
        const float delta = DQ ? own_st[r].y : ost[2 * (e >> 2) + (e & 1)].y;
        const bool keep = fmix(oth * oth_mul + own_mix[r]) >= threshold;
        w[e] = p[e] * ((keep ? x[e] * keep_scale : 0.0f) - delta) * scale;
      }
    }

    // the update's B operand: the weights as a [own][other] tile, hi and lo
    // (dK/dV: each warpgroup its own; dQ: warpgroup 1's dS for both, two
    // buffers)
    const int wt_off = C::WTS + (DQ ? (s & 1) : wg) * C::WT;
    if (!DQ || wg == 1) {
      // dK/dV: every warp of the warpgroup is done with the last update
      if (!DQ) asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(CONSUMERS) : "memory");
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = F32Panels<WB_NQ>::offset(64, 16 * warp + g + 8 * r, 8 * j2 + 2 * c);
          uint32_t h0, l0, h1, l1;
          split_tf32_int(w[4 * j2 + 2 * r], h0, l0);
          split_tf32_int(w[4 * j2 + 2 * r + 1], h1, l1);
          *reinterpret_cast<uint2*>(smem + wt_off + off) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(smem + wt_off + C::WT / 2 + off) = make_uint2(l0, l1);
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    if (DQ)
      asm volatile("bar.sync 4, %0;\n" ::"n"(2 * CONSUMERS) : "memory");  // dS written
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(CONSUMERS) : "memory");

    // the gradient's transpose += (other side's chunk)^T weights over this
    // step's 16 rows, into a fresh accumulator added on the CUDA cores
    const uint32_t wt = opaque(base + wt_off);
    float fr[2][32];
    wgmma_fence();
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma3_rs(fr[mb], uh[mb][kk], ul[mb][kk], slab_f32<WB_NQ>(wt, 64, kk),
                slab_f32<WB_NQ>(wt + C::WT / 2, 64, kk), kk == 0);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      fence_regs(fr[mb]);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[mb][e] += fr[mb][e];
    }
  }

  // element 4j + 2r + e of acc[mb]: d row ucol + 64 mb + 16 warp + g + 8r, own
  // row own0 + 8j + 2c + e
  float* dst = wg == 0 ? out0 : out1;
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    if (ucol + 64 * mb >= D) continue;
    const int dd = ucol + 64 * mb + 16 * warp + g;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int own = own0 + 8 * j + 2 * c + e;
        if (own >= n) continue;
        const long long o = (((long long)b * n + own) * H + h) * D + dd;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (dd + 8 * r < D) dst[o + 8 * r] = acc[mb][4 * j + 2 * r + e];
      }
  }
}

template <bool DQ, bool STREAM>
cudaError_t launch_backward_wide_f32(const CUtensorMap* maps, const float2* stats,
                                     const int* seeds, float* out0, float* out1, int B, int n,
                                     int H, int D, int n_pad, float scale, unsigned int threshold,
                                     float keep_scale, cudaStream_t s) {
  using C = WideF32Bwd<STREAM>;
  static unsigned long long smem_set;
  const cudaError_t err = ensure_smem(attn_bwd_wide_tf32_kernel<DQ, STREAM>, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const int panel = DQ ? WF_PANEL : WB_GRAD_PANEL;
  const dim3 grid((n + 63) / 64, B * H, (D + panel - 1) / panel);
  attn_bwd_wide_tf32_kernel<DQ, STREAM><<<grid, 3 * CONSUMERS, C::SMEM, s>>>(
      maps[0], maps[1], maps[2], maps[3], stats, seeds, out0, out1, n, H, D, n_pad, scale,
      scale * LOG2E, threshold, keep_scale);
  return cudaGetLastError();
}

// The float32 backward at head dim d >= WIDE_MIN_D: the row stats, then the
// dK/dV and the dQ kernels. The arguments of mb_dropout_attention_bwd_f32
// (stats (B*H, n_pad) float2 scratch; no tickets), the tensors at D =
// pad_head_dim(d).
int attention_backward_wide_f32(const float* q, const float* k, const float* v, long long sb,
                                long long sn, long long sh, const float* out, const float* grad,
                                const float* lse, const int* seeds, float* dq, float* dk,
                                float* dv, float2* stats, int B, int n, int H, int d,
                                unsigned int threshold, float keep_scale, cudaStream_t s) {
  const int D = pad_head_dim(d);
  const int n_pad = (n + 63) / 64 * 64;
  const long long gn = static_cast<long long>(H) * D;  // grad's row stride
  // [0..3]: the dK/dV kernel's own K, V (64-row boxes) and other Q, G (16-row
  // boxes); [4..7]: the dQ kernel's own Q, G and other K, V
  CUtensorMap maps[8];
  if (!current_context() || !wide_map_f32(&maps[0], k, B, n, H, D, sb, sn, sh, 64) ||
      !wide_map_f32(&maps[1], v, B, n, H, D, sb, sn, sh, 64) ||
      !wide_map_f32(&maps[2], q, B, n, H, D, sb, sn, sh, WB_NQ) ||
      !wide_map_f32(&maps[3], grad, B, n, H, D, gn * n, gn, D, WB_NQ) ||
      !wide_map_f32(&maps[4], q, B, n, H, D, sb, sn, sh, 64) ||
      !wide_map_f32(&maps[5], grad, B, n, H, D, gn * n, gn, D, 64) ||
      !wide_map_f32(&maps[6], k, B, n, H, D, sb, sn, sh, WB_NQ) ||
      !wide_map_f32(&maps[7], v, B, n, H, D, sb, sn, sh, WB_NQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * n_pad * H;
  attn_bwd_wide_prep_kernel<float><<<static_cast<unsigned>((rows * 32 + 127) / 128), 128, 0, s>>>(
      out, grad, lse, stats, n, n_pad, H, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  if (D > 256) {
    err = launch_backward_wide_f32<false, true>(maps, stats, seeds, dv, dk, B, n, H, D, n_pad,
                                                scale, threshold, keep_scale, s);
    if (err == cudaSuccess)
      err = launch_backward_wide_f32<true, true>(maps + 4, stats, seeds, dq, dq, B, n, H, D,
                                                 n_pad, scale, threshold, keep_scale, s);
  } else {
    err = launch_backward_wide_f32<false, false>(maps, stats, seeds, dv, dk, B, n, H, D, n_pad,
                                                 scale, threshold, keep_scale, s);
    if (err == cudaSuccess)
      err = launch_backward_wide_f32<true, false>(maps + 4, stats, seeds, dq, dq, B, n, H, D,
                                                  n_pad, scale, threshold, keep_scale, s);
  }
  return static_cast<int>(err);
}

}  // namespace
