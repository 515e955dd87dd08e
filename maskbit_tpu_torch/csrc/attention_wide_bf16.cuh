// The bf16 attention kernels at head dims past 128 on Hopper (sm_90a):
// TMA into mbarrier-guarded shared memory, products by wgmma. Included by
// attention_fwd.cuh after softmax_tile, so every library that builds the
// forward has them (dropout_attention.cu and attention_block.cu launch
// them; attention_f32.cu, whose float32 kernels past 128 are the 3xTF32
// ones of attention_wide_f32.cuh, instantiates none). They replace, past d =
// 128, the same TPU kernels of maskbit_tpu/nn/pallas_attention.py as the
// templates for d <= 128:
//   * _dropattn_fwd_kernel and _attention_kernel (dropout_attention,
//     fused_attention, and the attention core of _attention_block_kernel),
//     by attn_fwd_wide_bf16_kernel<W, DROPOUT, STREAM, WG>;
//   * _dropattn_bwd_kernel, by attention_wide.cuh's row-stats kernel
//     attn_bwd_wide_prep_kernel<bf16>, then attn_bwd_wide_bf16_kernel<W,
//     false, STREAM> (dK and dV) and attn_bwd_wide_bf16_kernel<W, true,
//     STREAM> (dQ).
//
// Widths. The kernels are instantiated at W = 192 and 256, and for d past
// 256 at W = 256 with STREAM. A head dim d runs at its padded width D (d
// rounded up to 16, as below 128: the wrapper zero-pads each head) on the
// instantiation W = 192 (D <= 192) or 256; the tensor maps are D wide, so
// TMA fills the columns D..W-1 of every tile with zeros and the stores skip
// them. Instantiating every multiple of 16 instead would save the padded
// products (at d = 144, 33% more than d needs; at 208 and 224, 23% and 14%;
// nothing at 192 and 256, the widths the models run) for four times the
// instantiations: each of these kernels takes ptxas several seconds, and
// the libraries are built at first use on the card.
//
// Tiles are 64 rows (queries or keys) of W bf16 columns, stored as W / 64
// TMA boxes of 64 x 64 (128-byte rows, 128-byte swizzle) one after the
// other: the layout of attention_fwd.cuh's column panels at a width that is
// a multiple of 64 (Panels<W>), so its descriptors (slab_desc, panel_desc)
// and accumulator views (panel_acc) serve here too. Products that reduce
// over d walk it in 16-wide K-major slabs; products whose columns are d
// take the tile as an MN-major operand, one wgmma m64n64k16 a box.
//
// Forward: one block per (64 * WG queries, batch*head), WG consumer
// warpgroups of 64 queries each and a producer warp (one warpgroup) or
// warpgroup (two). The Q tiles stay
// resident (64 x W bf16 each, 32 KB at W = 256), K and V tiles stream
// through a two-stage ring (2 x 64 KB at W = 256); S = Q K^T over all of d
// (W / 16 wgmma slabs into 32 f32), the online softmax of the narrow
// kernels (softmax_tile), then O += bf16(w) V with the weights as the A
// operand from registers and the whole W-wide output in the warpgroup's
// registers (W / 2 f32 a thread, 128 at W = 256). Each (query tile, key
// tile) score tile is computed once. Shared memory: 160 KB at W = 256 with
// one warpgroup, 192 KB with two (the two share every K and V tile, and
// one's softmax overlaps the other's products; wide_fwd_warpgroups picks
// the count); one block an SM. Past d = 256 (STREAM, one
// warpgroup) no Q tile fits beside the ring: a block owns the output
// columns col0..col0+255 (grid z, ceil(D / 256) panels), and each key tile
// takes ceil(D / 256) items of (Q chunk, K chunk), 256 columns each, then
// its V panel; the scores are computed once per panel, ceil(D / 256) times.
//
// Backward: one launch of row stats (attention_wide.cuh's prep kernel:
// lse * log2 e and delta = rowsum(g * out) per query, padded to whole
// tiles), then two kernels of the same template, each one block per
// (64-row tile of its own side, batch*head) looping over the other side's
// tiles, with two consumer warpgroups and a producer warpgroup:
//   * dK and dV (DQ false): own rows are keys. K and V resident, Q and G
//     (the incoming gradient) tiles and their queries' stats through a
//     two-stage ring. Warpgroup 0 computes S^T = K Q^T, the weights P^T =
//     exp2(S^T scale log2 e - lse log2 e) (0 past n) and the dropped weights
//     keep P^T / (1 - p), and sums dV += bf16(dropped^T) G; warpgroup 1
//     computes dP^T = V G^T, takes P^T from warpgroup 0 through shared
//     memory (f32, 16 KB, two buffers, so that warpgroup 0 runs up to one
//     tile ahead; one named barrier of the two warpgroups a tile), forms
//     dS^T = P^T (keep dP^T / (1 - p) - delta) scale and sums dK +=
//     bf16(dS^T) Q. Each sums all W columns of its gradient (W / 2 f32 a
//     thread), its A operand from registers.
//   * dQ (DQ true): own rows are queries, Q and G resident, K and V tiles
//     streamed. Warpgroup 0 computes S = Q K^T and the weights; warpgroup 1
//     dP = G V^T, dS, and dQ += bf16(dS) K over the key tiles.
// So S^T and dP^T are computed twice per (key tile, query tile) pair, once
// in each kernel, against about eight times at d = 256 in the panelled
// kernels these replace. Every output element is written once, by one
// block, after sums in a fixed order: no atomics, and the results are the
// same bit for bit on every call. Shared memory at W = 256: 64 KB of own
// tiles, 2 x 64 KB of ring, 32 KB of weights and 1 KB of stats: 225 KB, one
// block an SM. Past d = 256 (STREAM) a block owns output columns
// col0..col0+255 (grid z): each other-side tile takes ceil(D / 128) items
// of four 128-column chunks (own and other side's operands of S and dP),
// then one of the other side's 256-column panels (and in the dK/dV kernel
// its stats); S^T and dP^T are computed ceil(D / 256) times in each kernel.
//
// Registers: a consumer thread holds its gradient or output (W / 2 f32),
// the 32 f32 of a score tile and 16 packed bf16 fragments. ptxas reports
// each instantiation's registers and spills, which chip_smoke.py prints
// and requires to have no spill.
//
// What bounds them on the H100 (989 TFLOP/s bf16, 3.35 TB/s), at b = 32, n
// = 257, 4 heads of d = 256 (the flagship's hidden 1024 at 4 heads): the
// forward's products are 8.7 GFLOP (9 us) for 67 MB (20 us); the backward's
// 21.6 GFLOP (22 us) for 135 MB (40 us): bound by the bytes. Per (query,
// key) pair the kernels also do about 20 f32 and integer operations on the
// CUDA cores (exp2, the keep hash, the dropout select, the score gradient),
// which no bound counts; 64-row tiles pad n = 257 to 320.
//
// Rounding points as the narrow kernels': the unnormalised weights are
// rounded to bf16 before the value product, the dropped weights before dV
// and the score gradient before dQ and dK. The keep mask is the TPU
// kernel's hash of the unpadded (query, key) indices and the (batch, head)
// seed, bit for bit (dropout_attention.cu's header).

#pragma once

namespace {

constexpr int WB_PANEL = 256;       // output columns a block owns past d = 256
constexpr int WB_CHUNK = 128;       // columns of a streamed backward score chunk
constexpr int WB_BOX = TILE * 128;  // one 64 x 64 bf16 box, 128-byte swizzled: 8 KB

// The forward's consumer warpgroups a block up to d = 256, as measured on
// the H100 (PERF.md §6): two, sharing every K and V tile, were 3-7% faster
// than one at W = 192 and 2% with dropout at 256; without dropout at 256
// one was 8% faster.
constexpr int wide_fwd_warpgroups(int W, bool DROPOUT) { return W == 256 && !DROPOUT ? 1 : 2; }

// Blocks of two consumer warpgroups and a producer warpgroup (one thread
// of it issues the copies): ptxas gives a block of 384 threads 168
// registers a thread (65536 / 384, rounded down to 8), which spilled the
// consumers' W / 2 output f32 at W = 256, so setmaxnreg moves the
// producers' registers to the consumers: 2 x 240 + 24 = 3 x 168. (A block
// of 288 threads, with a producer warp, is given the same 168: ptxas
// counts whole warpgroups.)
constexpr int WIDE_PRODUCER_REGS = 24;
constexpr int WIDE_CONSUMER_REGS = (3 * 168 - WIDE_PRODUCER_REGS) / 2 / 8 * 8;

// The producer warpgroup's and the consumers' register counts.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WIDE_PRODUCER_REGS) : "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WIDE_CONSUMER_REGS) : "memory");
}

// The instantiation width of padded head dim D <= 256.
__host__ __device__ constexpr int wide_width(int D) { return D <= 192 ? 192 : 256; }

// nbox consecutive boxes of a row's columns col0, col0 + 64, ... into the
// tile at shared address dst, on barrier bar; columns past the map's D
// arrive as zeros.
template <int NBOX>
__device__ __forceinline__ void tma_boxes(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int col0, int row, int h, int b) {
#pragma unroll
  for (int j = 0; j < NBOX; ++j) tma_load_box(dst + j * WB_BOX, map, bar, col0 + 64 * j, row, h, b);
}

// The two consumer warpgroups of a backward block (the producer
// warpgroup takes no part).
__device__ __forceinline__ void warpgroups_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * CONSUMERS) : "memory");
}

// Columns 8j + 2c, 8j + 2c + 1 (j < W / 8) of a thread's rows row0 and row0 +
// 8 of a (B, n, H, D) bf16 tensor from the accumulators of a m64nW product,
// from column col0 on; rows past n and columns past D are not written.
template <int W>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[W / 2], int row0, int col0,
                                           int c, int b, int n, int H, int h, int D,
                                           const float (&mul)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    bf16* p = dst + (((long long)b * n + row) * H + h) * D + col0 + 2 * c;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      if (col0 + 8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul[r], acc[4 * j + 2 * r + 1] * mul[r]);
  }
}

// ------------------------------------------------------------ forward ----

template <int W, bool STREAM, int WG>
struct WideFwd {
  static_assert(W == 192 || W == 256, "width");
  static_assert(!STREAM || (W == 256 && WG == 1), "the streamed form is one 256-wide warpgroup");
  static constexpr int TB = TILE * W * 2;  // a 64-row tile
  // one warpgroup and a producer warp, or two and a producer warpgroup
  static constexpr int THREADS = WG == 1 ? CONSUMERS + 32 : 3 * CONSUMERS;
  // Shared memory: Q tiles (WG, resident; none when STREAM) | ring of
  // STAGES x (K | V), or (Q chunk | K chunk) and V panels | barriers.
  static constexpr int RING = STREAM ? 0 : WG * TB;
  static constexpr int BARS = RING + 2 * STAGES * TB;
  static constexpr int SMEM = BARS + 64 + 1024;
};

// tq, tk, tv: D-wide maps of 64 x 64 boxes (wide_map). lse: written by the
// blocks of output panel 0, where not null.
template <int W, bool DROPOUT, bool STREAM, int WG>
__global__ void __launch_bounds__(WideFwd<W, STREAM, WG>::THREADS, 1)
attn_fwd_wide_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const int* __restrict__ seeds,
                          bf16* __restrict__ out, float* __restrict__ lse, int n, int H, int D,
                          float scale_log2, uint32_t threshold, float keep_scale) {
  using C = WideFwd<W, STREAM, WG>;
  constexpr int TB = C::TB, NB = W / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  // barriers: q_full | full[STAGES] | empty[STAGES], as 32-bit shared addresses
  const uint32_t base = smem_u32(smem), bar0 = base + C::BARS;
  auto full = [&](int s) { return bar0 + 8 * (1 + s); };
  auto empty = [&](int s) { return bar0 + 8 * (1 + STAGES + s); };
  auto stage = [&](int s) { return base + C::RING + s * 2 * TB; };

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * WG * TILE, col0 = blockIdx.z * WB_PANEL;
  const int ntiles = (n + TILE - 1) / TILE;
  const int chunks = STREAM ? (D + WB_PANEL - 1) / WB_PANEL : 0;  // score items a key tile

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BARS);
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + STAGES + s], WG * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG * CONSUMERS) {  // producers: one thread issues every copy
    if (WG == 2) producer_regs();
    if (threadIdx.x == WG * CONSUMERS) {
      if (!STREAM) {
        mbar_expect_tx(bar0, WG * TB);
        for (int w = 0; w < WG; ++w) tma_boxes<NB>(base + w * TB, &tq, bar0, 0, q0 + w * TILE, h, b);
      }
      int i = 0;  // ring items: per key tile one (K, V), or chunks (Q, K) and a V panel
      for (int t = 0; t < ntiles; ++t)
        for (int j = 0; j <= chunks; ++j, ++i) {
          const int s = i % STAGES;
          mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
          const uint32_t st = stage(s);
          if (!STREAM) {
            mbar_expect_tx(full(s), 2 * TB);
            tma_boxes<NB>(st, opaque(&tk), full(s), 0, t * TILE, h, b);
            tma_boxes<NB>(st + TB, opaque(&tv), full(s), 0, t * TILE, h, b);
          } else if (j < chunks) {
            mbar_expect_tx(full(s), 2 * TB);
            tma_boxes<NB>(st, opaque(&tq), full(s), j * WB_PANEL, q0, h, b);
            tma_boxes<NB>(st + TB, opaque(&tk), full(s), j * WB_PANEL, t * TILE, h, b);
          } else {
            mbar_expect_tx(full(s), TB);
            tma_boxes<NB>(st, opaque(&tv), full(s), col0, t * TILE, h, b);
          }
        }
    }
    return;
  }

  if (WG == 2) consumer_regs();
  const int wg = threadIdx.x / CONSUMERS, tid = threadIdx.x % CONSUMERS;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int qw = q0 + wg * TILE;  // this warpgroup's first query
  const bool active = qw < n;     // a second warpgroup wholly past n only keeps the ring turning
  const uint32_t row0 = qw + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const uint32_t seed_mix = DROPOUT ? static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du : 0u;
  const uint32_t rmix[2] = {row0 * 0x9E3779B1u, (row0 + 8) * 0x9E3779B1u};
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  float o[W / 2];
#pragma unroll
  for (int x = 0; x < W / 2; ++x) o[x] = 0.0f;

  if (!STREAM) mbar_wait(bar0, 0);
  const uint32_t q_tile = base + wg * TB;
  int i = 0;
  for (int t = 0; t < ntiles; ++t) {
    float sc[32];
    if (STREAM) {  // S over d, a 256-wide chunk an item
      for (int j = 0; j < chunks; ++j, ++i) {
        const int s = i % STAGES;
        mbar_wait(full(s), (i / STAGES) & 1);
        const uint32_t st = stage(s);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 16; ++kk)
          wgmma_ss<0, 0>(sc, slab_desc<W>(st, kk), slab_desc<W>(st + TB, kk), j | kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        mbar_arrive(empty(s));
      }
    }
    const int s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    const uint32_t st = stage(s);
    if (active) {
      if (!STREAM) {
        fence_regs(o);
        wgmma_fence();
        const uint32_t qa = opaque(q_tile);
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk)
          wgmma_ss<0, 0>(sc, slab_desc<W>(qa, kk), slab_desc<W>(st, kk), kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
      }
      float alpha[2];
      softmax_tile<DROPOUT>(sc, m_run, l_run, alpha, t * TILE, n, c, scale_log2, rmix, seed_mix,
                            threshold, keep_scale);
#pragma unroll
      for (int x = 0; x < W / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
      uint32_t pa[4][4];
      acc_to_afrag(pa, sc);
      fence_regs(o);
      wgmma_fence();
      const uint32_t va = STREAM ? st : st + TB;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // O += bf16(w) V, a wgmma a 64-column box
        static_for<NB>([&](auto pc) {
          constexpr int p = decltype(pc)::value;
          wgmma_rs<1>(panel_acc<W, p>(o), pa[kk], panel_desc<W>(va, p, kk));
        });
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    mbar_arrive(empty(s));
    ++i;
  }

  if (!active) return;
  const float inv[2] = {1.0f / l_run[0], 1.0f / l_run[1]};
  store_rows<W>(out, o, row0, col0, c, b, n, H, h, D, inv);
  if (lse != nullptr && c == 0 && blockIdx.z == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < static_cast<uint32_t>(n))
        lse[(long long)bh * n + row0 + 8 * r] = (m_run[r] + log2f(l_run[r])) * LN2;
}

// A (b, n, h, D) bf16 tensor with element strides (sb, sn, sh) as a rank-4
// (d, n, h, b) map of 64 x 64 boxes, 128-byte swizzled; columns past D and
// rows past n read 0.
bool wide_map(CUtensorMap* map, const void* base, int B, int n, int H, int D, long long sb,
              long long sn, long long sh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, TILE, 1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int W, bool DROPOUT, bool STREAM, int WG>
int launch_forward_wide_bf16(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                             const int* seeds, bf16* out, float* lse, int B, int n, int H, int D,
                             int d, unsigned int threshold, float keep_scale, cudaStream_t s) {
  using C = WideFwd<W, STREAM, WG>;
  static unsigned long long smem_set;
  const cudaError_t err =
      ensure_smem(attn_fwd_wide_bf16_kernel<W, DROPOUT, STREAM, WG>, C::SMEM, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + WG * TILE - 1) / (WG * TILE), B * H,
                  STREAM ? (D + WB_PANEL - 1) / WB_PANEL : 1);
  attn_fwd_wide_bf16_kernel<W, DROPOUT, STREAM, WG><<<grid, C::THREADS, C::SMEM, s>>>(
      tq, tk, tv, seeds, out, lse, n, H, D, LOG2E / sqrtf(static_cast<float>(d)), threshold,
      keep_scale);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 forward at head dim d >= WIDE_MIN_D: the arguments of
// attention_forward (attention_fwd.cuh), the tensors at D = pad_head_dim(d).
template <bool DROPOUT>
int attention_forward_wide_bf16(const void* q, const void* k, const void* v, long long sb,
                                long long sn, long long sh, const int* seeds, bf16* out,
                                float* lse, int B, int n, int H, int d, unsigned int threshold,
                                float keep_scale, cudaStream_t s) {
  const int D = pad_head_dim(d);
  CUtensorMap tq, tk, tv;
  if (!current_context() || !wide_map(&tq, q, B, n, H, D, sb, sn, sh) ||
      !wide_map(&tk, k, B, n, H, D, sb, sn, sh) || !wide_map(&tv, v, B, n, H, D, sb, sn, sh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > 256)
    return launch_forward_wide_bf16<256, DROPOUT, true, 1>(tq, tk, tv, seeds, out, lse, B, n, H,
                                                            D, d, threshold, keep_scale, s);
  if (wide_width(D) == 256)
    return launch_forward_wide_bf16<256, DROPOUT, false, wide_fwd_warpgroups(256, DROPOUT)>(
        tq, tk, tv, seeds, out, lse, B, n, H, D, d, threshold, keep_scale, s);
  return launch_forward_wide_bf16<192, DROPOUT, false, wide_fwd_warpgroups(192, DROPOUT)>(
      tq, tk, tv, seeds, out, lse, B, n, H, D, d, threshold, keep_scale, s);
}

// ----------------------------------------------------------- backward ----

template <int W, bool STREAM>
struct WideBwd {
  static_assert(W == 192 || W == 256, "width");
  static_assert(!STREAM || W == 256, "the streamed form is 256 wide");
  static constexpr int TB = TILE * W * 2;  // a 64-row tile
  static constexpr int THREADS = 3 * CONSUMERS;  // two consumer warpgroups, a producer one
  static constexpr int XF_BYTES = CONSUMERS * 32 * 4;  // a buffer of the weights: 16 KB
  // Shared memory: own tiles (S's operand, then dP's; none when STREAM) |
  // ring of STAGES x (X0 | X1), each TB | two weight buffers | STAGES x the
  // other tile's 64 row stats | barriers.
  static constexpr int RING = STREAM ? 0 : 2 * TB;
  static constexpr int XF = RING + STAGES * 2 * TB;
  static constexpr int STATS = XF + 2 * XF_BYTES;
  static constexpr int BARS = STATS + STAGES * TILE * 8;
  static constexpr int SMEM = BARS + 64 + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};

// One block per (64-row tile of its own side, batch*head, output panel);
// DQ false: own rows keys, da = dk, db = dv; DQ true: own rows queries, da
// = dq. tq, tk, tv, tg: D-wide maps of 64 x 64 boxes (wide_map; tg over the
// contiguous incoming gradient). stats: (B*H, n_pad) (lse log2 e, delta).
// Ring items (X0 | X1): without STREAM one per other-side tile, (its
// operand of S | its operand of dP) W wide, and its stats where DQ is
// false; with STREAM, per other-side tile ceil(D / 128) chunk items ((own,
// other) operands of S | (own, other) operands of dP), 128 columns each,
// then the other side's panels at col0 (S's operand | dP's, which the dQ
// kernel does not need) and stats.
template <int W, bool DQ, bool STREAM>
__global__ void __launch_bounds__(WideBwd<W, STREAM>::THREADS, 1)
attn_bwd_wide_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg, const float2* __restrict__ stats,
                          const int* __restrict__ seeds, bf16* __restrict__ da,
                          bf16* __restrict__ db, int n, int H, int D, int n_pad, float scale,
                          float scale_log2, uint32_t threshold, float keep_scale) {
  using C = WideBwd<W, STREAM>;
  constexpr int TB = C::TB, NB = W / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  // barriers: own_full | full[STAGES] | empty[STAGES], as 32-bit shared addresses
  const uint32_t base = smem_u32(smem), bar0 = base + C::BARS;
  auto full = [&](int s) { return bar0 + 8 * (1 + s); };
  auto empty = [&](int s) { return bar0 + 8 * (1 + STAGES + s); };
  auto stage = [&](int s) { return base + C::RING + s * 2 * TB; };

  const int own0 = blockIdx.x * TILE, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int col0 = blockIdx.z * WB_PANEL;
  const int ntiles = (n + TILE - 1) / TILE;
  const int chunks = STREAM ? (D + WB_CHUNK - 1) / WB_CHUNK : 0;  // score items an other tile
  const float2* st_bh = stats + (long long)bh * n_pad;

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BARS);
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + STAGES + s], 2 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * CONSUMERS) {  // producers: one thread issues every copy
    producer_regs();
    if (threadIdx.x == 2 * CONSUMERS) {
      // the own side's operands of S and dP, the other side's
      const CUtensorMap *own_s = DQ ? &tq : &tk, *own_p = DQ ? &tg : &tv;
      const CUtensorMap *oth_s = DQ ? &tk : &tq, *oth_p = DQ ? &tv : &tg;
      if (!STREAM) {
        mbar_expect_tx(bar0, 2 * TB);
        tma_boxes<NB>(base, own_s, bar0, 0, own0, h, b);
        tma_boxes<NB>(base + TB, own_p, bar0, 0, own0, h, b);
      }
      int i = 0;
      for (int t = 0; t < ntiles; ++t)
        for (int j = 0; j <= chunks; ++j, ++i) {
          const int s = i % STAGES;
          mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
          const uint32_t st = stage(s), fs = full(s);
          if (j < chunks) {  // STREAM: 128-column chunks of all four operands
            mbar_expect_tx(fs, 2 * TB);
            tma_boxes<2>(st, opaque(own_s), fs, j * WB_CHUNK, own0, h, b);
            tma_boxes<2>(st + TB / 2, opaque(oth_s), fs, j * WB_CHUNK, t * TILE, h, b);
            tma_boxes<2>(st + TB, opaque(own_p), fs, j * WB_CHUNK, own0, h, b);
            tma_boxes<2>(st + 3 * TB / 2, opaque(oth_p), fs, j * WB_CHUNK, t * TILE, h, b);
            continue;
          }
          const bool with_p = !(STREAM && DQ);  // the update item: dP's operand too
          mbar_expect_tx(fs, (with_p ? 2 * TB : TB) + (DQ ? 0 : TILE * 8));
          tma_boxes<NB>(st, opaque(oth_s), fs, col0, t * TILE, h, b);
          if (with_p) tma_boxes<NB>(st + TB, opaque(oth_p), fs, col0, t * TILE, h, b);
          if (!DQ)
            bulk_load(base + C::STATS + s * TILE * 8, st_bh + t * TILE, TILE * 8, fs);
        }
    }
    return;
  }

  consumer_regs();
  const int wg = threadIdx.x / CONSUMERS, tid = threadIdx.x % CONSUMERS;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int own_row = own0 + warp * 16 + g;  // this thread's rows: own_row, own_row + 8
  const uint32_t seed_mix = static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du;
  // the own rows' terms of the keep hash, and (dQ) their stats
  const uint32_t own_mix[2] = {
      static_cast<uint32_t>(own_row) * (DQ ? 0x9E3779B1u : 0x85EBCA77u) + seed_mix,
      static_cast<uint32_t>(own_row + 8) * (DQ ? 0x9E3779B1u : 0x85EBCA77u) + seed_mix};
  float2 own_st[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
  if (DQ) own_st[0] = st_bh[own_row], own_st[1] = st_bh[own_row + 8];
  const uint32_t oth_mul = DQ ? 0x85EBCA77u : 0x9E3779B1u;

  // warpgroup 0: dV (dK/dV kernel) or nothing (dQ kernel); warpgroup 1: dK or dQ
  float acc[W / 2];
#pragma unroll
  for (int x = 0; x < W / 2; ++x) acc[x] = 0.0f;

  if (!STREAM) mbar_wait(bar0, 0);
  int i = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int oth0 = t * TILE;
    // warpgroup 0: S (or S^T) = own_s oth_s^T; warpgroup 1: dP (or dP^T) = own_p oth_p^T
    float x[32];
    if (STREAM) {
      for (int j = 0; j < chunks; ++j, ++i) {
        const int s = i % STAGES;
        mbar_wait(full(s), (i / STAGES) & 1);
        const uint32_t a = stage(s) + wg * TB;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WB_CHUNK / 16; ++kk)
          wgmma_ss<0, 0>(x, slab_desc<W>(a, kk), slab_desc<W>(a + TB / 2, kk), j | kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(x);
        mbar_arrive(empty(s));
      }
    }
    const int s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    const uint32_t st = stage(s);
    if (!STREAM) {
      fence_regs(acc);
      wgmma_fence();
      const uint32_t a = opaque(base + wg * TB), bt = st + wg * TB;
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk)
        wgmma_ss<0, 0>(x, slab_desc<W>(a, kk), slab_desc<W>(bt, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(x);
    }
    const float2* sst = reinterpret_cast<const float2*>(smem + C::STATS + s * TILE * 8);
    float4* xf = reinterpret_cast<float4*>(smem + C::XF + (t & 1) * C::XF_BYTES);

    // the update's A operand: the dropped weights (warpgroup 0, dK/dV
    // kernel) or the score gradient (warpgroup 1), bf16 in the accumulator
    // layout (element e: own row own_row + 8 ((e >> 1) & 1), other-side
    // column oth0 + 8 (e >> 2) + 2c + (e & 1))
    uint32_t fa[4][4];
    if (wg == 0) {
      // the weights, 0 past n, to warpgroup 1; the dropped weights
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1, ci = 8 * (e >> 2) + 2 * c + (e & 1);
        const int own = own_row + 8 * r, oth = oth0 + ci;
        const float lse2 = DQ ? own_st[r].x : sst[ci].x;
        x[e] = own < n && oth < n ? exp2f(fmaf(x[e], scale_log2, -lse2)) : 0.0f;
      }
#pragma unroll
      for (int k4 = 0; k4 < 8; ++k4)
        xf[k4 * CONSUMERS + tid] = make_float4(x[4 * k4], x[4 * k4 + 1], x[4 * k4 + 2], x[4 * k4 + 3]);
      if (!DQ) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const uint32_t oth = oth0 + 8 * (e >> 2) + 2 * c + (e & 1);
          const bool keep = fmix(oth * oth_mul + own_mix[(e >> 1) & 1]) >= threshold;
          x[e] = keep ? x[e] * keep_scale : 0.0f;
        }
        acc_to_afrag(fa, x);
      }
      warpgroups_sync();
    } else {
      warpgroups_sync();
      // dS = P (keep dP / (1 - p) - delta) scale
#pragma unroll
      for (int k4 = 0; k4 < 8; ++k4) {
        const float4 p4 = xf[k4 * CONSUMERS + tid];
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int e = 4 * k4 + m, r = (e >> 1) & 1, ci = 8 * (e >> 2) + 2 * c + (e & 1);
          const uint32_t oth = oth0 + ci;
          const float delta = DQ ? own_st[r].y : sst[ci].y;
          const bool keep = fmix(oth * oth_mul + own_mix[r]) >= threshold;
          const float dw = keep ? x[e] * keep_scale : 0.0f;
          x[e] = p[m] * (dw - delta) * scale;
        }
      }
      acc_to_afrag(fa, x);
    }

    if (!DQ || wg == 1) {
      // dV += bf16(dropped^T) G (warpgroup 0), dK += bf16(dS^T) Q or dQ +=
      // bf16(dS) K (warpgroup 1): a wgmma per 64-column box of the other
      // side's tile
      const uint32_t bt = opaque(!DQ && wg == 0 ? st + TB : st);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        static_for<NB>([&](auto pc) {
          constexpr int p = decltype(pc)::value;
          wgmma_rs<1>(panel_acc<W, p>(acc), fa[kk], panel_desc<W>(bt, p, kk));
        });
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(empty(s));
    ++i;
  }

  if (DQ && wg == 0) return;
  const float one[2] = {1.0f, 1.0f};
  store_rows<W>(!DQ && wg == 0 ? db : da, acc, own_row, col0, c, b, n, H, h, D, one);
}

template <int W, bool DQ, bool STREAM>
cudaError_t launch_backward_wide_bf16(const CUtensorMap* maps, const float2* stats,
                                      const int* seeds, bf16* da, bf16* db, int B, int n, int H,
                                      int D, int n_pad, float scale, unsigned int threshold,
                                      float keep_scale, cudaStream_t s) {
  using C = WideBwd<W, STREAM>;
  static unsigned long long smem_set;
  const cudaError_t err = ensure_smem(attn_bwd_wide_bf16_kernel<W, DQ, STREAM>, C::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TILE - 1) / TILE, B * H, STREAM ? (D + WB_PANEL - 1) / WB_PANEL : 1);
  attn_bwd_wide_bf16_kernel<W, DQ, STREAM><<<grid, C::THREADS, C::SMEM, s>>>(
      maps[0], maps[1], maps[2], maps[3], stats, seeds, da, db, n, H, D, n_pad, scale,
      scale * LOG2E, threshold, keep_scale);
  return cudaGetLastError();
}

}  // namespace
