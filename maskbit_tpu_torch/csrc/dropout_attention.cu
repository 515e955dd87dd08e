// Training attention with in-kernel attention-probability dropout, forward and
// backward, on Hopper (sm_90a):
//     out = (keep(row, col, seed) * softmax(q k^T / sqrt(d)) / (1 - p)) v
//
// Replaces the TPU kernels of maskbit_tpu/nn/pallas_attention.py, at every
// head dim d in [1, 128] (the TPU kernels read d from their inputs; each
// kernel here is a template on d, instantiated at the eight multiples of 16,
// and another d runs the instantiation at d rounded up to 16 on inputs the
// wrapper zero-pads per head, with d's softmax scale; a d past 128 runs the
// TMA + wgmma kernels of attention_wide_bf16.cuh, described there, whose
// backward is launched below: S^T and dP^T computed twice per tile pair up
// to d = 256, in a dK/dV kernel and a dQ kernel):
//   * _dropattn_fwd_kernel (dropout_attention -> _dropout_attention_fwd), by
//     attn_fwd_kernel<d, true> (attention_fwd.cuh);
//   * _attention_kernel (fused_attention), by attn_fwd_kernel<d, false>: the
//     same forward with the mask compiled out;
//   * _dropattn_bwd_kernel (_dropout_attention_bwd), by attn_bwd_prep_kernel<d>,
//     attn_bwd_kernel<d> and attn_bwd_dq_kernel.
// The forward template lives in attention_fwd.cuh, which the serving
// attention block (attention_block.cu) includes too, with the column-panel
// layout that lets one design take every d; the PTX wrappers and the
// tensor-map encoder in sm90.cuh.
//
// The keep mask is the TPU kernel's, bit for bit: a pure function of the
// unpadded query index (row), key index (col) and the (batch, head) slot's
// 32-bit seed, keep iff murmur3_fmix(row * 0x9E3779B1 + col * 0x85EBCA77 +
// seed * 0xC2B2AE3D) >= threshold, all uint32 arithmetic that wraps. The
// threshold min(floor(p * 2^32), 2^32 - 1) is computed by the caller on the
// host. The backward regenerates the same mask, so it never exists in memory.
//
// What bounds it on the H100. At the flagship training shape, q, k, v of
// (32, 257, 16, 64) bf16 (16.8 MB each), the forward moves 67 MB (20 us at
// 3.35 TB/s) for 8.7 GFLOP of products (9 us at 989 TFLOP/s); the backward
// moves 135 MB (40 us) for 21.6 GFLOP (22 us). The other widths, at the
// batch of 32 and n = 257 that the checks time them at: d = 128 over 8
// heads, the same 67 and 135 MB for the same GFLOP (20 and 40 us); d = 112
// over 8 heads, 59 and 118 MB (18 and 35 us); d = 16 to 96 over 4 heads, 4.3
// to 25 MB forward and 8.6 to 51 MB backward (1.3 to 7.6 us and 2.6 to 15
// us), calls that the launch and one or two waves of blocks bound more
// than either rate. Every width stays far from these bounds for a reason
// the bounds do not count: per (query, key) pair the kernels also do about
// 20 f32 and integer operations on the CUDA cores (exp2, the murmur3 hash,
// the dropout select, the score gradient), which at n = 257 take as long as
// the bytes, whatever d is; and 64-row tiles pad 257 to 320. The products
// grow with d and the element-wise work does not, so the wide heads are the
// nearest their bound. So the design keeps the tensor cores and the copies
// off the critical path of those operations:
//   * Operands arrive by TMA (cp.async.bulk.tensor, swizzled column panels:
//     attention_fwd.cuh) into a ring of shared-memory stages guarded by
//     mbarriers. A producer warp keeps the loads in flight; one consumer
//     warpgroup (128 threads) runs the products as wgmma m64nNk16 (bf16 in,
//     f32 accumulate; N = 64 over keys or queries, N = a panel's width over
//     d). The score tile stays in registers and is the next product's A
//     operand. Several blocks share an SM, so one block's softmax overlaps
//     another's products and loads.
//   * q, k, v are read through rank-4 tensor maps (one per panel width) over
//     the QKV projection's (b, n, 3, h, d) view (dims d, n, h, b with the
//     caller's strides); rows past n arrive as zeros, and the kernels mask
//     scores and weights of rows and columns past n.
//   * Forward: one block per (batch*head, 64-query tile), 160 threads,
//     (5 * 128 * d + 1088) bytes of shared memory (42 KB at d = 64, 80 KB at
//     128); three blocks an SM up to d = 64, two past it; K and V tiles of
//     64 keys stream through 2 stages. Online softmax in f32 with exp2f and
//     log2(e) folded into the scale; the row sum runs over ALL keys before
//     dropout; the mask and 1/(1-p) multiply the unnormalised weights, which
//     are rounded to bf16 for the value product (the TPU kernel rounds the
//     normalised ones: a relative difference of one bf16 rounding, 2^-9);
//     the row log-sum-exp is saved, (batch*head, n) f32, for the backward.
//     ptxas: 82 (d = 16, no mask) to 160 (d = 128, the mask) registers a
//     thread, no spills.
//   * Backward, three launches. attn_bwd_prep_kernel<d>: per query row
//     delta = rowsum(g * out) (the identity rowsum(dw * P) = g . O holds with
//     dropout; O is the forward's bf16 output, one bf16 rounding against the
//     TPU kernel's f32 row sum) and lse * log2(e), into a padded f32 pair per
//     row; it also zeroes the dq tickets. attn_bwd_kernel<d>: one block per
//     (batch*head, 64-key tile), 256 threads, K and V resident, looping over
//     the query tiles (Q, the incoming gradient and the row pairs through a
//     ring of stages). Each product once, 10 * b*h*n^2*d operations as the
//     TPU kernel:
//       S^T = K Q^T, dP^T = V G^T (A and B from shared memory, d in slabs),
//       P^T = exp2(S^T * scale * log2e - lse * log2e),
//       dV += bf16(keep * P^T / (1-p)) G   (A from registers, a wgmma a panel),
//       dS^T = P^T (keep * dP^T / (1-p) - delta) * scale,
//       dK += bf16(dS^T) Q                 (A from registers, a wgmma a panel),
//       dQ_part = bf16(dS) K               (dS^T through shared memory, read
//                                           transposed; a panel at a time).
//     The consumers hold dK and dV (d f32 a thread each), S^T and dP^T (32
//     each), the packed bf16 fragments (16) and one panel's dQ part (at
//     most 32): that is 192 f32 at d = 128 before any address or index, so
//     the plan is chosen by d (BwdCfg) to keep every instantiation free of
//     spills and of serialised wgmma, which ptxas reports and phase 2 of
//     chip_smoke.py prints:
//       d = 16, 32: three blocks an SM (consumers 128 registers, producers
//         32), each query tile in two halves of 32 queries (S^T and dP^T
//         then 16 f32 each);
//       d = 48, 64, 80: two blocks an SM (224 and 32, or 216 and 40 where a
//         tile has two panels and the loader keeps more boxes in flight),
//         whole 64-query tiles, two stages of Q and G, two dQ-part buffers:
//         at d = 64 the layout, products and results, bit for bit, of the
//         earlier kernel written for that width alone;
//       d = 96: two blocks, query halves, one dQ-part buffer;
//       d = 112, 128: two blocks, query halves, one stage and one buffer
//         (the whole ring, 137 to 170 KB, would leave one block an SM:
//         10-15% slower though its consumers then have 255 registers).
//     The descriptors of the resident K and V tiles are made anew each
//     tile (opaque in sm90.cuh) rather than held in 48 registers across
//     the loop, and the producers address shared memory in 32 bits. A flat
//     168 registers at d = 64 spilled 116 bytes, serialised the wgmmas and
//     ran 12-18% slower; at d = 128 whole tiles in 224 registers
//     serialised them too.
//     dQ sums the parts of every key tile of the head, deterministically: the
//     consumers write each f32 part to shared memory (128-byte swizzled boxes
//     of 32 columns and, where d is an odd multiple of 16, a 64-byte swizzled
//     box of 16, so without bank conflicts), and the dQ warp adds it to an f32
//     sum in device memory with TMA tensor reduces, one a box
//     (cp.reduce.async.bulk.tensor .add; the first part is a tensor store),
//     in a fixed order kept by a ticket per (batch*head, query tile): a part
//     is added only after the one before it in the order has landed.
//     attn_bwd_dq_kernel then writes the sum as bf16 dq. Key tile kt visits
//     query tiles kt, kt+1, ... (mod the tile count), and tile qt is summed
//     in the order kt = qt, qt-1, ..., so the blocks of one head seldom wait
//     on each other; a block may then wait for one launched after it, which
//     needs all blocks of a head on the card at once, so beyond 64 tiles the
//     wrapper takes the order kt = 0, 1, ..., where a block waits only for
//     blocks launched before it.
//     The TPU kernel's rounding points are kept: the dropped weights are
//     rounded to bf16 before dv, the score gradient before dq and dk.
//
// Layouts: q, k, v are (b, n, h, d) bf16 read through strides (batch, row,
// head; the last dimension contiguous, every stride a multiple of 16 bytes).
// out, the incoming gradient, dq, dk and dv are contiguous (b, n, h, d)
// bf16. The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include "attention_fwd.cuh"

namespace {

// ------------------------------------------------------------ backward ----

// Per (b, row, h), row over the padded length n_pad: stats[bh, row] =
// (lse * log2e, rowsum(g * out)) in f32, (0, 0) past n; one warp per row,
// at head dim D. The grid's first `num_tickets` threads also zero the dq
// tickets.
template <int D>
__global__ void __launch_bounds__(128)
attn_bwd_prep_kernel(const bf16* __restrict__ out, const bf16* __restrict__ grad,
                     const float* __restrict__ lse, float2* __restrict__ stats,
                     int* __restrict__ tickets, int n, int n_pad, int H, long long rows,
                     int num_tickets) {
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gt < num_tickets) tickets[gt] = 0;
  const long long r = gt >> 5;
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
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 64) {  // 64 elements a pass, two a lane
    const int d = d0 + 2 * lane;
    if (D % 64 == 0 || d < D) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + e + d));
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(grad + e + d));
      s += a.x * x.x + a.y * x.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) stats[bh * n_pad + row] = make_float2(lse[bh * n + row] * LOG2E, s);
}

// The f32 box at (d0, row, batch*head) of one of the dq sum's tensor maps =
// or += the swizzled box at src (shared memory), by the TMA unit, in the
// calling thread's bulk group. Rows past n are not written.
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map, const void* src, int d0,
                                              int row, int bh, bool add) {
  if (add)
    asm volatile(
        "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group [%0, {%2, %3, %4}], "
        "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(d0), "r"(row), "r"(bh)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(d0), "r"(row), "r"(bh)
        : "memory");
}

// The backward's plan by head dim (see the header): blocks an SM, the
// setmaxnreg split, query halves, and the shared-memory ring (Q and G
// stages, dQ-part buffers). Each choice is the fastest that was compared on
// the card (cli/compare_backward.py, copies of this file with other values)
// whose ptxas report has no spill and no serialised wgmma:
//   THREE_BLOCKS_MAX_D: up to this d, three blocks an SM (80 registers a
//     thread at launch: consumers 128, producers 32) and query halves;
//     17% faster at d = 16 and 6% at 32 than two blocks; d = 48 spilled.
//   PRODUCER_REGS_PANELS: the producers' registers where a tile has
//     several panels (more TMA boxes in flight); 32 spilled 20 bytes.
//   HALVES_MIN_D: from this d on, query halves; without them the consumers
//     spilled at d = 96 and serialised their wgmmas at 128.
constexpr int THREE_BLOCKS_MAX_D = 32, PRODUCER_REGS_PANELS = 40, HALVES_MIN_D = 96;

template <int D>
struct BwdCfg {
  static constexpr int TB = Panels<D>::TILE_BYTES;
  static constexpr bool THREE = D <= THREE_BLOCKS_MAX_D;
  // the ring shrinks past d = 80 so that two blocks still share an SM
  // (which measured 10-15% faster at d = 112 and 128 than one block with
  // the whole ring): d = 96 keeps one dQ-part buffer, d = 112 and 128 also
  // one stage of Q and G
  static constexpr int QG_STAGES = THREE || D <= 96 ? 2 : 1;
  static constexpr int DQ_BUFS = THREE || D <= 80 ? 2 : 1;
  // Query tiles taken in halves of 32 queries: S^T and dP^T then hold 32
  // f32 a thread, not 64, beside dK and dV's d.
  static constexpr int HALVES = THREE || D >= HALVES_MIN_D ? 2 : 1;
  // One f32 dQ part: boxes of (64 rows x 32 d), 128 bytes a row, 128-byte
  // swizzled as TMA reads them, then where D / 16 is odd one box of (64 x
  // 16), 64-byte swizzled. A warp's stores of its accumulator fragment then
  // take two wavefronts; row-major rows D * 4 bytes apart would put its 8
  // rows on the same banks and take eight.
  static constexpr int DQ_WIDE = D / 32;  // 32-column boxes
  static constexpr int DQ_BOX = TILE * 32 * 4;
  static constexpr int DQ_BYTES = TILE * D * 4;
  // Shared memory: K | V | dS^T | Q[] | G[] | dQ part[] | stats[] | barriers.
  static constexpr int DS = 2 * TB;
  static constexpr int Q = DS + TILE * TILE * 2;
  static constexpr int G = Q + QG_STAGES * TB;
  static constexpr int DQ = G + QG_STAGES * TB;
  static constexpr int STATS = DQ + DQ_BUFS * DQ_BYTES;
  static constexpr int BARS = STATS + QG_STAGES * TILE * 8;
  static constexpr int SMEM = BARS + 128 + 1024;
  // blocks an SM: 228 KB of shared memory there, 1 KB of it reserved for
  // each block
  static constexpr int BLOCKS = THREE ? 3 : 2 * (SMEM + 1024) <= 228 * 1024 ? 2 : 1;
  static_assert(BLOCKS * (SMEM + 1024) <= 228 * 1024, "shared memory");
  // With several blocks an SM, setmaxnreg moves registers from the producer
  // warpgroup (which needs a few more where a tile has several panels) to
  // the consumers: P + C is twice the launch's count, 65536 / (256 *
  // BLOCKS) rounded down to a multiple of 8. One block runs at ptxas's 255.
  static constexpr int LAUNCH_REGS = (65536 / (256 * BLOCKS)) & ~7;
  static constexpr int PRODUCER_REGS = Panels<D>::COUNT > 1 ? PRODUCER_REGS_PANELS : 32;
  static constexpr int CONSUMER_REGS = 2 * LAUNCH_REGS - PRODUCER_REGS;
};

// Byte offset of dQ part element (row, col0 + 2c) in that layout; col0 is a
// multiple of 8 (a constant once the callers' loops are unrolled).
template <int D>
__device__ __forceinline__ int dq_part_offset(int row, int col0, int c) {
  using C = BwdCfg<D>;
  const int col = col0 + 2 * c;
  if (col0 < 32 * C::DQ_WIDE)
    return (col0 >> 5) * C::DQ_BOX + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
           (col & 3) * 4;
  return C::DQ_WIDE * C::DQ_BOX + row * 64 + ((((col & 15) >> 2) ^ ((row >> 1) & 3)) << 4) +
         (col & 3) * 4;
}

// Consumers and a producer warpgroup: a loader warp, a dQ warp, two idle.
constexpr int BWD_THREADS = CONSUMERS + 128;

// tdq: the dq sum's maps, [0] of 32-column boxes, [1] of 16-column ones.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, BwdCfg<D>::BLOCKS)
attn_bwd_kernel(const __grid_constant__ TileMaps tq, const __grid_constant__ TileMaps tk,
                const __grid_constant__ TileMaps tv, const __grid_constant__ TileMaps tg,
                const __grid_constant__ TileMaps tdq, const float2* __restrict__ stats,
                const int* __restrict__ seeds, int* __restrict__ tickets, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int n, int H, int n_pad, int rotate, float scale,
                float scale_log2, uint32_t threshold, float keep_scale) {
  using P = Panels<D>;
  using C = BwdCfg<D>;
  constexpr int TB = C::TB, STG = C::QG_STAGES, NB = C::DQ_BUFS;
  constexpr int NQ = TILE / C::HALVES;  // queries a step: the score products' N
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* dss = smem + C::DS;  // dS^T, [key][query] bf16, 128-byte swizzle
  auto dqs = [&](int s) { return smem + C::DQ + s * C::DQ_BYTES; };
  auto st = [&](int s) { return reinterpret_cast<const float2*>(smem + C::STATS + s * TILE * 8); };
  // barriers: kv_full | full[STG] | empty[STG] | dq_full[NB] | dq_empty[NB],
  // as 32-bit shared addresses
  const uint32_t base = smem_u32(smem), bar0 = base + C::BARS;
  auto full = [&](int s) { return bar0 + 8 * (1 + s); };
  auto empty = [&](int s) { return bar0 + 8 * (1 + STG + s); };
  auto dq_full = [&](int s) { return bar0 + 8 * (1 + 2 * STG + s); };
  auto dq_empty = [&](int s) { return bar0 + 8 * (1 + 2 * STG + NB + s); };

  const int kt = blockIdx.x;
  const int ntiles = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = kt * TILE;

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BARS);
    mbar_init(bars, 1);
    for (int s = 0; s < STG; ++s) {
      mbar_init(&bars[1 + s], 1);
      mbar_init(&bars[1 + STG + s], CONSUMERS);
    }
    for (int s = 0; s < NB; ++s) {
      mbar_init(&bars[1 + 2 * STG + s], CONSUMERS);
      mbar_init(&bars[1 + 2 * STG + NB + s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    if constexpr (C::BLOCKS > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS) : "memory");
    if (threadIdx.x == CONSUMERS) {  // loader: K and V once, then Q, G and the row stats
      mbar_expect_tx(bar0, 2 * TB);
      tma_load_tile<D>(base, tk, bar0, k0, h, b);
      tma_load_tile<D>(base + TB, tv, bar0, k0, h, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STG;
        const int q0 = (rotate ? (kt + i) % ntiles : i) * TILE;
        mbar_wait(empty(s), ((i / STG) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * TB + TILE * 8);
        tma_load_tile<D>(base + C::Q + s * TB, *opaque(&tq), full(s), q0, h, b);
        tma_load_tile<D>(base + C::G + s * TB, *opaque(&tg), full(s), q0, h, b);
        bulk_load(base + C::STATS + s * TILE * 8, stats + (long long)bh * n_pad + q0, TILE * 8,
                  full(s));
      }
    }
    if (threadIdx.x == CONSUMERS + 32) {
      // dQ warp: adds each dQ part to the f32 sum in device memory, in the
      // tile's fixed order (the first part is stored), one key tile at a time
      for (int i = 0; i < ntiles; ++i) {
        const int qt = rotate ? (kt + i) % ntiles : i;
        const int order = rotate ? i : kt;
        int* ticket = tickets + (long long)bh * ntiles + qt;
        mbar_wait(dq_full(i % NB), (i / NB) & 1);
        if (order > 0)
          while (ld_acquire(ticket) != order) {
          }
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        const TileMaps* maps = opaque(&tdq);
        const uint8_t* part = dqs(i % NB);
#pragma unroll
        for (int j = 0; j < C::DQ_WIDE; ++j)
          tma_store_box(&maps->box[0], part + j * C::DQ_BOX, 32 * j, qt * TILE, bh, order > 0);
        if constexpr (D % 32 != 0)
          tma_store_box(&maps->box[1], part + C::DQ_WIDE * C::DQ_BOX, D - 16, qt * TILE, bh,
                        order > 0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        st_release(ticket, order + 1);
        mbar_arrive(dq_empty(i % NB));
      }
    }
    return;
  }
  if constexpr (C::BLOCKS > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS) : "memory");

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys (accumulator rows): key0, key0 + 8
  const uint32_t seed_mix = static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du;
  const uint32_t kmix[2] = {key0 * 0x85EBCA77u + seed_mix, (key0 + 8) * 0x85EBCA77u + seed_mix};
  const bool kvalid[2] = {key0 < n, key0 + 8 < n};

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  mbar_wait(bar0, 0);  // K and V

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STG;
    const int q0 = (rotate ? (kt + i) % ntiles : i) * TILE;
    mbar_wait(full(s), (i / STG) & 1);
    // the tiles' descriptors are made anew each tile (opaque), not held
    // across the loop: at d = 128 they would take 48 registers
    const uint32_t k_addr = opaque(base), v_addr = k_addr + TB;
    const uint32_t q_addr = opaque(base + C::Q + s * TB), g_addr = opaque(base + C::G + s * TB);
    const float2* stq = st(s);

    // per step of NQ queries (one, or two halves)
#pragma unroll
    for (int hq = 0; hq < C::HALVES; ++hq) {
      // S^T = K Q^T and dP^T = V G^T: keys as rows, NQ queries as columns
      float sc[NQ / 2], dp[NQ / 2];
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(sc, slab_desc<D>(k_addr, kk), slab_desc<D>(q_addr, kk, NQ * hq), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<0, 0>(dp, slab_desc<D>(v_addr, kk), slab_desc<D>(g_addr, kk, NQ * hq), kk);
      wgmma_commit();
      wgmma_wait_all();  // and the previous step's dV and dK
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(dk_acc);
      fence_regs(dv_acc);

      uint32_t pa[NQ / 16][4], dsa[NQ / 16][4];
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = NQ * hq + 8 * j + 2 * c + e;  // query within the tile
          const float2 lse_delta = stq[qi];
          const uint32_t query = q0 + qi;
          const bool qvalid = query < static_cast<uint32_t>(n);
          const uint32_t qmix = query * 0x9E3779B1u;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int idx = 4 * j + 2 * r + e;
            const float p = qvalid && kvalid[r] ? exp2f(fmaf(sc[idx], scale_log2, -lse_delta.x))
                                                : 0.0f;
            const bool keep = fmix(qmix + kmix[r]) >= threshold;
            const float dw = keep ? dp[idx] * keep_scale : 0.0f;
            sc[idx] = keep ? p * keep_scale : 0.0f;   // dropped weights, for dV
            dp[idx] = p * (dw - lse_delta.y) * scale;  // score gradient, for dK and dQ
          }
        }
        // packed to bf16 A fragments (acc_to_afrag's layout) as each 8-query
        // group is done, so that the f32 scores die as the fragments fill
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          pa[j >> 1][(j & 1) * 2 + r] = pack_bf16(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]);
          dsa[j >> 1][(j & 1) * 2 + r] = pack_bf16(dp[4 * j + 2 * r], dp[4 * j + 2 * r + 1]);
        }
      }

      // dS^T into shared memory, [key][query], the swizzle TMA would give, for dQ
      if (hq == 0) consumer_sync();  // every warp is done with the previous tile's dQ product
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = warp * 16 + g + 8 * r, chunk = NQ / 8 * hq + j;
          *reinterpret_cast<uint32_t*>(dss + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * c) =
              dsa[j >> 1][(j & 1) * 2 + r];
        }

      // dV += P^T G and dK += dS^T Q over this step's queries, a wgmma a panel
      wgmma_fence();
      static_for<P::COUNT>([&](auto pc) {
        constexpr int p = decltype(pc)::value;
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk)
          wgmma_rs<1>(panel_acc<D, p>(dv_acc), pa[kk],
                      panel_desc<D>(g_addr, p, NQ / 16 * hq + kk));
      });
      static_for<P::COUNT>([&](auto pc) {
        constexpr int p = decltype(pc)::value;
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk)
          wgmma_rs<1>(panel_acc<D, p>(dk_acc), dsa[kk],
                      panel_desc<D>(q_addr, p, NQ / 16 * hq + kk));
      });
      wgmma_commit();
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();

    // the dQ part a panel at a time, so that only one panel's part (at most
    // 32 f32) is held beside dK and dV
    const uint64_t ds_mn = smem_desc(opaque(base + C::DS), 128, true);
    uint8_t* part = dqs(i % NB);
    static_for<P::COUNT>([&](auto pc) {
      constexpr int p = decltype(pc)::value;
      constexpr int W = P::width(p);
      float dqp[W / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1, 1>(dqp, ds_mn + 128 * kk, panel_desc<D>(k_addr, p, kk), kk);
      wgmma_commit();
      wgmma_wait_all();  // at p = 0 also the last dV and dK
      fence_regs(dqp);
      if (p == 0) {
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        mbar_arrive(empty(s));  // Q, G and the stats of stage s are no longer read
        mbar_wait(dq_empty(i % NB), ((i / NB) & 1) ^ 1);  // the part's buffer is free
      }
      // this panel of the tile's dQ part, f32, for the dQ warp
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < W / 8; ++j)
          *reinterpret_cast<float2*>(
              part + dq_part_offset<D>(warp * 16 + g + 8 * r, P::col(p) + 8 * j, c)) =
              make_float2(dqp[4 * j + 2 * r], dqp[4 * j + 2 * r + 1]);
    });
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(dq_full(i % NB));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key < n) {
      const long long o = (((long long)b * n + key) * H + h) * D + 2 * c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * j) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * j) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dq[b, row, h, :] = bf16(dq_acc[b*H + h, row, :]) at head dim D; 8 values
// a thread.
__global__ void __launch_bounds__(256)
attn_bwd_dq_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq, int n, int H, int D,
                   long long chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const long long e = i * 8;  // element of dq, (b, n, h, D) order
  const int d = static_cast<int>(e % D);
  const long long rh = e / D;  // (b * n + row) * H + h
  const int h = static_cast<int>(rh % H);
  const long long bn = rh / H;
  const long long b = bn / n, row = bn % n;
  const float* src = dq_acc + ((b * H + h) * n + row) * D + d;
  const float4 x = __ldcs(reinterpret_cast<const float4*>(src));
  const float4 y = __ldcs(reinterpret_cast<const float4*>(src + 4));
  uint4 out;
  out.x = pack_bf16(x.x, x.y);
  out.y = pack_bf16(x.z, x.w);
  out.z = pack_bf16(y.x, y.y);
  out.w = pack_bf16(y.z, y.w);
  *reinterpret_cast<uint4*>(dq + e) = out;
}

// The backward's f32 dq sum, (BH, n, D) contiguous, as rank-3 (d, n, BH)
// maps: [0] of (32 x 64) boxes, 128-byte swizzled, and where D / 16 is odd
// [1] of (16 x 64) boxes, 64-byte swizzled; rows past n are not written.
template <int D>
bool dq_sum_maps(TileMaps* maps, void* base, int BH, int n) {
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {D * 4, static_cast<cuuint64_t>(n) * D * 4};
  const cuuint32_t box32[3] = {32, TILE, 1}, box16[3] = {16, TILE, 1};
  memset(maps, 0, sizeof(*maps));
  return (D < 32 || encode_tiled(&maps->box[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims,
                                 strides, box32, CU_TENSOR_MAP_SWIZZLE_128B)) &&
         (D % 32 == 0 || encode_tiled(&maps->box[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base,
                                      dims, strides, box16, CU_TENSOR_MAP_SWIZZLE_64B));
}

// The three launches at head dim D = pad_head_dim(d); the arguments of
// mb_dropout_attention_bwd.
template <int D>
int attention_backward_at(const void* q, const void* k, const void* v, long long sb, long long sn,
                          long long sh, const void* out, const void* grad, const void* lse,
                          const void* seeds, void* dq, void* dk, void* dv, void* stats,
                          void* dq_acc, void* tickets, int B, int n, int H, int d, int rotate,
                          unsigned int threshold, float keep_scale, cudaStream_t s) {
  const int ntiles = (n + TILE - 1) / TILE;
  const int n_pad = ntiles * TILE;
  TileMaps tq, tk, tv, tg, tdq;
  const long long gn = static_cast<long long>(H) * D;
  if (!current_context() || !tile_maps<D>(&tq, q, B, n, H, sb, sn, sh) ||
      !tile_maps<D>(&tk, k, B, n, H, sb, sn, sh) || !tile_maps<D>(&tv, v, B, n, H, sb, sn, sh) ||
      !tile_maps<D>(&tg, grad, B, n, H, gn * n, gn, D) || !dq_sum_maps<D>(&tdq, dq_acc, B * H, n))
    return static_cast<int>(cudaErrorInvalidValue);

  const long long rows = static_cast<long long>(B) * n_pad * H;
  const int num_tickets = B * H * ntiles;
  attn_bwd_prep_kernel<D><<<static_cast<unsigned>((rows * 32 + 127) / 128), 128, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(grad),
      static_cast<const float*>(lse), static_cast<float2*>(stats), static_cast<int*>(tickets), n,
      n_pad, H, rows, num_tickets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  static unsigned long long smem_set;
  if ((err = ensure_smem(attn_bwd_kernel<D>, BwdCfg<D>::SMEM, smem_set)) != cudaSuccess)
    return static_cast<int>(err);
  attn_bwd_kernel<D><<<dim3(ntiles, B * H), BWD_THREADS, BwdCfg<D>::SMEM, s>>>(
      tq, tk, tv, tg, tdq, static_cast<const float2*>(stats), static_cast<const int*>(seeds),
      static_cast<int*>(tickets), static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, H, n_pad,
      rotate, scale, scale * LOG2E, threshold, keep_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const long long chunks = static_cast<long long>(B) * n * H * (D / 8);
  attn_bwd_dq_kernel<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), n, H, D, chunks);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 backward at head dim d >= WIDE_MIN_D: the row stats, then dK
// and dV, then dQ. The arguments of mb_dropout_attention_bwd (stats (B*H,
// n_pad) float2 scratch; no dq sum and no tickets), the tensors at D =
// pad_head_dim(d).
int attention_backward_wide_bf16(const void* q, const void* k, const void* v, long long sb,
                                 long long sn, long long sh, const bf16* out, const bf16* grad,
                                 const float* lse, const int* seeds, bf16* dq, bf16* dk, bf16* dv,
                                 float2* stats, int B, int n, int H, int d,
                                 unsigned int threshold, float keep_scale, cudaStream_t s) {
  const int D = pad_head_dim(d);
  const int n_pad = (n + TILE - 1) / TILE * TILE;
  const long long gsn = static_cast<long long>(H) * D;
  CUtensorMap maps[4];  // q, k, v, g
  if (!current_context() || !wide_map(&maps[0], q, B, n, H, D, sb, sn, sh) ||
      !wide_map(&maps[1], k, B, n, H, D, sb, sn, sh) ||
      !wide_map(&maps[2], v, B, n, H, D, sb, sn, sh) ||
      !wide_map(&maps[3], grad, B, n, H, D, gsn * n, gsn, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * n_pad * H;
  attn_bwd_wide_prep_kernel<bf16><<<static_cast<unsigned>((rows * 32 + 127) / 128), 128, 0, s>>>(
      out, grad, lse, stats, n, n_pad, H, D, rows);
  cudaError_t err = cudaGetLastError();
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  auto both = [&](auto w, auto stream) {
    constexpr int Wc = decltype(w)::value;
    constexpr bool S = decltype(stream)::value;
    if (err == cudaSuccess)
      err = launch_backward_wide_bf16<Wc, false, S>(maps, stats, seeds, dk, dv, B, n, H, D, n_pad,
                                                    scale, threshold, keep_scale, s);
    if (err == cudaSuccess)
      err = launch_backward_wide_bf16<Wc, true, S>(maps, stats, seeds, dq, nullptr, B, n, H, D,
                                                   n_pad, scale, threshold, keep_scale, s);
  };
  if (D > 256)
    both(std::integral_constant<int, 256>{}, std::true_type{});
  else if (wide_width(D) == 256)
    both(std::integral_constant<int, 256>{}, std::false_type{});
  else
    both(std::integral_constant<int, 192>{}, std::false_type{});
  return static_cast<int>(err);
}

}  // namespace

// Forward on `stream` (attention_fwd.cuh's attention_forward) at head dim
// d >= 1. q, k, v: (B, n, H, D) bf16 with D = d rounded up to a multiple of
// 16, zero past d (the wrapper pads a d that is not one), element strides
// (sb, sn, sh); out: contiguous (B, n, H, D) bf16; lse: (B*H, n) f32 or
// null; seeds: (B*H,) int32 (the uint32 seeds' bits), ignored when dropout
// == 0, which compiles the mask out. Returns the launch error (cudaSuccess
// == 0), or cudaErrorInvalidValue if d < 1 or a tensor map is refused.
extern "C" int mb_dropout_attention_fwd(const void* q, const void* k, const void* v,
                                        long long sb, long long sn, long long sh,
                                        const void* seeds, void* out, void* lse, int B, int n,
                                        int H, int d, unsigned int threshold, float keep_scale,
                                        int dropout, void* stream) {
  return attention_forward<true>(q, k, v, sb, sn, sh, seeds, out, lse, B, n, H, d, threshold,
                                 keep_scale, dropout != 0, static_cast<cudaStream_t>(stream));
}

// The kernels' plan at head dim d, for the build's report: plan[0..5] =
// the forward's dynamic shared memory and least blocks an SM (its launch
// bounds), the backward's shared memory, blocks an SM (1 to 3), Q and G
// stages and dQ-part buffers. Returns cudaErrorInvalidValue for another d.
extern "C" int mb_dropout_attention_plan(int d, int* plan) {
  switch (d) {
#define MB_PLAN_CASE(W)                                                                      \
  case W:                                                                                   \
    plan[0] = FwdCfg<W>::SMEM;                                                              \
    plan[1] = FwdCfg<W>::MIN_BLOCKS;                                                        \
    plan[2] = BwdCfg<W>::SMEM;                                                              \
    plan[3] = BwdCfg<W>::BLOCKS;                                                            \
    plan[4] = BwdCfg<W>::QG_STAGES;                                                         \
    plan[5] = BwdCfg<W>::DQ_BUFS;                                                           \
    return 0;
    MB_HEAD_DIMS(MB_PLAN_CASE)
#undef MB_PLAN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Backward on `stream` at head dim d >= 1: dq, dk, dv (contiguous (B, n, H,
// D) bf16, D as in the forward) from q, k, v (strided as in the forward),
// the forward's out and lse, the incoming gradient grad (contiguous bf16;
// out and grad zero past d too) and the seeds. Scratch: stats, (B*H, n_pad)
// float2 with n_pad = 64 * ceil(n / 64); up to d = 128, dq_acc, (B*H, n, D)
// f32, and tickets, (B*H, n_pad / 64) int32 (past 128 neither is read and
// either may be null). rotate: 1 for the rotated dq order, 0 for key-tile
// order (see the header). Three launches: the row stats, the main kernel,
// and dq_acc to bf16 dq; past d = 128 the row stats, dK and dV, and dQ
// (attention_wide_bf16.cuh). Returns the first launch error (cudaSuccess == 0),
// or cudaErrorInvalidValue if d < 1 or a tensor map is refused.
extern "C" int mb_dropout_attention_bwd(const void* q, const void* k, const void* v,
                                        long long sb, long long sn, long long sh,
                                        const void* out, const void* grad, const void* lse,
                                        const void* seeds, void* dq, void* dk, void* dv,
                                        void* stats, void* dq_acc, void* tickets, int B, int n,
                                        int H, int d, int rotate, unsigned int threshold,
                                        float keep_scale, void* stream) {
  if (d >= WIDE_MIN_D)
    return attention_backward_wide_bf16(
        q, k, v, sb, sn, sh, static_cast<const bf16*>(out), static_cast<const bf16*>(grad),
        static_cast<const float*>(lse), static_cast<const int*>(seeds), static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float2*>(stats), B, n, H, d,
        threshold, keep_scale, static_cast<cudaStream_t>(stream));
  switch (d < 1 ? 0 : pad_head_dim(d)) {
#define MB_BWD_CASE(W)                                                                         \
  case W:                                                                                     \
    return attention_backward_at<W>(q, k, v, sb, sn, sh, out, grad, lse, seeds, dq, dk, dv,   \
                                    stats, dq_acc, tickets, B, n, H, d, rotate, threshold,    \
                                    keep_scale, static_cast<cudaStream_t>(stream));
    MB_HEAD_DIMS(MB_BWD_CASE)
#undef MB_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
