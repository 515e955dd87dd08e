// Training attention with in-kernel attention-probability dropout, forward and
// backward, on Hopper (sm_90a):
//     out = (keep(row, col, seed) * softmax(q k^T / sqrt(d)) / (1 - p)) v
//
// Replaces the TPU kernels of maskbit_tpu/nn/pallas_attention.py:
//   * _dropattn_fwd_kernel (dropout_attention -> _dropout_attention_fwd), by
//     attn_fwd_kernel<true>;
//   * _attention_kernel (fused_attention), by attn_fwd_kernel<false>: the same
//     forward with the mask compiled out;
//   * _dropattn_bwd_kernel (_dropout_attention_bwd), by attn_bwd_prep_kernel,
//     attn_bwd_kernel and attn_bwd_dq_kernel.
// Those take head dim 64, the flagship's. At every other head dim that is a
// multiple of 16 in [16, 128] (the TPU kernels read d from their inputs)
// attn_fwd_mma_kernel (attention_fwd.cuh), attn_bwd_prep_kernel,
// attn_bwd_dkdv_mma_kernel and attn_bwd_dq_mma_kernel (at the end of this
// file) replace the same three, in a simpler mma.sync design.
// The forward template lives in attention_fwd.cuh, which the serving
// attention block (attention_block.cu) includes too; the PTX wrappers and
// the tensor-map encoder in sm90.cuh.
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
// moves 135 MB (40 us) for 21.6 GFLOP (22 us). At (8, 1025, 16, 64) the
// products lead: 34.4 and 86 GFLOP (35 and 87 us). Both stay far from these
// bounds for a reason the bounds do not count: per (query, key) pair the
// kernels also do about 20 f32 and integer operations on the CUDA cores
// (exp2, the murmur3 hash, the dropout select, the score gradient), which at
// n = 257 take as long as the bytes; and 64-row tiles pad 257 to 320. So the
// design keeps the tensor cores and the copies off the critical path of
// those operations:
//   * Operands arrive by TMA (cp.async.bulk.tensor, 128-byte swizzle) into a
//     ring of shared-memory stages guarded by mbarriers. A producer warp
//     keeps the loads in flight; one consumer warpgroup (128 threads) runs
//     the products as wgmma m64n64k16 (bf16 in, f32 accumulate). The score
//     tile stays in registers and is the next product's A operand. Two or
//     three blocks share an SM, so one block's softmax overlaps another's
//     products and loads.
//   * q, k, v are read through one rank-4 tensor map each over the QKV
//     projection's (b, n, 3, h, 64) view (dims d, n, h, b with the caller's
//     strides); rows past n arrive as zeros, and the kernels mask scores and
//     weights of rows and columns past n.
//   * Forward: one block per (batch*head, 64-query tile), 160 threads, 42 KB
//     of shared memory, three blocks an SM; K and V tiles of 64 keys stream
//     through 2 stages. Online softmax in f32 with exp2f and log2(e) folded
//     into the scale; the row sum runs over ALL keys before dropout; the mask
//     and 1/(1-p) multiply the unnormalised weights, which are rounded to
//     bf16 for the value product (the TPU kernel rounds the normalised ones:
//     a relative difference of one bf16 rounding, 2^-9); the row
//     log-sum-exp is saved, (batch*head, n) f32, for the backward. ptxas:
//     128 registers with the mask, 107 without, no spills.
//   * Backward, three launches. attn_bwd_prep_kernel: per query row
//     delta = rowsum(g * out) (the identity rowsum(dw * P) = g . O holds with
//     dropout; O is the forward's bf16 output, one bf16 rounding against the
//     TPU kernel's f32 row sum) and lse * log2(e), into a padded f32 pair per
//     row; it also zeroes the dq tickets. attn_bwd_kernel: one block per
//     (batch*head, 64-key tile), 256 threads, 90 KB of shared memory, two
//     blocks an SM; K and V resident, looping over the query tiles (Q, the
//     incoming gradient and the row pairs through 2 stages). Each product
//     once, 10 * b*h*n^2*d operations as the TPU kernel:
//       S^T = K Q^T, dP^T = V G^T (A and B from shared memory),
//       P^T = exp2(S^T * scale * log2e - lse * log2e),
//       dV += bf16(keep * P^T / (1-p)) G   (A from registers),
//       dS^T = P^T (keep * dP^T / (1-p) - delta) * scale,
//       dK += bf16(dS^T) Q                 (A from registers),
//       dQ_part = bf16(dS) K               (dS^T through shared memory, read
//                                           transposed).
//     The producer warpgroup (a loader warp, a dQ warp, two idle) gives its
//     registers to the consumers with setmaxnreg (32 and 224), so dK, dV, S^T,
//     dP^T and the dQ part stay in registers: ptxas, 128 registers at launch,
//     no spills, no serialised wgmma (at a flat 168 it spilled 116 bytes and
//     serialised them, 12-18% slower).
//     dQ sums the parts of every key tile of the head, deterministically: the
//     consumers write each f32 part to shared memory (two buffers, 128-byte
//     swizzled, so without bank conflicts), and the dQ warp adds it to an f32
//     sum in device memory with two TMA tensor reduces
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
// tickets (none at D != 64, whose dq kernel needs none).
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

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The (32 d x 64 rows) f32 box at (d0, row, batch*head) of the dq sum's
// tensor map = or += the 128-byte-swizzled box at src (shared memory), by the
// TMA unit, in the calling thread's bulk group. Rows past n are not written.
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

// Consumers and a producer warpgroup: a loader warp, a dQ warp, two idle. The
// producers give up registers (setmaxnreg) so that the consumers hold dK, dV,
// S^T, dP^T and the dQ part without spilling or serialising their wgmmas.
constexpr int BWD_THREADS = CONSUMERS + 128;
constexpr int PRODUCER_REGS = 32, CONSUMER_REGS = 224;  // (32 + 224) * 128 = 65536 / 2 blocks
// One f32 dQ part in shared memory: two boxes of (64 rows x 32 d), 128 bytes
// a row, 128-byte swizzled as TMA reads them. A warp's stores of its
// accumulator fragment then take two wavefronts; row-major rows 256 bytes
// apart would put its 8 rows on the same banks and take eight.
constexpr int DQ_HALF = TILE * 32 * 4;  // 8 KB
constexpr int DQ_BYTES = 2 * DQ_HALF;

// Byte offset of dQ part element (row, d) in that layout.
__device__ __forceinline__ int dq_part_offset(int row, int d) {
  return (d >> 5) * DQ_HALF + row * 128 + ((((d & 31) >> 2) ^ (row & 7)) << 4) + (d & 3) * 4;
}

// Shared memory: K | V | dS^T | Q[2] | G[2] | dQ part[2] | stats[2] | barriers.
constexpr int BWD_Q = 3 * TILE_BYTES;
constexpr int BWD_G = BWD_Q + STAGES * TILE_BYTES;
constexpr int BWD_DQ = BWD_G + STAGES * TILE_BYTES;
constexpr int BWD_STATS = BWD_DQ + 2 * DQ_BYTES;
constexpr int BWD_BARS = BWD_STATS + STAGES * TILE * 8;
constexpr int BWD_SMEM = BWD_BARS + 128 + 1024;

__global__ void __launch_bounds__(BWD_THREADS, 2)
attn_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                const __grid_constant__ CUtensorMap tdq, const float2* __restrict__ stats,
                const int* __restrict__ seeds, int* __restrict__ tickets, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int n, int H, int n_pad, int rotate, float scale,
                float scale_log2, uint32_t threshold, float keep_scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + TILE_BYTES);
  uint8_t* dss = smem + 2 * TILE_BYTES;  // dS^T, [key][query] bf16, 128-byte swizzle
  auto qs = [&](int s) { return smem + BWD_Q + s * TILE_BYTES; };
  auto gs = [&](int s) { return smem + BWD_G + s * TILE_BYTES; };
  auto dqs = [&](int s) { return smem + BWD_DQ + s * DQ_BYTES; };
  auto st = [&](int s) { return reinterpret_cast<const float2*>(smem + BWD_STATS + s * TILE * 8); };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BWD_BARS);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;
  uint64_t* dq_full = bars + 1 + 2 * STAGES;
  uint64_t* dq_empty = bars + 3 + 2 * STAGES;

  const int kt = blockIdx.x;
  const int ntiles = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = kt * TILE;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&dq_full[s], CONSUMERS);
      mbar_init(&dq_empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == CONSUMERS) {  // loader: K and V once, then Q, G and the row stats
      mbar_expect_tx(kv_full, 2 * TILE_BYTES);
      tma_load_tile(ks, &tk, kv_full, k0, h, b);
      tma_load_tile(vs, &tv, kv_full, k0, h, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        const int q0 = (rotate ? (kt + i) % ntiles : i) * TILE;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * TILE_BYTES + TILE * 8);
        tma_load_tile(qs(s), &tq, &full[s], q0, h, b);
        tma_load_tile(gs(s), &tg, &full[s], q0, h, b);
        bulk_load(smem + BWD_STATS + s * TILE * 8, stats + (long long)bh * n_pad + q0, TILE * 8,
                  &full[s]);
      }
    }
    if (threadIdx.x == CONSUMERS + 32) {
      // dQ warp: adds each dQ part to the f32 sum in device memory, in the
      // tile's fixed order (the first part is stored), one key tile at a time
      for (int i = 0; i < ntiles; ++i) {
        const int qt = rotate ? (kt + i) % ntiles : i;
        const int order = rotate ? i : kt;
        int* ticket = tickets + (long long)bh * ntiles + qt;
        mbar_wait(&dq_full[i & 1], (i >> 1) & 1);
        if (order > 0)
          while (ld_acquire(ticket) != order) {
          }
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        tma_store_box(&tdq, dqs(i & 1), 0, qt * TILE, bh, order > 0);
        tma_store_box(&tdq, dqs(i & 1) + DQ_HALF, 32, qt * TILE, bh, order > 0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        st_release(ticket, order + 1);
        mbar_arrive(&dq_empty[i & 1]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys (accumulator rows): key0, key0 + 8
  const uint32_t seed_mix = static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du;
  const uint32_t kmix[2] = {key0 * 0x85EBCA77u + seed_mix, (key0 + 8) * 0x85EBCA77u + seed_mix};
  const bool kvalid[2] = {key0 < n, key0 + 8 < n};

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  mbar_wait(kv_full, 0);
  const uint64_t k_kmaj = desc_kmajor(ks), v_kmaj = desc_kmajor(vs), k_mn = desc_mnmajor(ks);
  const uint64_t ds_mn = desc_mnmajor(dss);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    const int q0 = (rotate ? (kt + i) % ntiles : i) * TILE;
    mbar_wait(&full[s], (i / STAGES) & 1);

    // S^T = K Q^T and dP^T = V G^T: keys as rows, queries as columns
    float sc[32], dp[32];
    wgmma_fence();
    const uint64_t q_kmaj = desc_kmajor(qs(s)), g_kmaj = desc_kmajor(gs(s));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(sc, k_kmaj + 2 * kk, q_kmaj + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<0, 0>(dp, v_kmaj + 2 * kk, g_kmaj + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const float2* stq = st(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * j + 2 * c + e;  // query within the tile
        const float2 lse_delta = stq[qi];
        const uint32_t query = q0 + qi;
        const bool qvalid = query < static_cast<uint32_t>(n);
        const uint32_t qmix = query * 0x9E3779B1u;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int idx = 4 * j + 2 * r + e;
          const float p = qvalid && kvalid[r] ? exp2f(fmaf(sc[idx], scale_log2, -lse_delta.x)) : 0.0f;
          const bool keep = fmix(qmix + kmix[r]) >= threshold;
          const float dw = keep ? dp[idx] * keep_scale : 0.0f;
          sc[idx] = keep ? p * keep_scale : 0.0f;             // dropped weights, for dV
          dp[idx] = p * (dw - lse_delta.y) * scale;            // score gradient, for dK and dQ
        }
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    acc_to_afrag(pa, sc);
    acc_to_afrag(dsa, dp);

    // dS^T into shared memory, [key][query], the swizzle TMA would give, for dQ
    consumer_sync();  // every warp is done with the previous tile's dQ product
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
        *reinterpret_cast<uint32_t*>(dss + row * 128 + ((j ^ (row & 7)) << 4) + 4 * c) =
            (r == 0 ? dsa[j >> 1][(j & 1) * 2] : dsa[j >> 1][(j & 1) * 2 + 1]);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();

    float dqp[32];
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    wgmma_fence();
    const uint64_t q_mn = desc_mnmajor(qs(s)), g_mn = desc_mnmajor(gs(s));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dv_acc, pa[kk], g_mn + 128 * kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dk_acc, dsa[kk], q_mn + 128 * kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<1, 1>(dqp, ds_mn + 128 * kk, k_mn + 128 * kk, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(dqp);
    mbar_arrive(&empty[s]);  // Q, G and the stats of stage s are no longer read

    // this tile's dQ part, f32, for the dQ warp
    mbar_wait(&dq_empty[i & 1], ((i >> 1) & 1) ^ 1);
    uint8_t* part = dqs(i & 1);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(part + dq_part_offset(warp * 16 + g + 8 * r, 8 * j + 2 * c)) =
            make_float2(dqp[4 * j + 2 * r], dqp[4 * j + 2 * r + 1]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&dq_full[i & 1]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key < n) {
      const long long o = (((long long)b * n + key) * H + h) * HD + 2 * c;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * j) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * j) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dq[b, row, h, :] = bf16(dq_acc[b*H + h, row, :]); 8 values a thread.
__global__ void __launch_bounds__(256)
attn_bwd_dq_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq, int n, int H,
                   long long chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const long long e = i * 8;  // element of dq, (b, n, h, 64) order
  const int d = static_cast<int>(e % HD);
  const long long rh = e / HD;  // (b * n + row) * H + h
  const int h = static_cast<int>(rh % H);
  const long long bn = rh / H;
  const long long b = bn / n, row = bn % n;
  const float* src = dq_acc + ((b * H + h) * n + row) * HD + d;
  const float4 x = __ldcs(reinterpret_cast<const float4*>(src));
  const float4 y = __ldcs(reinterpret_cast<const float4*>(src + 4));
  uint4 out;
  out.x = pack_bf16(x.x, x.y);
  out.y = pack_bf16(x.z, x.w);
  out.z = pack_bf16(y.x, y.y);
  out.w = pack_bf16(y.z, y.w);
  *reinterpret_cast<uint4*>(dq + e) = out;
}

// The backward's f32 dq sum, (BH, n, 64) contiguous, as a rank-3 (d, n, BH)
// map of (32 x 64) boxes, 128-byte swizzled; rows past n are not written.
bool dq_sum_map(CUtensorMap* map, void* base, int BH, int n) {
  const cuuint64_t dims[3] = {HD, static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {HD * 4, static_cast<cuuint64_t>(n) * HD * 4};
  const cuuint32_t box[3] = {32, TILE, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// ------------------------------- backward at every other head width ----
//
// The backward at head dim D (a multiple of 16 in [16, 128], not 64), in
// attention_fwd.cuh's simple design (mma.sync, padded shared-memory rows
// filled by all threads): the same formulas, keep hash and rounding points
// as attn_bwd_kernel, in three launches that need no co-residency:
//   attn_bwd_prep_kernel<D>: the row pairs (lse * log2 e, delta), without
//     tickets;
//   attn_bwd_dkdv_mma_kernel: one block per (batch*head, 64-key tile), its
//     K and V resident, looping over the query tiles: S^T = K Q^T, dP^T =
//     V G^T, then dV += bf16(dropped P^T) G and dK += bf16(dS^T) Q;
//   attn_bwd_dq_mma_kernel: one block per (batch*head, 64-query tile), its
//     Q and G resident, looping over the key tiles: S and dP again, then
//     dQ += bf16(dS) K, summed in registers in key order, so dq is
//     deterministic without the d = 64 kernel's tickets. It computes the
//     two score products a second time (14 * b*h*n^2*d operations in all,
//     against 10).

template <int D>
struct MmaBwdDims {
  using M = MmaDims<D>;
  // K | V | Q | G | Q^T | G^T | row pairs
  static constexpr int DKDV_SMEM = 4 * M::TILE + 2 * M::TILE_T + MMA_ROWS * 8;
  // Q | G | K | V | K^T | row pairs
  static constexpr int DQ_SMEM = 4 * M::TILE + M::TILE_T + MMA_ROWS * 8;
};

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
attn_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, long long sb, long long sn, long long sh,
                         const bf16* __restrict__ grad, const float2* __restrict__ stats,
                         const int* __restrict__ seeds, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int n, int H, int n_pad, float scale,
                         float scale_log2, uint32_t threshold, float keep_scale) {
  using M = MmaDims<D>;
  extern __shared__ __align__(16) uint8_t smem_mma[];
  bf16* ks = reinterpret_cast<bf16*>(smem_mma);
  bf16* vs = reinterpret_cast<bf16*>(smem_mma + M::TILE);
  bf16* qs = reinterpret_cast<bf16*>(smem_mma + 2 * M::TILE);
  bf16* gs = reinterpret_cast<bf16*>(smem_mma + 3 * M::TILE);
  bf16* qt = reinterpret_cast<bf16*>(smem_mma + 4 * M::TILE);
  bf16* gt = reinterpret_cast<bf16*>(smem_mma + 4 * M::TILE + M::TILE_T);
  float2* st = reinterpret_cast<float2*>(smem_mma + 4 * M::TILE + 2 * M::TILE_T);

  const int k0 = blockIdx.x * MMA_ROWS;
  const int ntiles = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long head = b * sb + h * sh;
  const long long gstride = static_cast<long long>(H) * D;  // grad is contiguous
  const long long ghead = (long long)b * n * gstride + static_cast<long long>(h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys (accumulator rows): key0, key0 + 8
  const uint32_t seed_mix = static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du;
  const uint32_t kmix[2] = {key0 * 0x85EBCA77u + seed_mix, (key0 + 8) * 0x85EBCA77u + seed_mix};
  const bool kvalid[2] = {key0 < n, key0 + 8 < n};

  load_tile<D, false>(ks, k + head + k0 * sn, sn, n - k0);
  load_tile<D, false>(vs, v + head + k0 * sn, sn, n - k0);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  for (int i = 0; i < ntiles; ++i) {
    const int q0 = i * MMA_ROWS;
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<D, false>(qs, q + head + q0 * sn, sn, n - q0);
    load_tile<D, true>(qt, q + head + q0 * sn, sn, n - q0);
    load_tile<D, false>(gs, grad + ghead + q0 * gstride, gstride, n - q0);
    load_tile<D, true>(gt, grad + ghead + q0 * gstride, gstride, n - q0);
    if (threadIdx.x < MMA_ROWS) st[threadIdx.x] = stats[(long long)bh * n_pad + q0 + threadIdx.x];
    __syncthreads();

    // S^T = K Q^T and dP^T = V G^T: keys as rows, queries as columns
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_afrag(ka, ks, M::LD, warp * 16, 16 * kk, g, c);
      load_afrag(va, vs, M::LD, warp * 16, 16 * kk, g, c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        load_bfrag(b0, b1, qs, M::LD, 8 * j, 16 * kk, g, c);
        mma16816(sc + 4 * j, ka, b0, b1);
        load_bfrag(b0, b1, gs, M::LD, 8 * j, 16 * kk, g, c);
        mma16816(dp + 4 * j, va, b0, b1);
      }
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * j + 2 * c + e;  // query within the tile
        const float2 lse_delta = st[qi];
        const uint32_t query = q0 + qi;
        const bool qvalid = query < static_cast<uint32_t>(n);
        const uint32_t qmix = query * 0x9E3779B1u;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int idx = 4 * j + 2 * r + e;
          const float p = qvalid && kvalid[r] ? exp2f(fmaf(sc[idx], scale_log2, -lse_delta.x)) : 0.0f;
          const bool keep = fmix(qmix + kmix[r]) >= threshold;
          const float dw = keep ? dp[idx] * keep_scale : 0.0f;
          sc[idx] = keep ? p * keep_scale : 0.0f;   // dropped weights, for dV
          dp[idx] = p * (dw - lse_delta.y) * scale;  // score gradient, for dK
        }
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    acc_to_afrag(pa, sc);
    acc_to_afrag(dsa, dp);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        load_bfrag(b0, b1, gt, MMA_LDT, 8 * j, 16 * kk, g, c);
        mma16816(dv_acc + 4 * j, pa[kk], b0, b1);
        load_bfrag(b0, b1, qt, MMA_LDT, 8 * j, 16 * kk, g, c);
        mma16816(dk_acc + 4 * j, dsa[kk], b0, b1);
      }
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

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
attn_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, long long sb, long long sn, long long sh,
                       const bf16* __restrict__ grad, const float2* __restrict__ stats,
                       const int* __restrict__ seeds, bf16* __restrict__ dq, int n, int H,
                       int n_pad, float scale, float scale_log2, uint32_t threshold,
                       float keep_scale) {
  using M = MmaDims<D>;
  extern __shared__ __align__(16) uint8_t smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);
  bf16* gs = reinterpret_cast<bf16*>(smem_mma + M::TILE);
  bf16* ks = reinterpret_cast<bf16*>(smem_mma + 2 * M::TILE);
  bf16* vs = reinterpret_cast<bf16*>(smem_mma + 3 * M::TILE);
  bf16* kt = reinterpret_cast<bf16*>(smem_mma + 4 * M::TILE);
  float2* st = reinterpret_cast<float2*>(smem_mma + 4 * M::TILE + M::TILE_T);

  const int q0 = blockIdx.x * MMA_ROWS;
  const int ntiles = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long head = b * sb + h * sh;
  const long long gstride = static_cast<long long>(H) * D;
  const long long ghead = (long long)b * n * gstride + static_cast<long long>(h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int qrow = warp * 16 + g;  // this thread's queries in the tile: qrow, qrow + 8
  const uint32_t seed_mix = static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du;

  load_tile<D, false>(qs, q + head + q0 * sn, sn, n - q0);
  load_tile<D, false>(gs, grad + ghead + q0 * gstride, gstride, n - q0);
  if (threadIdx.x < MMA_ROWS) st[threadIdx.x] = stats[(long long)bh * n_pad + q0 + threadIdx.x];
  __syncthreads();
  float lse2[2], delta[2];
  uint32_t qmix[2];
  bool qvalid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float2 lse_delta = st[qrow + 8 * r];
    const uint32_t query = q0 + qrow + 8 * r;
    lse2[r] = lse_delta.x;
    delta[r] = lse_delta.y;
    qvalid[r] = query < static_cast<uint32_t>(n);
    qmix[r] = query * 0x9E3779B1u + seed_mix;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * MMA_ROWS;
    __syncthreads();  // every warp is done with the previous key tile
    load_tile<D, false>(ks, k + head + k0 * sn, sn, n - k0);
    load_tile<D, true>(kt, k + head + k0 * sn, sn, n - k0);
    load_tile<D, false>(vs, v + head + k0 * sn, sn, n - k0);
    __syncthreads();

    // S = Q K^T and dP = G V^T: queries as rows, keys as columns
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], ga[4];
      load_afrag(qa, qs, M::LD, warp * 16, 16 * kk, g, c);
      load_afrag(ga, gs, M::LD, warp * 16, 16 * kk, g, c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        load_bfrag(b0, b1, ks, M::LD, 8 * j, 16 * kk, g, c);
        mma16816(sc + 4 * j, qa, b0, b1);
        load_bfrag(b0, b1, vs, M::LD, 8 * j, 16 * kk, g, c);
        mma16816(dp + 4 * j, ga, b0, b1);
      }
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t key = k0 + 8 * j + 2 * c + e;
        const bool kvalid = key < static_cast<uint32_t>(n);
        const uint32_t kmix = key * 0x85EBCA77u;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int idx = 4 * j + 2 * r + e;
          const float p = qvalid[r] && kvalid ? exp2f(fmaf(sc[idx], scale_log2, -lse2[r])) : 0.0f;
          const bool keep = fmix(qmix[r] + kmix) >= threshold;
          const float dw = keep ? dp[idx] * keep_scale : 0.0f;
          dp[idx] = p * (dw - delta[r]) * scale;  // score gradient, for dQ
        }
      }
    }
    uint32_t dsa[4][4];
    acc_to_afrag(dsa, dp);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        load_bfrag(b0, b1, kt, MMA_LDT, 8 * j, 16 * kk, g, c);
        mma16816(dq_acc + 4 * j, dsa[kk], b0, b1);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qrow + 8 * r;
    if (row < n) {
      bf16* dst = dq + (((long long)b * n + row) * H + h) * D + 2 * c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(dq_acc[4 * j + 2 * r], dq_acc[4 * j + 2 * r + 1]);
    }
  }
}

// The three launches at head dim D; stats as in the d = 64 backward.
template <int D>
int attention_backward_mma(const bf16* q, const bf16* k, const bf16* v, long long sb,
                           long long sn, long long sh, const bf16* out, const bf16* grad,
                           const float* lse, const int* seeds, bf16* dq, bf16* dk, bf16* dv,
                           float2* stats, int B, int n, int H, unsigned int threshold,
                           float keep_scale, cudaStream_t s) {
  using BD = MmaBwdDims<D>;
  static unsigned long long smem_set[2];
  const int ntiles = (n + MMA_ROWS - 1) / MMA_ROWS;
  const int n_pad = ntiles * MMA_ROWS;
  const long long rows = static_cast<long long>(B) * n_pad * H;
  attn_bwd_prep_kernel<D><<<static_cast<unsigned>((rows * 32 + 127) / 128), 128, 0, s>>>(
      out, grad, lse, stats, nullptr, n, n_pad, H, rows, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const dim3 grid(ntiles, B * H);
  if ((err = ensure_smem(attn_bwd_dkdv_mma_kernel<D>, BD::DKDV_SMEM, smem_set[0])) != cudaSuccess)
    return static_cast<int>(err);
  attn_bwd_dkdv_mma_kernel<D><<<grid, MMA_THREADS, BD::DKDV_SMEM, s>>>(
      q, k, v, sb, sn, sh, grad, stats, seeds, dk, dv, n, H, n_pad, scale, scale * LOG2E,
      threshold, keep_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = ensure_smem(attn_bwd_dq_mma_kernel<D>, BD::DQ_SMEM, smem_set[1])) != cudaSuccess)
    return static_cast<int>(err);
  attn_bwd_dq_mma_kernel<D><<<grid, MMA_THREADS, BD::DQ_SMEM, s>>>(
      q, k, v, sb, sn, sh, grad, stats, seeds, dq, n, H, n_pad, scale, scale * LOG2E, threshold,
      keep_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward on `stream` (attention_fwd.cuh's attention_forward). q, k, v:
// (B, n, H, d) bf16 with element strides (sb, sn, sh); out: contiguous
// (B, n, H, d) bf16; lse: (B*H, n) f32 or null; seeds: (B*H,) int32 (the
// uint32 seeds' bits), ignored when dropout == 0, which compiles the mask
// out; d a multiple of 16 in [16, 128]. Returns the launch error
// (cudaSuccess == 0), or cudaErrorInvalidValue if d is outside that range
// or a tensor map is refused.
extern "C" int mb_dropout_attention_fwd(const void* q, const void* k, const void* v,
                                        long long sb, long long sn, long long sh,
                                        const void* seeds, void* out, void* lse, int B, int n,
                                        int H, int d, unsigned int threshold, float keep_scale,
                                        int dropout, void* stream) {
  return attention_forward(q, k, v, sb, sn, sh, seeds, out, lse, B, n, H, d, threshold,
                           keep_scale, dropout != 0, static_cast<cudaStream_t>(stream));
}

// Backward on `stream`: dq, dk, dv (contiguous (B, n, H, d) bf16) from q,
// k, v (strided as in the forward), the forward's out and lse, the incoming
// gradient grad (contiguous bf16) and the seeds. Scratch: stats, (B*H,
// n_pad) float2 with n_pad = 64 * ceil(n / 64); at d = 64 also dq_acc,
// (B*H, n, 64) f32, and tickets, (B*H, n_pad / 64) int32 (unread, and may
// be null, at other d). Three launches: the row stats, then at d = 64 the
// main kernel and dq_acc to bf16 dq, at other d the dk/dv and the dq
// kernels. Returns the first launch error (cudaSuccess == 0), or
// cudaErrorInvalidValue if d is not a multiple of 16 in [16, 128] or a
// tensor map is refused.
extern "C" int mb_dropout_attention_bwd(const void* q, const void* k, const void* v,
                                        long long sb, long long sn, long long sh,
                                        const void* out, const void* grad, const void* lse,
                                        const void* seeds, void* dq, void* dk, void* dv,
                                        void* stats, void* dq_acc, void* tickets, int B, int n,
                                        int H, int d, int rotate, unsigned int threshold,
                                        float keep_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define MB_BWD_CASE(W)                                                                         \
  case W:                                                                                     \
    return attention_backward_mma<W>(                                                         \
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), \
        sb, sn, sh, static_cast<const bf16*>(out), static_cast<const bf16*>(grad),            \
        static_cast<const float*>(lse), static_cast<const int*>(seeds), static_cast<bf16*>(dq), \
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float2*>(stats), B, n, H,  \
        threshold, keep_scale, s);
    MB_MMA_HEAD_DIMS(MB_BWD_CASE)
#undef MB_BWD_CASE
    case HD:
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ntiles = (n + TILE - 1) / TILE;
  const int n_pad = ntiles * TILE;
  CUtensorMap tq, tk, tv, tg, tdq;
  const long long gn = static_cast<long long>(H) * HD;
  if (!current_context() || !tile_map(&tq, q, B, n, H, sb, sn, sh) ||
      !tile_map(&tk, k, B, n, H, sb, sn, sh) || !tile_map(&tv, v, B, n, H, sb, sn, sh) ||
      !tile_map(&tg, grad, B, n, H, gn * n, gn, HD) || !dq_sum_map(&tdq, dq_acc, B * H, n))
    return static_cast<int>(cudaErrorInvalidValue);

  const long long rows = static_cast<long long>(B) * n_pad * H;
  const int num_tickets = B * H * ntiles;
  attn_bwd_prep_kernel<HD><<<static_cast<unsigned>((rows * 32 + 127) / 128), 128, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(grad),
      static_cast<const float*>(lse), static_cast<float2*>(stats), static_cast<int*>(tickets), n,
      n_pad, H, rows, num_tickets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  static unsigned long long smem_set;
  if ((err = ensure_smem(attn_bwd_kernel, BWD_SMEM, smem_set)) != cudaSuccess)
    return static_cast<int>(err);
  attn_bwd_kernel<<<dim3(ntiles, B * H), BWD_THREADS, BWD_SMEM, s>>>(
      tq, tk, tv, tg, tdq, static_cast<const float2*>(stats), static_cast<const int*>(seeds),
      static_cast<int*>(tickets), static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, H, n_pad,
      rotate, scale, scale * LOG2E, threshold, keep_scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const long long chunks = static_cast<long long>(B) * n * H * (HD / 8);
  attn_bwd_dq_kernel<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), n, H, chunks);
  return static_cast<int>(cudaGetLastError());
}
