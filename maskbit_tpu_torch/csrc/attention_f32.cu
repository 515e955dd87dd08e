// The float32 forms of the four attention kernels on Hopper (sm_90a).
//
// Replaces, for float32 inputs (the JAX trainers' and generation entry
// points' compute dtype under `training.mixed_precision: no`), the TPU
// kernels of maskbit_tpu/nn/pallas_attention.py:
//   * _dropattn_fwd_kernel (dropout_attention -> _dropout_attention_fwd), by
//     attn_fwd_tf32_kernel<D, true>;
//   * _attention_kernel (fused_attention), by attn_fwd_tf32_kernel<D, false>:
//     the same forward with the mask compiled out;
//   * _dropattn_bwd_kernel (_dropout_attention_bwd), by attn_bwd_prep_f32_kernel
//     and attn_bwd_tf32_kernel<D>;
//   * _attention_block_kernel (fused_attention_block), by split_tf32_kernel
//     (the weights' TF32 halves), proj_tf32_kernel<EPI_BIAS> (QKV, with the
//     bias), attn_fwd_tf32_kernel<D, false>, proj_tf32_kernel<EPI_RESID>
//     (out-projection, bias and residual) and layernorm_kernel<float>
//     (layernorm.cuh, shared with the bf16 block).
// Each is a template on the head dim D, instantiated at the multiples of 16
// in [16, 128]; another d in [1, 128] runs the instantiation at d rounded up
// to 16 on inputs the wrapper zero-pads per head, with d's softmax scale,
// as the bf16 kernels do. A d past 128 runs the 3xTF32 kernels of
// attention_wide_f32.cuh (included below: attn_fwd_wide_tf32_kernel<W,
// dropout, stream>, for the block's core too, and attention_wide.cuh's
// attn_bwd_wide_prep_kernel<float> with attn_bwd_wide_tf32_kernel<dq,
// stream>; that header describes their tiles, rings, warpgroups and
// bounds). In float32 each rounding point of the bf16 form (qkv, the softmax
// weights, the head outputs, the score gradient) is a no-op, so these
// compute what the TPU kernels compute in float32.
//
// How they multiply in float32: 3xTF32 on the tensor cores, wgmma m64nNk8
// .tf32 (495 TFLOP/s dense, against 67 for FFMA on the CUDA cores). Each
// operand is split as a = a_hi + a_lo, a_hi = cvt.rna.tf32(a), a_lo =
// cvt.rna.tf32(a - a_hi) (a_hi carries 11 significant bits, a_lo the next
// 11), and each product is summed in f32 as a_lo b_hi + a_hi b_lo + a_hi
// b_hi; the dropped a_lo b_lo is below 2^-22 of |a b|. The tensor cores' f32
// accumulation does not round to nearest, so a long chain of wgmma into one
// accumulator loses accuracy with its length: against a float64 block at
// (1, 257, E) the projections' error grew from 4.8e-7 at E = 1024 to 1.5e-4
// at 8192 with one accumulator over all of K, where the plain float32
// block's stays within 1.4e-7..2.0e-6. The projections therefore add each
// 32-wide stage's wgmma sum into a register sum on the CUDA cores:
// 1.4e-7..1.4e-6 at those E; the forward does the same with each key tile's
// value product, the long chain over n (its scores sum over d <= 128 in one
// accumulator). The backward's dK and dV stay in one accumulator over the
// queries (no registers left for a second): 3.7e-6 at n = 257, 1.0e-5 at
// 4097, against the plain version's 5.9e-7 and 8.1e-7 (chip_smoke.py
// --phases f32_error, an NVIDIA H100 80GB HBM3 at 700 W). The card tests
// hold every output within 1e-4 of the largest reference value (F32_TOL).
//
// What bounds them on the H100. At the flagship training shape, q, k, v of
// (32, 257, 16, 64) float32 (33.7 MB each), the forward moves 135 MB (40 us
// at 3.35 TB/s) for 8.7 GFLOP, which as 3xTF32 is 26.0 GFLOP of
// tensor-core work (53 us at 495 TFLOP/s); the backward 270 MB (81 us) for
// 21.6 GFLOP, 64.7 as 3xTF32 (131 us). The serving block at x (16 * 257,
// 1024) is 38.8 GFLOP, 34.5 of it the two projections (3xTF32: 104 GFLOP,
// 209 us), the attention core 4.3 (3xTF32: 13 GFLOP, 26 us), against 50 MB
// (15 us). Beside the products the forward spends about 20 f32 and integer
// operations a (query, key) pair on the CUDA cores (the online softmax, the
// keep hash, the weights' split), and the splitters 4 to 6 a K and V
// element; no bound counts these.
//
// The forward (attn_fwd_tf32_kernel<D, DROPOUT>). One block per
// (batch*head, 64 WGS queries), the bf16 forward's pipeline with a split
// stage in it:
//   * a producer warpgroup: one thread loads the Q tiles once, and K and V
//     tiles of KT keys by TMA (rows past n read 0) into rings of two tiles;
//     three splitter warps turn Q and each K tile into hi (in place) and lo
//     halves, and each V tile into V^T's hi and lo halves, [d][key]: the
//     value product reduces over keys, and .tf32 takes its B operand K-major
//     only, so V is transposed there, as FlashAttention-3's fp8 path does.
//     Within each group of 8 keys V^T's columns run 0, 2, 4, 6, 1, 3, 5, 7,
//     so that the score accumulator's weights, (g, 2c) and (g, 2c + 1) in a
//     k8 slab, are the A fragment's (g, c) and (g, c + 4) as they stand, with
//     no shuffle. K, raw V and V^T have rings of their own, each tile freed
//     as soon as its last reader is done (K after the scores, raw V after the
//     split, V^T after the value product), so that loads and splits run a
//     tile ahead of the products; with one ring of whole stages the next
//     load waited for the value product;
//   * WGS consumer warpgroups of 64 queries: S = Q K^T (A and B from shared
//     memory), the online softmax on S in registers (exp2f with log2 e in
//     the scale, keys past n masked, the row sum over ALL keys before
//     dropout, the keep hash on the unnormalised weights, softmax_tile of
//     attention_fwd.cuh), then P V with P's hi and lo halves as A from
//     registers and V^T from shared memory, one wgmma per binary digit of D
//     (Pieces), into a fresh accumulator that is added to O (rescaled by the
//     row's alpha) on the CUDA cores. The scores' large products (hi hi) and
//     small ones go to two accumulators, added on the CUDA cores too. Tile
//     t + 1's scores are issued with tile t's value product, and its softmax
//     runs while that product does. The row log-sum-exp is saved for the
//     backward. A warpgroup whose queries all lie past n does nothing;
//   * the weights and the splitters' tiles are split into TF32 halves by
//     integer operations (split_tf32_int, equal to cvt.rna);
//   * the plan by D (F32Fwd): two consumer warpgroups and 64-key tiles where
//     they fit (D <= 64: 224 KB at 64), two and 32 keys at D = 80 and 96, one
//     and 32 keys at 112 and 128 (224 KB at 128); one block an SM, and with
//     two consumer warpgroups setmaxnreg moves the producer warpgroup's
//     registers to them (56 and 224).
// Versions compared side by side (cli/compare_forward_f32.py on copies of
// this file, an NVIDIA H100 80GB HBM3 at 700 W; device ms of
// fused_attention at (16, 257, 16, 64), this file 0.1224-0.1239): cvt.rna
// for the splits 0.1461-0.1476, the integer split 0.1323-0.1336; one ring
// of whole stages 0.1359; the two consumer warpgroups taking turns to issue
// their products (named barriers; ptxas then waits on the wgmma registers)
// 0.1630; a last tile of at most 16 keys (n = 257: one) computed at N = 16
// and two k8 slabs, which makes ptxas do the same, 0.1605. What bounds it:
// the shared memory the products read (S takes Q and K from shared memory,
// 4 KB a wgmma, against 128 bytes a cycle) and the tensor cores, with the
// splitters' 96 KB a 64-key tile beside them; the two consumer warpgroups'
// softmaxes run at the same time, when the tensor cores wait.
//
// The 3xTF32 products (tf32 section below). wgmma takes .tf32 operands
// K-major only (the transpose flags exist for f16 and bf16 alone), and TMA
// copies tiles without transposing them; the designs below are shaped by
// that:
//   * f32 tiles in shared memory are rows of column panels, 32 floats wide
//     (128-byte rows, 128-byte swizzle) and a 16-wide remainder (64-byte
//     swizzle), each panel a TMA box and a wgmma K-major operand whose k8
//     slabs lie 32 bytes apart (F32Panels);
//   * an operand whose reduction runs along its rows (the input tiles in
//     the backward's products over the sequence) is an A operand in
//     registers, loaded by each thread from the d-contiguous tile at the
//     transposed place, or, as the forward's V, a B operand that splitter
//     warps write transposed; the operands the kernel computes itself (the
//     backward's P^T, dS^T and dS) are written to shared memory K-major in
//     the layout the product needs.
//
// The block's projections (proj_tf32_kernel): C = A W^T, A (M, K) and
// PyTorch's (out, in) weights W (N, K) both K-major. The weights' halves
// W_hi and W_lo are made for each call by split_tf32_kernel, a pass over
// the weights (12 + 4 MB read, 25 + 8 MB written at E = 1024: about 15 us
// at the memory rate, against about 0.3 ms for the products), into the
// caller's scratch: splitting B in shared memory instead would cost each
// block a pass over every stage and a barrier between the split and the
// products. A block computes a (128 x 128) tile of C: the operands arrive
// by TMA (128-byte swizzle, 32-float k slabs: A raw, W_hi and W_lo) through
// a 4-stage mbarrier ring filled by one producer thread; two consumer
// warpgroups of 64 rows each load their A fragments from the raw stage,
// split them in registers and run three wgmma m64n128k8 (A from registers,
// B from shared memory) a k8 slab, each stage's into a fresh accumulator
// that is then added to the tile's register sum (64 FADDs a thread a
// stage; the block's device time 0.5681 against 0.5619 ms with one
// accumulator, at (16, 257, 1024)). setmaxnreg gives the producer
// warpgroup's registers to the consumers (40 and 232). The epilogues add the
// bias (f32 or bf16) and, for the out-projection, the f32 residual, and
// store f32 pairs.
//
// The backward (attn_bwd_tf32_kernel<D>): the bf16 backward's shape, one
// pass per 64-key tile with dQ summed in a fixed order, 10 * b*h*n^2*d
// operations as the TPU kernel (each three TF32 products):
//   * one block per (batch*head, 64-key tile), looping over the query tiles
//     in steps of NQ queries (32 up to D = 32, 16 past it); K and V resident
//     (their hi and lo halves), Q, G and the row statistics through a ring
//     of STG stages;
//   * 256 threads: one consumer warpgroup, and a producer warpgroup whose
//     warps are a TMA loader, the dQ writer and two splitters, which turn
//     each arrived raw tile into its hi half (in place) and lo half, ahead
//     of the consumers;
//   * per step (keys as rows k, NQ queries as columns q):
//       S^T = K Q^T, dP^T = V G^T         (A, B from shared memory, d in k8 slabs)
//       P^T = exp2(S^T scale log2e - lse log2e); dropped = keep P^T / (1-p)
//       dS^T = P^T (keep dP^T / (1-p) - delta) scale
//     the dropped weights and dS^T go to shared memory as [k][q] tiles and
//     dS as a [q][k] tile (hi and lo halves each), then
//       dV^T += G^T dropped^T   (M = d rows, A = G^T from registers)
//       dK^T += Q^T dS^T        (A = Q^T from registers)
//       dQ^T_part = K^T dS      (A = K^T from registers, B the [q][k] tile),
//     M = d a wgmma of 64 rows each (d padded to 64 there: the rows past d
//     are zero fragments whose accumulators are never stored);
//   * dQ: each step's part goes through shared memory in the TMA box
//     layout, and the dQ warp adds it to dq in device memory (rank-4 map
//     over dq itself) with TMA tensor reduces, the first part stored, in a
//     fixed order per (batch*head, query tile) kept by a ticket, as the
//     bf16 backward does (dropout_attention.cu): key tile kt visits query
//     tiles kt, kt+1, ... (mod the count), tile qt summed in the order kt =
//     qt, qt-1, ...; past ROTATE_MAX_TILES the wrapper takes key-tile order.
//     dq is bit for bit the same on a second call;
//   * the plan by D (F32Bwd, and the tuning constants above it): shared
//     memory holds K, V (hi, lo), the ring, the dropped-weight, dS^T and dS
//     tiles (hi, lo) and the dQ parts: 1024 D + STG (16 NQ D + 8 NQ) + 1536
//     NQ + NB 4 NQ D bytes; two blocks an SM where some ring leaves room for
//     them (D <= 64; at 64 one stage and one buffer), else one block with
//     the most stages and buffers that fit 227 KB (at D = 128: two stages,
//     one buffer, 225.4 KB). At D = 48 and 64 each consumer also holds
//     the dQ product's K^T fragments across the steps.
// The keep mask is the TPU kernel's, bit for bit (attention_fwd.cuh).
//
// Layouts as the bf16 kernels': q, k, v (b, n, h, D) f32 read through
// element strides (batch, row, head; each a multiple of 4, the last
// dimension contiguous, 16-byte aligned); out, the incoming gradient, dq,
// dk, dv contiguous (b, n, h, D) f32; the block's weights in the PyTorch
// (out, in) layout.

#include <algorithm>

#include "attention_fwd.cuh"  // TileMaps, consumer_sync
#include "layernorm.cuh"

namespace {

// ------------------------------------------------------------------ tf32 ----

// a = hi + lo in TF32: hi = rna(a), lo = rna(a - hi) (a - hi is exact in f32).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
// The same split by integer operations, equal to cvt.rna for finite x
// (round the magnitude at bit 13, ties away from zero), at the integer
// pipe's rate: the forward's splitters and weights.
__device__ __forceinline__ uint32_t to_tf32_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32_int(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32_int(x);
  lo = to_tf32_int(x - __uint_as_float(hi));
}
// hi and lo halves of 4 floats (INT: by split_tf32_int).
template <bool INT = false>
__device__ __forceinline__ float4 hi4(float4 v, float4& lo) {
  uint32_t h[4], l[4];
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (INT)
      split_tf32_int(x[i], h[i], l[i]);
    else
      split_tf32(x[i], h[i], l[i]);
  }
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                     __uint_as_float(h[3]));
}

// wgmma m64nNk8 .tf32 (f32 accumulate) at N = 16, 32, 64 and 128, each thread
// holding N / 2 accumulators (the layout of sm90.cuh's bf16 forms); one
// macro writes each width's two forms, overloaded on the accumulator
// array's length:
//   wgmma_tf32_ss(d, da, db, scale_d): D (+)= A(64 x 8) B(8 x N), both
//     K-major in shared memory (the only layout .tf32 takes);
//   wgmma_tf32_rs(d, a, db, scale_d): A from registers, warp w of the
//     warpgroup holding rows 16w..16w+15 as mma.m16n8k8's tf32 A fragment:
//     lane l (g = l / 4, c = l % 4) holds a[0] = (g, c), a[1] = (g + 8, c),
//     a[2] = (g, c + 4), a[3] = (g + 8, c + 4).
// scale_d 0 overwrites D.
#define MB_ACC64                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define MB_OPS_N128(d)                                                                       \
  MB_OPS8(d, 0), MB_OPS8(d, 8), MB_OPS8(d, 16), MB_OPS8(d, 24), MB_OPS8(d, 32), MB_OPS8(d, 40), \
      MB_OPS8(d, 48), MB_OPS8(d, 56)

#define MB_DEFINE_WGMMA_TF32(N, ACC, SS_P, SS_REST, RS_P, RS_REST)                            \
  __device__ __forceinline__ void wgmma_tf32_ss(float(&d)[N / 2], uint64_t da, uint64_t db,   \
                                                int scale_d) {                                \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SS_P                                    \
                 ", 0;\nwgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " ACC SS_REST \
                 "}\n"                                                                       \
                 : MB_OPS_N##N(d)                                                            \
                 : "l"(da), "l"(db), "r"(scale_d));                                          \
  }                                                                                          \
  __device__ __forceinline__ void wgmma_tf32_rs(float(&d)[N / 2], const uint32_t(&a)[4],     \
                                                uint64_t db, int scale_d) {                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " RS_P                                    \
                 ", 0;\nwgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 " ACC RS_REST \
                 "}\n"                                                                       \
                 : MB_OPS_N##N(d)                                                            \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));       \
  }

MB_DEFINE_WGMMA_TF32(16, MB_ACC8, "%10", ", %8, %9, p, 1, 1;\n", "%13",
                     ", {%8, %9, %10, %11}, %12, p, 1, 1;\n")
MB_DEFINE_WGMMA_TF32(32, MB_ACC16, "%18", ", %16, %17, p, 1, 1;\n", "%21",
                     ", {%16, %17, %18, %19}, %20, p, 1, 1;\n")
MB_DEFINE_WGMMA_TF32(64, MB_ACC32, "%34", ", %32, %33, p, 1, 1;\n", "%37",
                     ", {%32, %33, %34, %35}, %36, p, 1, 1;\n")
MB_DEFINE_WGMMA_TF32(128, MB_ACC64, "%66", ", %64, %65, p, 1, 1;\n", "%69",
                     ", {%64, %65, %66, %67}, %68, p, 1, 1;\n")
#undef MB_DEFINE_WGMMA_TF32

// The three TF32 products of one k8 slab, A from registers: D += a_lo b_hi +
// a_hi b_lo + a_hi b_hi (the first overwriting D where `first`), the two
// small products first, as CUTLASS's 3xTF32 orders them: where D starts
// the sum they add to each other before the large product does.
template <int N>
__device__ __forceinline__ void mma3_rs(float (&d)[N], const uint32_t (&ahi)[4],
                                        const uint32_t (&alo)[4], uint64_t bhi, uint64_t blo,
                                        bool first) {
  wgmma_tf32_rs(d, alo, bhi, first ? 0 : 1);
  wgmma_tf32_rs(d, ahi, blo, 1);
  wgmma_tf32_rs(d, ahi, bhi, 1);
}
// The same, A from shared memory.
template <int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N], uint64_t ahi, uint64_t alo, uint64_t bhi,
                                        uint64_t blo, bool first) {
  wgmma_tf32_ss(d, alo, bhi, first ? 0 : 1);
  wgmma_tf32_ss(d, ahi, blo, 1);
  wgmma_tf32_ss(d, ahi, bhi, 1);
}

// The column panels of an f32 tile W floats wide (W a multiple of 16): 32
// wide (128-byte rows, 128-byte swizzle) first, then a 16-wide remainder
// (64-byte rows, 64-byte swizzle) where W / 16 is odd; a tile of R rows
// stores its panels one after the other, R rows each.
template <int W>
struct F32Panels {
  static_assert(W % 16 == 0 && W >= 16, "f32 tile width");
  static constexpr int WIDE = W / 32;
  static constexpr bool HAS16 = (W & 16) != 0;
  static constexpr int COUNT = WIDE + HAS16;
  __host__ __device__ static constexpr int width(int p) { return p < WIDE ? 32 : 16; }
  __host__ __device__ static constexpr int col(int p) { return 32 * p; }
  __host__ __device__ static constexpr int of(int c) { return c / 32 < WIDE ? c / 32 : WIDE; }
  // byte offset of element (row, c) in a tile of R rows, swizzled as TMA
  // writes each panel
  __host__ __device__ static constexpr int offset(int R, int row, int c) {
    return of(c) < WIDE
               ? R * (c & ~31) * 4 + row * 128 + ((((c & 31) >> 2) ^ (row & 7)) << 4) + (c & 3) * 4
               : R * 32 * WIDE * 4 + row * 64 + ((((c & 15) >> 2) ^ ((row >> 1) & 3)) << 4) +
                     (c & 3) * 4;
  }
};

// K-major descriptor of the k8 slab kk (columns 8kk..8kk+7) of a tile of R
// rows at shared address `tile`.
template <int W>
__device__ __forceinline__ uint64_t slab_f32(uint32_t tile, int R, int kk) {
  using P = F32Panels<W>;
  const int p = P::of(8 * kk);
  return smem_desc(tile + R * P::col(p) * 4 + (8 * kk - P::col(p)) * 4, P::width(p) * 4, false);
}

// The A fragment of k8 slab kk of a m64 block whose row r is column c0 + r
// of a [row][col] f32 tile of R rows at `tile` (so the fragment holds the
// tile transposed: A[r][k] = tile[8kk + k][c0 + r]), hi and lo halves from
// the tile's two copies (lo at `tile + lo_off`). Rows of the fragment
// past `valid` are zero.
template <int W>
__device__ __forceinline__ void afrag_t(uint32_t (&hi)[4], uint32_t (&lo)[4], const uint8_t* tile,
                                        int lo_off, int R, int kk, int c0, int warp, int g, int c,
                                        int valid) {
  const int r = 16 * warp + g;
  if (r >= valid) {  // whole warps: valid is a multiple of 16
#pragma unroll
    for (int i = 0; i < 4; ++i) hi[i] = lo[i] = 0u;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int off = F32Panels<W>::offset(R, 8 * kk + c + 4 * (i >> 1), c0 + r + 8 * (i & 1));
    hi[i] = *reinterpret_cast<const uint32_t*>(tile + off);
    lo[i] = *reinterpret_cast<const uint32_t*>(tile + lo_off + off);
  }
}

// hi (in place) and lo halves of `bytes` bytes of f32 at `tile`, the lo
// half at tile + lo_off, by `nthreads` threads of which this is `t`.
template <bool INT = false>
__device__ __forceinline__ void split_tile(uint8_t* tile, int lo_off, int bytes, int t,
                                           int nthreads) {
  for (int i = t * 16; i < bytes; i += nthreads * 16) {
    float4* p = reinterpret_cast<float4*>(tile + i);
    float4 lo;
    *p = hi4<INT>(*p, lo);
    *reinterpret_cast<float4*>(tile + lo_off + i) = lo;
  }
}

// hi and lo halves of n4 float4s of src, into hi and lo (device memory).
__global__ void __launch_bounds__(256)
split_tf32_kernel(const float4* __restrict__ src, float4* __restrict__ hi, float4* __restrict__ lo,
                  long long n4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 l;
    hi[i] = hi4(src[i], l);
    lo[i] = l;
  }
}

constexpr int F32_SMEM_LIMIT = 232448;  // a block's shared memory, at most

// A (b, n, h, D) f32 tensor with element strides (sb, sn, sh) as rank-4 (d,
// n, h, b) maps of (W x rows) boxes, one per panel width W of D (F32Panels):
// [0] 32 wide (128-byte swizzle), [1] 16 wide (64-byte swizzle); rows past
// n read 0 and are not written.
template <int D>
bool tile_maps_f32(TileMaps* maps, const void* base, int B, int n, int H, long long sb,
                   long long sn, long long sh, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 4, static_cast<cuuint64_t>(sh) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box32[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t box16[4] = {16, static_cast<cuuint32_t>(rows), 1, 1};
  memset(maps, 0, sizeof(*maps));
  return (F32Panels<D>::WIDE == 0 ||
          encode_tiled(&maps->box[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dims, strides,
                       box32, CU_TENSOR_MAP_SWIZZLE_128B)) &&
         (!F32Panels<D>::HAS16 ||
          encode_tiled(&maps->box[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dims, strides,
                       box16, CU_TENSOR_MAP_SWIZZLE_64B));
}

// All panels of the `rows`-row tile at (row, h, b) into the tile at shared
// address `tile`, on barrier `bar`.
template <int D>
__device__ __forceinline__ void tma_load_tile_f32(uint32_t tile, const TileMaps& maps,
                                                  uint32_t bar, int rows, int row, int h, int b) {
  using P = F32Panels<D>;
#pragma unroll
  for (int p = 0; p < P::COUNT; ++p)
    tma_load_box(tile + rows * P::col(p) * 4, &maps.box[p < P::WIDE ? 0 : 1], bar, P::col(p), row,
                 h, b);
}

// ------------------------------------------------------------- forward ----

// The forward's plan by head dim D (see the header): WGS consumer
// warpgroups of 64 queries each a block and KT keys a tile, the first of
// (2, 64), (2, 32), (1, 64), (1, 32) whose shared memory fits: for each
// consumer warpgroup its Q tile's hi and lo halves, and three rings of
// F32F_STAGES tiles each: K (raw, split in place into its hi half) and its
// lo half, raw V, and V^T's hi and lo halves.
constexpr int F32F_STAGES = 2;
constexpr int F32F_SPLITTERS = 96;  // the producer warpgroup's warps 1..3
constexpr int f32fwd_bytes(int D, int wgs, int kt) {
  return wgs * 2 * 64 * D * 4 + F32F_STAGES * 5 * kt * D * 4 + 128 + 1024;
}

template <int D>
struct F32Fwd {
  static constexpr int PICK = f32fwd_bytes(D, 2, 64) <= F32_SMEM_LIMIT   ? 264
                              : f32fwd_bytes(D, 2, 32) <= F32_SMEM_LIMIT ? 232
                              : f32fwd_bytes(D, 1, 64) <= F32_SMEM_LIMIT ? 164
                                                                         : 132;
  static constexpr int WGS = PICK / 100, KT = PICK % 100;
  static constexpr int THREADS = 128 * (1 + WGS);
  static constexpr int QT = 64 * D * 4;   // a 64-query tile; Q's lo half follows it
  static constexpr int KVT = KT * D * 4;  // a K, V or V^T tile; a lo half follows hi
  // {Q_hi Q_lo}[WGS] | {K_hi K_lo}[STAGES] | V[STAGES] | {V^T_hi V^T_lo}[STAGES]
  // | barriers
  static constexpr int KS = WGS * 2 * QT, VS = KS + F32F_STAGES * 2 * KVT;
  static constexpr int VTS = VS + F32F_STAGES * KVT, BARS = VTS + F32F_STAGES * 2 * KVT;
  static constexpr int SMEM = f32fwd_bytes(D, WGS, KT);
  static_assert(SMEM <= F32_SMEM_LIMIT, "shared memory");
  // setmaxnreg with two consumer warpgroups: 65536 / 384 = 168 registers a
  // thread at launch, the producer warpgroup's to the consumers; one
  // consumer warpgroup runs at 255
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
};

// The m64nW wgmmas that cover D output columns: W runs over D's binary
// digits from 128 down to 16 (each a width with a wgmma form), piece p
// starting at column first(p).
template <int D>
struct Pieces {
  static constexpr int COUNT = ((D >> 7) & 1) + ((D >> 6) & 1) + ((D >> 5) & 1) + ((D >> 4) & 1);
  __host__ __device__ static constexpr int width(int p) {
    for (int w = 128; w >= 16; w >>= 1)
      if ((D & w) && p-- == 0) return w;
    return 0;
  }
  __host__ __device__ static constexpr int first(int p) {
    int c = 0;
    for (int i = 0; i < p; ++i) c += width(i);
    return c;
  }
};

// V^T's hi and lo halves (at vt and vt + lo_off; F32Panels<KT> of D rows)
// from the raw (KT keys x D) tile v, by the splitter t of F32F_SPLITTERS.
// Row d of V^T holds the tile's keys with each group of 8 in the order 0,
// 2, 4, 6, 1, 3, 5, 7: column c of a k8 slab of the value product's A
// fragment is then key 2c, column c + 4 key 2c + 1, which is where the
// score accumulator holds them (see the forward). A warp takes 16 keys by
// 8 columns of d, lane l key l % 16's 4 values at column 4 (l / 16) of the
// 8, and writes them to 4 rows of V^T: its 16-byte loads and its 4-byte
// stores each hit every bank once.
template <int D, int KT>
__device__ __forceinline__ void split_vt(const uint8_t* v, uint8_t* vt, int lo_off, int t) {
  const int warp = t >> 5, lane = t & 31;
  constexpr int UNITS = (KT / 16) * (D / 8);
#pragma unroll 4
  for (int u = warp; u < UNITS; u += F32F_SPLITTERS / 32) {
    const int key = 16 * (u / (D / 8)) + (lane & 15);
    const int d = 8 * (u % (D / 8)) + 4 * (lane >> 4);
    const int col = (key & ~7) + 4 * (key & 1) + ((key & 7) >> 1);  // of V^T
    const float4 x = *reinterpret_cast<const float4*>(v + F32Panels<D>::offset(KT, key, d));
    float4 lo;
    const float4 hi = hi4<true>(x, lo);
    const float h[4] = {hi.x, hi.y, hi.z, hi.w}, l[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = F32Panels<KT>::offset(D, d + i, col);
      *reinterpret_cast<float*>(vt + o) = h[i];
      *reinterpret_cast<float*>(vt + lo_off + o) = l[i];
    }
  }
}

// tq: Q's maps of 64-row boxes; tk, tv: K's and V's of KT-row boxes.
template <int D, bool DROPOUT>
__global__ void __launch_bounds__(F32Fwd<D>::THREADS, 1)
attn_fwd_tf32_kernel(const __grid_constant__ TileMaps tq, const __grid_constant__ TileMaps tk,
                     const __grid_constant__ TileMaps tv, const int* __restrict__ seeds,
                     float* __restrict__ out, float* __restrict__ lse, int n, int H,
                     float scale_log2, uint32_t threshold, float keep_scale) {
  using C = F32Fwd<D>;
  constexpr int WGS = C::WGS, KT = C::KT, STG = F32F_STAGES, QT = C::QT, KVT = C::KVT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem), bar0 = base + C::BARS;
  // barriers, STG each but the first two: q_full | q_ready | k_full | k_ready
  // | k_empty | v_full | v_free | vt_ready | vt_empty; the K and V^T tiles
  // are freed as soon as their product is done, raw V once it is split, so
  // that the loads and the splits run a tile or more ahead of the products
  const uint32_t q_full = bar0, q_ready = bar0 + 8;
  auto bar = [&](int kind, int i) { return bar0 + 8 * (2 + kind * STG + i % STG); };
  enum { K_FULL, K_READY, K_EMPTY, V_FULL, V_FREE, VT_READY, VT_EMPTY, KINDS };
  // byte offsets of tile i's K (hi, then lo), raw V and V^T (hi, then lo)
  auto k_tile = [&](int i) { return C::KS + (i % STG) * 2 * KVT; };
  auto v_tile = [&](int i) { return C::VS + (i % STG) * KVT; };
  auto vt_tile = [&](int i) { return C::VTS + (i % STG) * 2 * KVT; };
  // the phase parity of tile i's use of its ring slot, and of the release
  // before it
  auto use = [&](int i) { return (i / STG) & 1; };
  auto freed = [&](int i) { return ((i / STG) & 1) ^ 1; };

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * 64 * WGS;
  const int nq = min(WGS, (n - q0 + 63) / 64);  // warpgroups with a query below n
  const int ntiles = (n + KT - 1) / KT;

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BARS);
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], F32F_SPLITTERS);
    const int counts[KINDS] = {1, F32F_SPLITTERS, 128 * nq, 1, F32F_SPLITTERS, F32F_SPLITTERS,
                               128 * nq};
    for (int kind = 0; kind < KINDS; ++kind)
      for (int s = 0; s < STG; ++s) mbar_init(&bars[2 + kind * STG + s], counts[kind]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    if constexpr (WGS > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS) : "memory");
    if (threadIdx.x == 0) {  // loader: the Q tiles, then K and V a tile at a time
      mbar_expect_tx(q_full, nq * QT);
      for (int w = 0; w < nq; ++w)
        tma_load_tile_f32<D>(base + w * 2 * QT, tq, q_full, 64, q0 + 64 * w, h, b);
      for (int i = 0; i < ntiles; ++i) {
        mbar_wait(bar(K_EMPTY, i), freed(i));
        mbar_expect_tx(bar(K_FULL, i), KVT);
        tma_load_tile_f32<D>(base + k_tile(i), *opaque(&tk), bar(K_FULL, i), KT, i * KT, h, b);
        mbar_wait(bar(V_FREE, i), freed(i));
        mbar_expect_tx(bar(V_FULL, i), KVT);
        tma_load_tile_f32<D>(base + v_tile(i), *opaque(&tv), bar(V_FULL, i), KT, i * KT, h, b);
      }
    } else if (threadIdx.x >= 32) {
      // splitters: Q, K into hi (in place) and lo halves, V into V^T's
      const int t = threadIdx.x - 32;
      mbar_wait(q_full, 0);
      for (int w = 0; w < nq; ++w)
        split_tile<true>(smem + w * 2 * QT, QT, QT, t, F32F_SPLITTERS);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(q_ready);
      for (int i = 0; i < ntiles; ++i) {
        mbar_wait(bar(K_FULL, i), use(i));
        split_tile<true>(smem + k_tile(i), KVT, KVT, t, F32F_SPLITTERS);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(bar(K_READY, i));
        mbar_wait(bar(V_FULL, i), use(i));
        mbar_wait(bar(VT_EMPTY, i), freed(i));
        split_vt<D, KT>(smem + v_tile(i), smem + vt_tile(i), KVT, t);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(bar(V_FREE, i));
        mbar_arrive(bar(VT_READY, i));
      }
    }
    return;
  }
  if constexpr (WGS > 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS) : "memory");

  const int cw = (threadIdx.x >> 7) - 1;  // consumer warpgroup: queries q0 + 64 cw ..
  if (cw >= nq) return;                   // all of them past n
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const uint32_t row0 = q0 + 64 * cw + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  const uint32_t seed_mix = DROPOUT ? static_cast<uint32_t>(seeds[bh]) * 0xC2B2AE3Du : 0u;
  const uint32_t rmix[2] = {row0 * 0x9E3779B1u, (row0 + 8) * 0x9E3779B1u};

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  float o[D / 2];  // element 4j + 2r + e: row row0 + 8r, column 8j + 2c + e
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;

  // the products of tile t, each issued as a wgmma group of its own:
  //   * S = Q K^T, 64 queries by the tile's keys, A and B from shared memory
  //     (Q's descriptors recomputed each time, not held in registers): the
  //     large products (hi hi) into sc, the two small ones into sc2, added
  //     on the CUDA cores, so that the accumulator, which does not round to
  //     nearest, truncates D / 8 times at the scores' magnitude, not 3 D / 8
  //     (the forward's error against float64 at (1, 257, 4, 64) from 2.7x
  //     plain float32's to 1.2x, for 1.3% more time);
  //   * P V into the fresh accumulator pv, P's hi and lo halves in phi, plo
  //     (A from registers) and V^T from shared memory, a wgmma a k8 slab and
  //     binary digit of D
  const uint32_t qh = opaque(base + cw * 2 * QT);
  float sc[KT / 2], sc2[KT / 2], pv[D / 2];
  uint32_t phi[KT / 8][4], plo[KT / 8][4];
  auto scores = [&](int t) {
    const uint32_t q = opaque(qh), kh = opaque(base + k_tile(t));
    mbar_wait(bar(K_READY, t), use(t));
    fence_regs(sc);
    fence_regs(sc2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wgmma_tf32_ss(sc2, slab_f32<D>(q + QT, 64, kk), slab_f32<D>(kh, KT, kk), kk == 0 ? 0 : 1);
      wgmma_tf32_ss(sc2, slab_f32<D>(q, 64, kk), slab_f32<D>(kh + KVT, KT, kk), 1);
      wgmma_tf32_ss(sc, slab_f32<D>(q, 64, kk), slab_f32<D>(kh, KT, kk), kk == 0 ? 0 : 1);
    }
    wgmma_commit();
  };
  auto values = [&](int t) {
    const uint32_t vh = opaque(base + vt_tile(t));
    mbar_wait(bar(VT_READY, t), use(t));
    fence_regs(pv);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
      static_for<Pieces<D>::COUNT>([&](auto pc) {
        constexpr int p = decltype(pc)::value;
        constexpr int W = Pieces<D>::width(p), C0 = Pieces<D>::first(p);
        float(&acc)[W / 2] = *reinterpret_cast<float(*)[W / 2]>(pv + C0 / 2);
        mma3_rs(acc, phi[j], plo[j], slab_f32<KT>(vh + C0 * 128, D, j),
                slab_f32<KT>(vh + KVT + C0 * 128, D, j), j == 0);
      });
    wgmma_commit();
  };
  // the weights in sc as the value product's A fragments, hi and lo: slab
  // j's column c is key 8j + 2c, column c + 4 key 8j + 2c + 1 (V^T's order)
  auto fragments = [&]() {
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      split_tf32_int(sc[4 * j], phi[j][0], plo[j][0]);
      split_tf32_int(sc[4 * j + 2], phi[j][1], plo[j][1]);
      split_tf32_int(sc[4 * j + 1], phi[j][2], plo[j][2]);
      split_tf32_int(sc[4 * j + 3], phi[j][3], plo[j][3]);
    }
  };
  // tile t's scores, once their products are done: summed, K's tile
  // released, and the online softmax over them
  float alpha[2], alpha_next[2];
  auto softmax = [&](int t, float(&a)[2]) {
    fence_regs(sc);
    fence_regs(sc2);
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sc[i] += sc2[i];
    mbar_arrive(bar(K_EMPTY, t));
    softmax_tile<DROPOUT>(sc, m_run, l_run, a, t * KT, n, c, scale_log2, rmix, seed_mix,
                          threshold, keep_scale);
  };
  // tile t's P V, once done, added to O (the rows rescaled by alpha) on the
  // CUDA cores, which round to nearest, and V^T's tile released
  auto accumulate = [&](int t) {
    fence_regs(pv);
    mbar_arrive(bar(VT_EMPTY, t));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
  };

  // tile t + 1's scores run on the tensor cores while tile t's value
  // product does, and its softmax while tile t's value product still runs
  mbar_wait(q_ready, 0);
  scores(0);
  wgmma_wait_all();
  softmax(0, alpha);
  for (int t = 0; t + 1 < ntiles; ++t) {
    fragments();
    scores(t + 1);
    values(t);
    wgmma_wait<1>();  // the scores
    softmax(t + 1, alpha_next);
    wgmma_wait_all();  // the value product
    accumulate(t);
    alpha[0] = alpha_next[0];
    alpha[1] = alpha_next[1];
  }
  fragments();
  values(ntiles - 1);
  wgmma_wait_all();
  accumulate(ntiles - 1);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < n) {
      const float inv = 1.0f / l_run[r];
      float* dst = out + (((long long)b * n + row) * H + h) * D + 2 * c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      if (lse != nullptr && c == 0)
        lse[(long long)bh * n + row] = (m_run[r] + log2f(l_run[r])) * LN2;
    }
  }
}

template <int D, bool DROPOUT>
int attention_forward_f32_at(const float* q, const float* k, const float* v, long long sb,
                             long long sn, long long sh, const int* seeds, float* out, float* lse,
                             int B, int n, int H, int d, unsigned int threshold, float keep_scale,
                             cudaStream_t s) {
  using C = F32Fwd<D>;
  static unsigned long long smem_set;
  TileMaps tq, tk, tv;
  if (!current_context() || !tile_maps_f32<D>(&tq, q, B, n, H, sb, sn, sh, 64) ||
      !tile_maps_f32<D>(&tk, k, B, n, H, sb, sn, sh, C::KT) ||
      !tile_maps_f32<D>(&tv, v, B, n, H, sb, sn, sh, C::KT))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = ensure_smem(attn_fwd_tf32_kernel<D, DROPOUT>, C::SMEM, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + 64 * C::WGS - 1) / (64 * C::WGS), B * H);
  attn_fwd_tf32_kernel<D, DROPOUT><<<grid, C::THREADS, C::SMEM, s>>>(
      tq, tk, tv, seeds, out, lse, n, H, LOG2E / sqrtf(static_cast<float>(d)), threshold,
      keep_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Head dims past 128: the 3xTF32 forward and backward kernels.
#include "attention_wide_f32.cuh"

namespace {

// The forward on `s` at head dim d >= 1 (else cudaErrorInvalidValue), the
// tensors at D = pad_head_dim(d); the arguments of
// mb_dropout_attention_fwd_f32. Past d = 128, attention_wide_f32.cuh's
// attn_fwd_wide_tf32_kernel.
int attention_forward_f32(const float* q, const float* k, const float* v, long long sb,
                          long long sn, long long sh, const int* seeds, float* out, float* lse,
                          int B, int n, int H, int d, unsigned int threshold, float keep_scale,
                          bool dropout, cudaStream_t s) {
  if (d >= WIDE_MIN_D)
    return dropout ? attention_forward_wide_f32<true>(q, k, v, sb, sn, sh, seeds, out, lse, B, n,
                                                      H, d, threshold, keep_scale, s)
                   : attention_forward_wide_f32<false>(q, k, v, sb, sn, sh, nullptr, out, lse, B,
                                                       n, H, d, 0u, 1.0f, s);
  switch (d < 1 ? 0 : pad_head_dim(d)) {
#define MB_F32_FWD_CASE(W)                                                                  \
  case W:                                                                                  \
    return dropout ? attention_forward_f32_at<W, true>(q, k, v, sb, sn, sh, seeds, out, lse, \
                                                       B, n, H, d, threshold, keep_scale, s) \
                   : attention_forward_f32_at<W, false>(q, k, v, sb, sn, sh, nullptr, out,   \
                                                        lse, B, n, H, d, 0u, 1.0f, s);
    MB_HEAD_DIMS(MB_F32_FWD_CASE)
#undef MB_F32_FWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------- the projections ----

constexpr int PT_BM = 128, PT_BN = 128, PT_BK = 32;  // a block's tile; k per stage (128 B)
constexpr int PT_STAGES = 4;
constexpr int PT_CONSUMERS = 256;                     // two consumer warpgroups
constexpr int PT_THREADS = 128 + PT_CONSUMERS;        // and a producer warpgroup
constexpr int PT_PRODUCER_REGS = 40, PT_CONSUMER_REGS = 232;
constexpr int PT_A_BYTES = PT_BM * PT_BK * 4;         // 16 KB: raw A
constexpr int PT_B_BYTES = PT_BN * PT_BK * 4;         // 16 KB: W_hi, then W_lo
constexpr int PT_STAGE_BYTES = PT_A_BYTES + 2 * PT_B_BYTES;
constexpr int PT_BARS = PT_STAGES * PT_STAGE_BYTES;
constexpr int PT_SMEM = PT_BARS + 128 + 1024;
enum { EPI_BIAS = 0, EPI_RESID = 1 };

// C[M, N] = A[M, K] W[N, K]^T in 3xTF32, then by EPI:
//   EPI_BIAS:  c = C + bias
//   EPI_RESID: c = (C + bias) + resid, resid (M, N) f32
// f32 output (row stride N); bias bf16 where bias_bf16 is set, else f32.
// ta: A's map, tbh and tbl: W_hi's and W_lo's, (32 x 128) boxes, 128-byte
// swizzle; columns past K and rows past M or N arrive as zeros. Requires
// K % 4 == 0 and N % 2 == 0.
template <int EPI>
__global__ void __launch_bounds__(PT_THREADS, 1)
proj_tf32_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tbh,
                 const __grid_constant__ CUtensorMap tbl, const void* __restrict__ bias,
                 int bias_bf16, const float* __restrict__ resid, float* __restrict__ c, int M,
                 int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + PT_BARS);
  uint64_t* empty = full + PT_STAGES;
  auto a_stage = [&](int s) { return smem + s * PT_STAGE_BYTES; };

  const int n0 = blockIdx.x * PT_BN;
  const int m0 = blockIdx.y * PT_BM;
  const int ktiles = (K + PT_BK - 1) / PT_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < PT_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PT_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PT_PRODUCER_REGS) : "memory");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % PT_STAGES;
        mbar_wait(&empty[s], ((kt / PT_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], PT_STAGE_BYTES);
        tma_load_2d(a_stage(s), &ta, &full[s], kt * PT_BK, m0);
        tma_load_2d(a_stage(s) + PT_A_BYTES, &tbh, &full[s], kt * PT_BK, n0);
        tma_load_2d(a_stage(s) + PT_A_BYTES + PT_B_BYTES, &tbl, &full[s], kt * PT_BK, n0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(PT_CONSUMER_REGS) : "memory");

  const int cw = (threadIdx.x >> 7) - 1;  // consumer warpgroup: rows 64 cw.. of the tile
  const int wtid = threadIdx.x & 127;
  const int warp = wtid >> 5;
  const int lane = wtid & 31;
  const int g = lane >> 2;
  const int cc = lane & 3;
  const int arow = 64 * cw + 16 * warp + g;  // this thread's A rows: arow, arow + 8

  // acc: the wgmma sum of one stage (32 of K); sum: the stages' sums, added
  // on the CUDA cores, which round to nearest where the tensor cores'
  // accumulation does not: a sum that stays in the wgmma accumulator over
  // all of K loses accuracy with K's length
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % PT_STAGES;
    mbar_wait(&full[s], (kt / PT_STAGES) & 1);
    const uint8_t* as = a_stage(s);
    // this warpgroup's A fragments of the stage's four k8 slabs, split in
    // registers (the stage is 128-byte swizzled: 16-byte chunk j of row r at
    // j ^ (r & 7), and r & 7 = g)
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = arow + 8 * (i & 1), chunk = 2 * kk + (i >> 1);
        split_tf32(*reinterpret_cast<const float*>(as + row * 128 + ((chunk ^ g) << 4) + 4 * cc),
                   ahi[kk][i], alo[kk][i]);
      }
    const uint32_t bh = smem_u32(as + PT_A_BYTES), bl = bh + PT_B_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma3_rs(acc, ahi[kk], alo[kk], smem_desc(bh + 32 * kk, 128, false),
              smem_desc(bl + 32 * kk, 128, false), kk == 0);
    wgmma_commit();
    wgmma_wait_all();  // the fragments' registers and the stage are free again
    fence_regs(acc);
    mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  }

  // sum's element i = 4j + 2r + e: row 16 warp + g + 8r of the
  // warpgroup's 64, column 8j + 2cc + e
  const bool b16 = bias_bf16 != 0;
#pragma unroll
  for (int j = 0; j < PT_BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * cc;
    if (col >= N) continue;
    const float b0 = ld_vec(bias, b16, col), b1 = ld_vec(bias, b16, col + 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + arow + 8 * r;
      if (row >= M) continue;
      const long long o = (long long)row * N + col;
      float2 v = make_float2(sum[4 * j + 2 * r] + b0, sum[4 * j + 2 * r + 1] + b1);
      if (EPI == EPI_RESID) {
        const float2 x = *reinterpret_cast<const float2*>(resid + o);
        v.x += x.x;
        v.y += x.y;
      }
      *reinterpret_cast<float2*>(c + o) = v;
    }
  }
}

// W (N, K) f32 -> W_hi, W_lo (N, K) each at `split` (W_hi first).
cudaError_t launch_split(const float* w, float* split, long long elems, cudaStream_t s) {
  const long long n4 = elems / 4;
  const unsigned blocks = static_cast<unsigned>(std::min<long long>((n4 + 255) / 256, 132 * 8));
  split_tf32_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(w),
                                          reinterpret_cast<float4*>(split),
                                          reinterpret_cast<float4*>(split + elems), n4);
  return cudaGetLastError();
}

// One projection on `s`: C = A (M, K) W (N, K)^T with the epilogue EPI,
// from W's halves at `w_split` (launch_split's layout).
template <int EPI>
cudaError_t launch_proj_tf32(const float* a, const float* w_split, const void* bias, int bias_bf16,
                             const float* resid, float* c, int M, int N, int K, cudaStream_t s) {
  static unsigned long long smem_set;
  CUtensorMap ta, tbh, tbl;
  const long long welems = static_cast<long long>(N) * K;
  if (!matrix_map(&ta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a, M, K, PT_BK, PT_BM) ||
      !matrix_map(&tbh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w_split, N, K, PT_BK, PT_BN) ||
      !matrix_map(&tbl, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w_split + welems, N, K, PT_BK, PT_BN))
    return cudaErrorInvalidValue;
  cudaError_t err = ensure_smem(proj_tf32_kernel<EPI>, PT_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + PT_BN - 1) / PT_BN, (M + PT_BM - 1) / PT_BM);
  proj_tf32_kernel<EPI><<<grid, PT_THREADS, PT_SMEM, s>>>(ta, tbh, tbl, bias, bias_bf16, resid, c,
                                                          M, N, K);
  return cudaGetLastError();
}

// ------------------------------------------------------------ backward ----

// Per (b, row, h), row over the padded length n_pad: stats[bh, row] =
// (lse * log2e, rowsum(g * out)) in f32, (0, 0) past n; one warp per row.
// The grid's first `num_tickets` threads also zero the dq tickets.
template <int D>
__global__ void __launch_bounds__(128)
attn_bwd_prep_f32_kernel(const float* __restrict__ out, const float* __restrict__ grad,
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
  for (int d = lane; d < D; d += 32) s = fmaf(out[e + d], grad[e + d], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) stats[bh * n_pad + row] = make_float2(lse[bh * n + row] * LOG2E, s);
}

// The f32 box at (d0, row, h, b) of a rank-4 (d, n, h, b) map = or += the
// swizzled box at src (shared memory), by the TMA unit, in the calling
// thread's bulk group. Rows past n are not written.
__device__ __forceinline__ void tma_store_box4(const CUtensorMap* map, const void* src, int d0,
                                               int row, int h, int b, bool add) {
  if (add)
    asm volatile(
        "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group [%0, {%2, %3, %4, %5}], "
        "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(d0), "r"(row), "r"(h), "r"(b)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
            "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(d0), "r"(row), "r"(h), "r"(b)
        : "memory");
}

// The backward's plan by head dim D (see the header): queries a step, m64
// blocks over d, tile sizes, the ring's stages STG and dQ-part buffers NB,
// blocks an SM, and the shared-memory layout.
// The backward's shared memory at head dim D with NQ queries a step, stg
// stages of the ring and nb dQ-part buffers (the layout in F32Bwd), and
// whether two such blocks fit an SM (228 KB, 1 KB reserved for each).
constexpr int f32bwd_bytes(int D, int NQ, int stg, int nb) {
  return 4 * 64 * D * 4 + 4 * 64 * NQ * 4 + 2 * NQ * 64 * 4 + 128 + 1024 +
         stg * (4 * NQ * D * 4 + NQ * 8) + nb * NQ * D * 4;
}
constexpr bool f32bwd_two(int D, int NQ, int stg, int nb) {
  return 2 * (f32bwd_bytes(D, NQ, stg, nb) + 1024) <= 228 * 1024;
}

// The backward's tuning, by head dim, each the fastest of the variants
// compared on the card (copies of this file with other values, timed side by
// side at (32, 257, h, D)) whose ptxas report has no spill:
//   NQ32_MAX_D: up to this D a step takes 32 queries, past it 16. At D = 64,
//     16-query steps let two blocks share an SM (109 KB each, against one
//     block of 194 KB with 32): 0.87 against 0.97 ms; at D = 16 and 32, 32
//     queries were as fast or faster; at 48, 16 (two blocks) and 32 (one)
//     ran 0.24 and 0.25 ms;
//   KT_REGS_MIN_D: from this D on, where d fits one m64 block, each consumer
//     keeps the dQ product's K^T fragments (64 registers) across the steps
//     instead of loading them from shared memory every step: 0.78 against
//     0.87 ms at D = 64 and 0.20 against 0.24 at 48; at D = 16 and 32 it
//     cost 10%;
//   PRODUCER_REGS_PANELS: the producer warpgroup's registers (with two
//     blocks an SM) where a tile has a 16-wide panel; 40 spilled 4 bytes at
//     D = 48 (48 and 56 did not; 56 ran 8% slower there).
constexpr int NQ32_MAX_D = 32, KT_REGS_MIN_D = 48, PRODUCER_REGS_PANELS = 48;

template <int D>
struct F32Bwd {
  static constexpr int NQ = D <= NQ32_MAX_D ? 32 : 16;  // queries a step
  static constexpr int SUBS = 64 / NQ;          // steps a 64-query tile
  static constexpr int MB = (D + 63) / 64;      // m64 blocks over d
  static constexpr bool KT_RESIDENT = MB == 1 && D >= KT_REGS_MIN_D;
  static constexpr int KV = 64 * D * 4;         // a (64 keys x D) tile
  static constexpr int QG = NQ * D * 4;         // a (NQ x D) tile
  static constexpr int PT = 64 * NQ * 4;        // a [key][query] tile
  static constexpr int DSQ = NQ * 64 * 4;       // the [query][key] tile
  // two blocks an SM where some ring allows it (most stages and buffers
  // first), else one block with the largest ring that fits
  static constexpr int PICK = f32bwd_two(D, NQ, 2, 2)                         ? 22
                              : f32bwd_two(D, NQ, 2, 1)                       ? 21
                              : f32bwd_two(D, NQ, 1, 1)                       ? 11
                              : f32bwd_bytes(D, NQ, 2, 2) <= F32_SMEM_LIMIT ? 22
                              : f32bwd_bytes(D, NQ, 2, 1) <= F32_SMEM_LIMIT ? 21
                                                                            : 11;
  static constexpr int STG = PICK / 10, NB = PICK % 10;
  static constexpr int BLOCKS = f32bwd_two(D, NQ, STG, NB) ? 2 : 1;
  static constexpr int SMEM = f32bwd_bytes(D, NQ, STG, NB);
  static_assert(SMEM <= F32_SMEM_LIMIT, "shared memory");
  // K_hi K_lo V_hi V_lo | {Q_hi Q_lo G_hi G_lo}[STG] | dropped^T hi, lo | dS^T
  // hi, lo | dS hi, lo | dQ part[NB] | stats[STG] | barriers
  static constexpr int K = 0, V = 2 * KV, RING = 4 * KV;
  static constexpr int PTS = RING + STG * 4 * QG, DSTS = PTS + 2 * PT, DSS = DSTS + 2 * PT;
  static constexpr int PART = DSS + 2 * DSQ;
  static constexpr int STATS = PART + NB * QG;
  static constexpr int BARS = STATS + STG * NQ * 8;
  // setmaxnreg with two blocks: the producer warpgroup's registers to the
  // consumers (65536 / 512 = 128 a thread at launch); one block runs at 255
  static constexpr int PRODUCER_REGS = F32Panels<D>::HAS16 ? PRODUCER_REGS_PANELS : 40;
  static constexpr int CONSUMER_REGS = 2 * 128 - PRODUCER_REGS;
};

constexpr int F32B_CONSUMERS = 128;
constexpr int F32B_THREADS = F32B_CONSUMERS + 128;  // and loader, dQ, two splitter warps
constexpr int F32B_SPLITTERS = 64;

// tq, tg: Q's and G's maps of NQ-row boxes; tk, tv: K's and V's of 64-row
// boxes; tdq: dq's, NQ-row boxes.
template <int D>
__global__ void __launch_bounds__(F32B_THREADS, F32Bwd<D>::BLOCKS)
attn_bwd_tf32_kernel(const __grid_constant__ TileMaps tq, const __grid_constant__ TileMaps tk,
                     const __grid_constant__ TileMaps tv, const __grid_constant__ TileMaps tg,
                     const __grid_constant__ TileMaps tdq, const float2* __restrict__ stats,
                     const int* __restrict__ seeds, int* __restrict__ tickets,
                     float* __restrict__ dk, float* __restrict__ dv, int n, int H, int n_pad,
                     int rotate, float scale, float scale_log2, uint32_t threshold,
                     float keep_scale) {
  using C = F32Bwd<D>;
  constexpr int NQ = C::NQ, STG = C::STG, NB = C::NB, MB = C::MB, KV = C::KV, QG = C::QG;
  constexpr int PT = C::PT, DSQ = C::DSQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t base = smem_u32(smem), bar0 = base + C::BARS;
  // barriers: kv_full | kv_ready | full[STG] | ready[STG] | empty[STG] |
  // dq_full[NB] | dq_empty[NB]
  auto kv_full = [&]() { return bar0; };
  auto kv_ready = [&]() { return bar0 + 8; };
  auto full = [&](int s) { return bar0 + 8 * (2 + s); };
  auto ready = [&](int s) { return bar0 + 8 * (2 + STG + s); };
  auto empty = [&](int s) { return bar0 + 8 * (2 + 2 * STG + s); };
  auto dq_full = [&](int s) { return bar0 + 8 * (2 + 3 * STG + s); };
  auto dq_empty = [&](int s) { return bar0 + 8 * (2 + 3 * STG + NB + s); };
  auto q_tile = [&](int s) { return C::RING + s * 4 * QG; };  // byte offsets: Q_hi, then
  auto g_tile = [&](int s) { return C::RING + s * 4 * QG + 2 * QG; };  // G_hi, each lo after it

  const int kt = blockIdx.x;
  const int ntiles = gridDim.x;
  const int steps = ntiles * C::SUBS;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = kt * 64;

  if (threadIdx.x == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BARS);
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], F32B_SPLITTERS);
    for (int s = 0; s < STG; ++s) {
      mbar_init(&bars[2 + s], 1);
      mbar_init(&bars[2 + STG + s], F32B_SPLITTERS);
      mbar_init(&bars[2 + 2 * STG + s], F32B_CONSUMERS);
    }
    for (int s = 0; s < NB; ++s) {
      mbar_init(&bars[2 + 3 * STG + s], F32B_CONSUMERS);
      mbar_init(&bars[2 + 3 * STG + NB + s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= F32B_CONSUMERS) {
    if constexpr (C::BLOCKS > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS) : "memory");
    const int pt = threadIdx.x - F32B_CONSUMERS;
    if (pt == 0) {  // loader: K and V once, then Q, G and the row stats of each step
      mbar_expect_tx(kv_full(), 2 * KV);
      tma_load_tile_f32<D>(base + C::K, tk, kv_full(), 64, k0, h, b);
      tma_load_tile_f32<D>(base + C::V, tv, kv_full(), 64, k0, h, b);
      for (int i = 0; i < steps; ++i) {
        const int s = i % STG;
        const int it = i / C::SUBS;
        const int q0 = (rotate ? (kt + it) % ntiles : it) * 64 + (i % C::SUBS) * NQ;
        mbar_wait(empty(s), ((i / STG) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * QG + NQ * 8);
        tma_load_tile_f32<D>(base + q_tile(s), *opaque(&tq), full(s), NQ, q0, h, b);
        tma_load_tile_f32<D>(base + g_tile(s), *opaque(&tg), full(s), NQ, q0, h, b);
        bulk_load(base + C::STATS + s * NQ * 8, stats + (long long)bh * n_pad + q0, NQ * 8,
                  full(s));
      }
    } else if (pt == 32) {
      // dQ warp: adds each step's dQ part to dq in device memory, in the
      // query tile's fixed order (its first key tile's parts are stored)
      for (int i = 0; i < steps; ++i) {
        const int it = i / C::SUBS, sub = i % C::SUBS;
        const int qt = rotate ? (kt + it) % ntiles : it;
        const int order = rotate ? it : kt;
        int* ticket = tickets + (long long)bh * ntiles + qt;
        mbar_wait(dq_full(i % NB), (i / NB) & 1);
        if (sub == 0 && order > 0)
          while (ld_acquire(ticket) != order) {
          }
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        const TileMaps* maps = opaque(&tdq);
        const uint8_t* part = smem + C::PART + (i % NB) * QG;
#pragma unroll
        for (int p = 0; p < F32Panels<D>::COUNT; ++p)
          tma_store_box4(&maps->box[p < F32Panels<D>::WIDE ? 0 : 1],
                         part + NQ * F32Panels<D>::col(p) * 4, F32Panels<D>::col(p),
                         qt * 64 + sub * NQ, h, b, order > 0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        if (sub == C::SUBS - 1) {  // the tile's last part: release the ticket once it landed
          asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          st_release(ticket, order + 1);
        } else {
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        mbar_arrive(dq_empty(i % NB));
      }
    } else if (pt >= 64) {
      // splitters: each arrived raw tile into its hi half (in place) and lo
      // half, ahead of the consumers
      const int t = pt - 64;
      mbar_wait(kv_full(), 0);
      split_tile(smem + C::K, KV, KV, t, F32B_SPLITTERS);
      split_tile(smem + C::V, KV, KV, t, F32B_SPLITTERS);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(kv_ready());
      for (int i = 0; i < steps; ++i) {
        const int s = i % STG;
        mbar_wait(full(s), (i / STG) & 1);
        split_tile(smem + q_tile(s), QG, QG, t, F32B_SPLITTERS);
        split_tile(smem + g_tile(s), QG, QG, t, F32B_SPLITTERS);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(ready(s));
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

  // dV^T and dK^T: (d x 64 keys), a m64n64 accumulator per 64 rows of d
  float dv_acc[MB][32], dk_acc[MB][32];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv_acc[mb][i] = dk_acc[mb][i] = 0.0f;

  mbar_wait(kv_ready(), 0);
  // the dQ product's K^T fragments, held across the steps (KT_RESIDENT)
  uint32_t kthi[C::KT_RESIDENT ? 8 : 1][4], ktlo[C::KT_RESIDENT ? 8 : 1][4];
  if constexpr (C::KT_RESIDENT) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      afrag_t<D>(kthi[kk], ktlo[kk], smem + C::K, KV, 64, kk, 0, warp, g, c, D);
  }

  for (int i = 0; i < steps; ++i) {
    const int s = i % STG;
    const int it = i / C::SUBS;
    const int q0 = (rotate ? (kt + it) % ntiles : it) * 64 + (i % C::SUBS) * NQ;
    mbar_wait(ready(s), (i / STG) & 1);
    const uint32_t kb = opaque(base), qb = opaque(base + q_tile(s)), gb = base + g_tile(s);
    const float2* stq = reinterpret_cast<const float2*>(smem + C::STATS + s * NQ * 8);

    // S^T = K Q^T and dP^T = V G^T: keys as rows, NQ queries as columns
    float sc[NQ / 2], dp[NQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      mma3_ss(sc, slab_f32<D>(kb + C::K, 64, kk), slab_f32<D>(kb + C::K + KV, 64, kk),
              slab_f32<D>(qb, NQ, kk), slab_f32<D>(qb + QG, NQ, kk), kk == 0);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      mma3_ss(dp, slab_f32<D>(kb + C::V, 64, kk), slab_f32<D>(kb + C::V + KV, 64, kk),
              slab_f32<D>(gb, NQ, kk), slab_f32<D>(gb + QG, NQ, kk), kk == 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // element i = 4j + 2r + e: key key0 + 8r, query q0 + 8j + 2c + e
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = 8 * j + 2 * c + e;
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
          sc[idx] = keep ? p * keep_scale : 0.0f;    // dropped weights, for dV
          dp[idx] = p * (dw - lse_delta.y) * scale;  // score gradient, for dK and dQ
        }
      }

    // the dropped weights and dS^T as [key][query] tiles, dS as [query][key],
    // hi and lo halves, as the products' K-major B operands
    consumer_sync();  // every warp is done with the previous step's products
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kr = warp * 16 + g + 8 * r;  // key row within the tile
        const int off = F32Panels<NQ>::offset(64, kr, 8 * j + 2 * c);
        uint32_t h0, l0, h1, l1;
        split_tf32(sc[4 * j + 2 * r], h0, l0);
        split_tf32(sc[4 * j + 2 * r + 1], h1, l1);
        *reinterpret_cast<uint2*>(smem + C::PTS + off) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(smem + C::PTS + PT + off) = make_uint2(l0, l1);
        split_tf32(dp[4 * j + 2 * r], h0, l0);
        split_tf32(dp[4 * j + 2 * r + 1], h1, l1);
        *reinterpret_cast<uint2*>(smem + C::DSTS + off) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(smem + C::DSTS + PT + off) = make_uint2(l0, l1);
        const int o0 = F32Panels<64>::offset(NQ, 8 * j + 2 * c, kr);
        const int o1 = F32Panels<64>::offset(NQ, 8 * j + 2 * c + 1, kr);
        *reinterpret_cast<uint32_t*>(smem + C::DSS + o0) = h0;
        *reinterpret_cast<uint32_t*>(smem + C::DSS + DSQ + o0) = l0;
        *reinterpret_cast<uint32_t*>(smem + C::DSS + o1) = h1;
        *reinterpret_cast<uint32_t*>(smem + C::DSS + DSQ + o1) = l1;
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();

    // dV^T += G^T dropped^T and dK^T += Q^T dS^T over this step's queries:
    // A from registers (G and Q read transposed), a wgmma per k8 slab and
    // 64 rows of d
    {
      uint32_t ghi[MB][NQ / 8][4], glo[MB][NQ / 8][4], qhi[MB][NQ / 8][4], qlo[MB][NQ / 8][4];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int kk = 0; kk < NQ / 8; ++kk) {
          afrag_t<D>(ghi[mb][kk], glo[mb][kk], smem + g_tile(s), QG, NQ, kk, 64 * mb, warp, g, c,
                     D - 64 * mb);
          afrag_t<D>(qhi[mb][kk], qlo[mb][kk], smem + q_tile(s), QG, NQ, kk, 64 * mb, warp, g, c,
                     D - 64 * mb);
        }
      const uint32_t pts = opaque(base + C::PTS), dsts = pts + 2 * PT;
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        fence_regs(dv_acc[mb]);
        fence_regs(dk_acc[mb]);
      }
      wgmma_fence();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int kk = 0; kk < NQ / 8; ++kk) {
          mma3_rs(dv_acc[mb], ghi[mb][kk], glo[mb][kk], slab_f32<NQ>(pts, 64, kk),
                  slab_f32<NQ>(pts + PT, 64, kk), false);
          mma3_rs(dk_acc[mb], qhi[mb][kk], qlo[mb][kk], slab_f32<NQ>(dsts, 64, kk),
                  slab_f32<NQ>(dsts + PT, 64, kk), false);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        fence_regs(dv_acc[mb]);
        fence_regs(dk_acc[mb]);
      }
    }
    mbar_arrive(empty(s));  // Q, G and the stats of stage s are no longer read

    // dQ^T part = K^T dS over the tile's 64 keys, a m64 block of d at a
    // time, into the part buffer as dQ's [query][d] box layout
    const int pb = i % NB;
    mbar_wait(dq_empty(pb), ((i / NB) & 1) ^ 1);
    uint8_t* part = smem + C::PART + pb * QG;
    const uint32_t dss = opaque(base + C::DSS);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      float dqp[NQ / 2];
      if constexpr (C::KT_RESIDENT) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          mma3_rs(dqp, kthi[kk], ktlo[kk], slab_f32<64>(dss, NQ, kk),
                  slab_f32<64>(dss + DSQ, NQ, kk), kk == 0);
      } else {
        uint32_t khi[8][4], klo[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          afrag_t<D>(khi[kk], klo[kk], smem + C::K, KV, 64, kk, 64 * mb, warp, g, c, D - 64 * mb);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          mma3_rs(dqp, khi[kk], klo[kk], slab_f32<64>(dss, NQ, kk),
                  slab_f32<64>(dss + DSQ, NQ, kk), kk == 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dqp);
      // element 4j + 2r + e: d row 64 mb + 16 warp + g + 8r, query 8j + 2c + e
      const int dd = 64 * mb + 16 * warp + g;
      if (dd < D) {
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<float*>(part + F32Panels<D>::offset(NQ, 8 * j + 2 * c + e,
                                                                    dd + 8 * r)) =
                  dqp[4 * j + 2 * r + e];
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(dq_full(pb));
  }

  // dK^T and dV^T: element 4j + 2r + e is d row 64 mb + 16 warp + g + 8r,
  // key 8j + 2c + e of the tile
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const int dd = 64 * mb + 16 * warp + g;
    if (dd >= D) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * c + e;
        if (key >= n) continue;
        const long long o = (((long long)b * n + key) * H + h) * D + dd;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dk[o + 8 * r] = dk_acc[mb][4 * j + 2 * r + e];
          dv[o + 8 * r] = dv_acc[mb][4 * j + 2 * r + e];
        }
      }
  }
}

// The two launches at head dim D = pad_head_dim(d); the arguments of
// mb_dropout_attention_bwd_f32.
template <int D>
int attention_backward_f32_at(const float* q, const float* k, const float* v, long long sb,
                              long long sn, long long sh, const float* out, const float* grad,
                              const float* lse, const int* seeds, float* dq, float* dk, float* dv,
                              float2* stats, int* tickets, int B, int n, int H, int d, int rotate,
                              unsigned int threshold, float keep_scale, cudaStream_t s) {
  using C = F32Bwd<D>;
  const int ntiles = (n + 63) / 64;
  const int n_pad = ntiles * 64;
  TileMaps tq, tk, tv, tg, tdq;
  const long long gn = static_cast<long long>(H) * D;
  if (!current_context() || !tile_maps_f32<D>(&tq, q, B, n, H, sb, sn, sh, C::NQ) ||
      !tile_maps_f32<D>(&tk, k, B, n, H, sb, sn, sh, 64) ||
      !tile_maps_f32<D>(&tv, v, B, n, H, sb, sn, sh, 64) ||
      !tile_maps_f32<D>(&tg, grad, B, n, H, gn * n, gn, D, C::NQ) ||
      !tile_maps_f32<D>(&tdq, dq, B, n, H, gn * n, gn, D, C::NQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * n_pad * H;
  const int num_tickets = B * H * ntiles;
  attn_bwd_prep_f32_kernel<D><<<static_cast<unsigned>((rows * 32 + 127) / 128), 128, 0, s>>>(
      out, grad, lse, stats, tickets, n, n_pad, H, rows, num_tickets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  static unsigned long long smem_set;
  if ((err = ensure_smem(attn_bwd_tf32_kernel<D>, C::SMEM, smem_set)) != cudaSuccess)
    return static_cast<int>(err);
  attn_bwd_tf32_kernel<D><<<dim3(ntiles, B * H), F32B_THREADS, C::SMEM, s>>>(
      tq, tk, tv, tg, tdq, stats, seeds, tickets, dk, dv, n, H, n_pad, rotate, scale,
      scale * LOG2E, threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward on `stream`, float32: the arguments of mb_dropout_attention_fwd
// (csrc/dropout_attention.cu) with q, k, v, out f32.
extern "C" int mb_dropout_attention_fwd_f32(const void* q, const void* k, const void* v,
                                            long long sb, long long sn, long long sh,
                                            const void* seeds, void* out, void* lse, int B,
                                            int n, int H, int d, unsigned int threshold,
                                            float keep_scale, int dropout, void* stream) {
  return attention_forward_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), sb, sn, sh,
                               static_cast<const int*>(seeds), static_cast<float*>(out),
                               static_cast<float*>(lse), B, n, H, d, threshold, keep_scale,
                               dropout != 0, static_cast<cudaStream_t>(stream));
}

// Backward on `stream`, float32, at head dim d >= 1: dq, dk, dv
// (contiguous (B, n, H, D) f32, D = d rounded up to 16) from q, k, v
// (strided as in the forward), the forward's out and lse, the incoming
// gradient grad (contiguous f32; q, k, v, out and grad zero past d) and the
// seeds. Scratch: stats, (B*H, n_pad) float2 with n_pad = 64 * ceil(n /
// 64); up to d = 128 tickets, (B*H, n_pad / 64) int32 (past 128 not read,
// may be null). rotate: 1 for the rotated dq order, 0 for key-tile order
// (the header). Two launches: the row stats (and the tickets zeroed), then
// the main kernel, which sums dq into dq itself; past d = 128 three, the
// row stats, dK and dV, and dQ (attention_wide_f32.cuh). Returns the first
// launch error (cudaSuccess == 0), or cudaErrorInvalidValue if d < 1 or a
// tensor map is refused.
extern "C" int mb_dropout_attention_bwd_f32(const void* q, const void* k, const void* v,
                                            long long sb, long long sn, long long sh,
                                            const void* out, const void* grad, const void* lse,
                                            const void* seeds, void* dq, void* dk, void* dv,
                                            void* stats, void* tickets, int B, int n, int H,
                                            int d, int rotate, unsigned int threshold,
                                            float keep_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d >= WIDE_MIN_D)
    return attention_backward_wide_f32(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        sb, sn, sh, static_cast<const float*>(out), static_cast<const float*>(grad),
        static_cast<const float*>(lse), static_cast<const int*>(seeds), static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float2*>(stats), B, n, H, d,
        threshold, keep_scale, s);
  switch (d < 1 ? 0 : pad_head_dim(d)) {
#define MB_F32_BWD_CASE(W)                                                                     \
  case W:                                                                                     \
    return attention_backward_f32_at<W>(                                                      \
        static_cast<const float*>(q), static_cast<const float*>(k),                           \
        static_cast<const float*>(v), sb, sn, sh, static_cast<const float*>(out),             \
        static_cast<const float*>(grad), static_cast<const float*>(lse),                      \
        static_cast<const int*>(seeds), static_cast<float*>(dq), static_cast<float*>(dk),     \
        static_cast<float*>(dv), static_cast<float2*>(stats), static_cast<int*>(tickets), B,  \
        n, H, d, rotate, threshold, keep_scale, s);
    MB_HEAD_DIMS(MB_F32_BWD_CASE)
#undef MB_F32_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The float32 forward's plan at head dim d (a multiple of 16 in [16, 128]),
// for the build's report: plan[0..2] = shared memory, consumer warpgroups
// (64 queries each) a block, keys a tile. Returns cudaErrorInvalidValue for
// another d.
extern "C" int mb_attention_fwd_f32_plan(int d, int* plan) {
  switch (d) {
#define MB_F32_FWD_PLAN_CASE(W) \
  case W:                       \
    plan[0] = F32Fwd<W>::SMEM;  \
    plan[1] = F32Fwd<W>::WGS;   \
    plan[2] = F32Fwd<W>::KT;    \
    return 0;
    MB_HEAD_DIMS(MB_F32_FWD_PLAN_CASE)
#undef MB_F32_FWD_PLAN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The float32 backward's plan at head dim d (a multiple of 16 in [16,
// 128]), for the build's report: plan[0..4] = shared memory, blocks an SM,
// queries a step, Q and G stages, dQ-part buffers. Returns
// cudaErrorInvalidValue for another d.
extern "C" int mb_attention_bwd_f32_plan(int d, int* plan) {
  switch (d) {
#define MB_F32_PLAN_CASE(W)      \
  case W:                        \
    plan[0] = F32Bwd<W>::SMEM;   \
    plan[1] = F32Bwd<W>::BLOCKS; \
    plan[2] = F32Bwd<W>::NQ;     \
    plan[3] = F32Bwd<W>::STG;    \
    plan[4] = F32Bwd<W>::NB;     \
    return 0;
    MB_HEAD_DIMS(MB_F32_PLAN_CASE)
#undef MB_F32_PLAN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The attention block on `stream`, float32, at width E over H heads of d =
// E / H (any d >= 1), every tensor at the padded widths of the bf16 block
// (mb_attention_block in csrc/attention_block.cu: D = d rounded up to 16,
// E_pad = E rounded up to 8, Eq = H D): x, out (B*n, E_pad) f32; w_qkv (3
// Eq, E_pad) and w_o (E_pad, Eq) f32, PyTorch's (out, in) layout; b_qkv (3
// Eq), b_o (E_pad), ln_g, ln_b (E) f32, or bf16 where bits 0, 1, 2, 3 of
// vec_bf16 are set. Scratch, allocated by the caller: qkv (B*n, 3 Eq), attn
// (B*n, Eq), y (B*n, E_pad), w_split (2 (3 Eq + E_pad) Eq... as two
// halves of each weight: w_qkv's hi and lo, then w_o's), f32. Returns the
// first launch error (cudaSuccess == 0), or cudaErrorInvalidValue if an
// argument or a tensor map is refused.
extern "C" int mb_attention_block_f32(const void* x, const void* w_qkv, const void* b_qkv,
                                      const void* w_o, const void* b_o, const void* ln_g,
                                      const void* ln_b, int vec_bf16, void* qkv, void* attn,
                                      void* y, void* out, void* w_split, int B, int n, int E,
                                      int H, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * n;
  if (H <= 0 || E <= 0 || E % H || !current_context())
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = E / H, D = pad_head_dim(d), Eq = H * D, E_pad = (E + 7) / 8 * 8;
  const float* xf = static_cast<const float*>(x);
  float* qf = static_cast<float*>(qkv);
  float* wqkv_split = static_cast<float*>(w_split);
  float* wo_split = wqkv_split + 2LL * 3 * Eq * E_pad;
  cudaError_t err;
  if ((err = launch_split(static_cast<const float*>(w_qkv), wqkv_split, 3LL * Eq * E_pad, s)) !=
          cudaSuccess ||
      (err = launch_split(static_cast<const float*>(w_o), wo_split, 1LL * E_pad * Eq, s)) !=
          cudaSuccess ||
      (err = launch_proj_tf32<EPI_BIAS>(xf, wqkv_split, b_qkv, vec_bf16 & 1, nullptr, qf, M,
                                        3 * Eq, E_pad, s)) != cudaSuccess)
    return static_cast<int>(err);
  const long long row = 3LL * Eq;  // the qkv buffer as (B, n, 3, H, D)
  const int aerr = attention_forward_f32(qf, qf + Eq, qf + 2 * Eq, row * n, row, D, nullptr,
                                         static_cast<float*>(attn), nullptr, B, n, H, d, 0u, 1.0f,
                                         false, s);
  if (aerr != 0) return aerr;
  err = launch_proj_tf32<EPI_RESID>(static_cast<const float*>(attn), wo_split, b_o,
                                    (vec_bf16 >> 1) & 1, xf, static_cast<float*>(y), M, E_pad, Eq,
                                    s);
  if (err != cudaSuccess) return static_cast<int>(err);
  layernorm_kernel<float><<<M, LN_THREADS, 0, s>>>(static_cast<const float*>(y), ln_g, ln_b,
                                                   static_cast<float*>(out), E, E_pad, eps,
                                                   vec_bf16 >> 2);
  return static_cast<int>(cudaGetLastError());
}
