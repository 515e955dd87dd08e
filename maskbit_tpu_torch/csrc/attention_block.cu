// Postnorm BERT attention block for inference on Hopper (sm_90a):
//     out = LayerNorm(x + OutProj(MultiHeadAttention(QKV(x))))
//
// Replaces the TPU kernel maskbit_tpu/nn/pallas_attention.py::_attention_block_kernel
// (reached through fused_attention_block -> _fused_attention_block_local).
// It keeps that kernel's rounding points: qkv is rounded to bf16 after the f32
// bias add; the softmax runs in f32 (its unnormalised weights are rounded to
// bf16 for the value product, where the TPU kernel rounds the normalised
// ones: one bf16 rounding, relative 2^-9); the concatenated head outputs are
// rounded to bf16 before the output projection; the output projection stays
// f32 through the bias, the residual add and the LayerNorm (eps from the
// caller), and only the normalised row is rounded to bf16. The bias and
// LayerNorm vectors may be f32 or bf16 each; bf16 ones are widened exactly.
//
// What bounds it on the H100. At the serving shape, x of (16 * 257, 1024)
// bf16, the two projections are 34.5 GFLOP and the attention 4.3 GFLOP,
// about 0.039 ms at the bf16 tensor-core peak, against 16 MB of inputs and
// output (5 us at 3.35 TB/s): the block is bound by the tensor cores, and
// the projections are nine tenths of its operations. The TPU kernel kept the
// whole (n, 3E) f32 qkv and the (group, n, n) logits in VMEM; neither fits
// 227 KB of shared memory, so this is a chain of four kernels:
//   1. proj_kernel<BM, EPI_BIAS>: qkv = bf16(x Wqkv^T + bqkv).
//   2. attn_fwd_kernel<D, false> (attention_fwd.cuh, shared with the
//      training kernels): softmax(q k^T / sqrt(d)) v per (batch * head,
//      64-query tile), over the qkv buffer's strided (b, n, 3, h, D) view,
//      into a contiguous (b, n, h, D) = (b * n, h D) bf16 buffer, at every
//      head dim d (past 128 attn_fwd_wide_bf16_kernel<W, false, ...> of
//      attention_wide_bf16.cuh, TMA and wgmma at widths 192 and 256, each
//      score tile computed once up to d = 256): D = d rounded up to 16 (the
//      wrapper pads W_qkv's rows and W_o's columns per head, so that the
//      QKV projection writes the padded head layout and the out-projection
//      reads it); this library builds only the dropout-free
//      instantiations.
//   3. proj_kernel<BM, EPI_RESID>: y = attn Wo^T + bo + x, f32 (b * n, E).
//   4. layernorm_kernel<bf16> (layernorm.cuh): out = bf16(LN(y)), one block a
//      row, two passes, over the true E of rows E_pad long (E rounded up to
//      8, the tensor maps' 16-byte rows; the wrapper pads x, the weights'
//      E-wide sides and bo with zeros).
// A LayerNorm in the out-projection's epilogue, with a cluster of E / 256
// blocks exchanging row sums through distributed shared memory, kept y out
// of device memory but was slower at both serving shapes (0.165 against
// 0.122 ms at (16, 257, 1024), 0.106 against 0.094 ms at (2, 1025, 1024),
// H100 SXM): the card runs 30 such clusters of 4 at once, so the 33 of the
// serving shape take two waves, and the exchange waits on the slowest block.
// Clusters of 2 blocks along N sharing A by TMA multicast (a third less
// traffic from L2) were slower too: 0.087 against 0.048 ms for the serving
// QKV projection.
// The projections (proj_kernel): C = A B^T with A (M, K) and B (N, K) both
// K-major, as x, the attention output and PyTorch's (out, in) weights are.
// A block computes a (BM x 256) tile of C; the operands arrive by TMA
// (128-byte swizzle, 64-wide k slabs) through a 4-stage mbarrier ring filled by
// one producer thread; two consumer warpgroups multiply with wgmma m64n256k16
// (BM = 128: 64 rows each) or m64n128k16 (BM = 64: 128 columns each), one
// wgmma group kept in flight. setmaxnreg gives the producer warpgroup's
// registers to the consumers (40 and 232), which hold 128 or 64 f32
// accumulators a thread. The QKV epilogue stages each warpgroup's bf16 tile
// in the ring's shared memory, 128-byte swizzled (a warp's stores hit 32
// banks), and one thread writes it with TMA stores, which clip rows and
// columns past the matrix; the out-projection's writes f32 pairs (a warp
// fills whole 32-byte sectors). The wrapper picks BM by M: 128-row tiles at
// the serving shape (396 QKV tiles, 3 waves of 132 SMs), 64-row ones where
// 128 would leave the card half empty (the 512 px batch, M = 2050).
//
// Weights are in the PyTorch nn.Linear layout, (out_features, in_features)
// row-major; the wrapper passes in_proj_weight and out_proj.weight as they
// are stored.

#include "attention_fwd.cuh"
#include "layernorm.cuh"

namespace {

constexpr int PJ_BN = 256;            // output columns per block
constexpr int PJ_BK = 64;             // k per stage: one 128-byte swizzled row
constexpr int PJ_STAGES = 4;
constexpr int PJ_CONSUMERS = 256;     // two consumer warpgroups
constexpr int PJ_THREADS = 128 + PJ_CONSUMERS;  // and a producer warpgroup
constexpr int PJ_PRODUCER_REGS = 40, PJ_CONSUMER_REGS = 232;  // (40 + 2 * 232) * 128 <= 65536
constexpr int BOX_BYTES = 64 * 128;   // one (64 rows x 64 bf16) swizzled box

enum { EPI_BIAS = 0, EPI_RESID = 1 };

template <int BM>
struct ProjTile {
  static constexpr int WG_N = BM == 128 ? 256 : 128;  // columns a consumer warpgroup holds
  static constexpr int ACC = WG_N / 2;                // f32 accumulators a thread
  static constexpr int A_BYTES = BM * 128;
  static constexpr int STAGE_BYTES = A_BYTES + PJ_BN * 128;
  static constexpr int BARS = PJ_STAGES * STAGE_BYTES;
  static constexpr int SMEM = BARS + 128 + 1024;
};

#define MB_F8(d, i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define MB_F64(d, i)                                                                       \
  MB_F8(d, i), MB_F8(d, i + 8), MB_F8(d, i + 16), MB_F8(d, i + 24), MB_F8(d, i + 32),       \
      MB_F8(d, i + 40), MB_F8(d, i + 48), MB_F8(d, i + 56)

// D(64 x 256, f32) (+)= A(64 x 16) B(16 x 256), both K-major in shared memory;
// scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_wide(float (&d)[128], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : MB_F64(d, 0), MB_F64(d, 64)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128, f32) (+)= A(64 x 16) B(16 x 128), the same.
__device__ __forceinline__ void wgmma_wide(float (&d)[64], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : MB_F64(d, 0)
      : "l"(da), "l"(db), "r"(scale_d));
}

// C[M, N] = A[M, K] B[N, K]^T, f32 accumulation, then by EPI:
//   EPI_BIAS:  c = bf16(C + bias)      through tc (bf16)
//   EPI_RESID: y = C + bias + resid    (f32, row stride N)
// `bias` is bf16 where vec_bf16 is set, else f32. resid (M, N) bf16.
// Requires K % 8 == 0 (16-byte rows) and N % 8 == 0; the last k tile's
// columns past K arrive as zeros from TMA.
template <int BM, int EPI>
__global__ void __launch_bounds__(PJ_THREADS, 1)
proj_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap tc, const void* __restrict__ bias,
            const bf16* __restrict__ resid, float* __restrict__ y, int vec_bf16, int M, int N,
            int K) {
  using T = ProjTile<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BARS);
  uint64_t* empty = full + PJ_STAGES;
  auto a_stage = [&](int s) { return smem + s * T::STAGE_BYTES; };
  auto b_stage = [&](int s) { return smem + s * T::STAGE_BYTES + T::A_BYTES; };

  const int n0 = blockIdx.x * PJ_BN;
  const int m0 = blockIdx.y * BM;
  const int ktiles = (K + PJ_BK - 1) / PJ_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < PJ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PJ_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PJ_PRODUCER_REGS) : "memory");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % PJ_STAGES;
        mbar_wait(&empty[s], ((kt / PJ_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], T::STAGE_BYTES);  // rows past M or N arrive as zeros
        tma_load_2d(a_stage(s), &ta, &full[s], kt * PJ_BK, m0);
        tma_load_2d(b_stage(s), &tb, &full[s], kt * PJ_BK, n0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(PJ_CONSUMER_REGS) : "memory");

  const int cw = (threadIdx.x >> 7) - 1;  // consumer warpgroup, 0 or 1
  const int wtid = threadIdx.x & 127;
  const int warp = wtid >> 5;
  const int lane = wtid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int row_off = BM == 128 ? 64 * cw : 0;  // the warpgroup's rows and columns in the tile
  const int col_off = BM == 128 ? 0 : 128 * cw;

  // the first product overwrites acc: no other instruction defines it
  // while products are in flight, which would serialise them
  float acc[T::ACC];

  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % PJ_STAGES;
    mbar_wait(&full[s], (kt / PJ_STAGES) & 1);
    const uint64_t da = desc_kmajor(a_stage(s) + row_off * 128);
    const uint64_t db = desc_kmajor(b_stage(s) + col_off * 128);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PJ_BK / 16; ++kk) wgmma_wide(acc, da + 2 * kk, db + 2 * kk, kt | kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous k tile's products are done: release its stage
    fence_regs(acc);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % PJ_STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Accumulator element i = 4j + 2r + e of this thread is row 16 warp + g + 8r,
  // column 8j + 2c + e of the warpgroup's (64 x WG_N) part of the tile.
  const bool bias16 = vec_bf16 != 0;
  const int col0 = n0 + col_off + 2 * c;  // + 8j
  int rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rows[r] = m0 + row_off + 16 * warp + g + 8 * r;

  if (EPI == EPI_RESID) {
#pragma unroll
    for (int j = 0; j < T::WG_N / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= N) continue;
      const float b0 = ld_vec(bias, bias16, col), b1 = ld_vec(bias, bias16, col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= M) continue;
        const size_t o = (size_t)rows[r] * N + col;
        const float2 rr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + o));
        *reinterpret_cast<float2*>(y + o) =
            make_float2((acc[4 * j + 2 * r] + b0) + rr.x, (acc[4 * j + 2 * r + 1] + b1) + rr.y);
      }
    }
    return;
  }

  // both warpgroups are done with the ring: its memory stages the bf16 tile
  asm volatile("bar.sync 1, %0;\n" ::"n"(PJ_CONSUMERS) : "memory");
  uint8_t* ctile = smem + cw * (64 * T::WG_N * 2);  // this warpgroup's part
#pragma unroll
  for (int j = 0; j < T::WG_N / 8; ++j) {
    const int col = col0 + 8 * j;
    const float b0 = col < N ? ld_vec(bias, bias16, col) : 0.0f;
    const float b1 = col < N ? ld_vec(bias, bias16, col + 1) : 0.0f;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(ctile + swizzled_offset(16 * warp + g + 8 * r, 8 * j + 2 * c,
                                                           BOX_BYTES)) =
          pack_bf16(acc[4 * j + 2 * r] + b0, acc[4 * j + 2 * r + 1] + b1);
  }
  // to device memory: WG_N / 64 boxes of (64 x 64)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
  if (wtid == 0) {
#pragma unroll
    for (int box = 0; box < T::WG_N / 64; ++box)
      tma_store_2d(&tc, ctile + box * BOX_BYTES, n0 + col_off + 64 * box, m0 + row_off);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ------------------------------------------------------------- host side ----

// One projection on `s`: C = A (M, K) B (N, K)^T with the epilogue EPI.
template <int BM, int EPI>
cudaError_t launch_proj(const void* a, const void* b, void* c_out, const void* bias,
                        const void* resid, float* y, int vec_bf16, int M, int N, int K,
                        cudaStream_t s) {
  static unsigned long long smem_set;
  CUtensorMap ta, tb, tc;
  if (!matrix_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, M, K, PJ_BK, BM) ||
      !matrix_map(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, N, K, PJ_BK, PJ_BN))
    return cudaErrorInvalidValue;
  if (EPI == EPI_RESID)
    memset(&tc, 0, sizeof(tc));  // not read
  else if (!matrix_map(&tc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, c_out, M, N, 64, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = ensure_smem(proj_kernel<BM, EPI>, ProjTile<BM>::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + PJ_BN - 1) / PJ_BN, (M + BM - 1) / BM);
  proj_kernel<BM, EPI><<<grid, PJ_THREADS, ProjTile<BM>::SMEM, s>>>(
      ta, tb, tc, bias, static_cast<const bf16*>(resid), y, vec_bf16, M, N, K);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_proj_bm(int bm, const void* a, const void* b, void* c_out, const void* bias,
                           const void* resid, float* y, int vec_bf16, int M, int N, int K,
                           cudaStream_t s) {
  if (bm == 128) return launch_proj<128, EPI>(a, b, c_out, bias, resid, y, vec_bf16, M, N, K, s);
  if (bm == 64) return launch_proj<64, EPI>(a, b, c_out, bias, resid, y, vec_bf16, M, N, K, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Runs the chain on `stream` at width E over H heads of d = E / H (any
// d >= 1; past 128 the attention core is attention_wide_bf16.cuh's), every
// tensor at its padded widths: D = d rounded up to 16, E_pad =
// E rounded up to 8, Eq = H D. x, out: (B*n, E_pad) bf16; w_qkv: (3 Eq,
// E_pad) bf16, each head's rows zero past d; w_o: (E_pad, Eq) bf16, each
// head's columns zero past d; b_qkv (3 Eq), b_o (E_pad), ln_g, ln_b (E) f32,
// or bf16 where bits 0, 1, 2, 3 of vec_bf16 are set; all padding zeros.
// Scratch, allocated by the caller: qkv (B*n, 3 Eq) bf16, attn (B*n, Eq)
// bf16, y (B*n, E_pad) f32. bm_qkv, bm_out (64 or 128): the projections'
// block rows. out's columns E..E_pad come out 0. Returns the first launch
// error (cudaSuccess == 0), or cudaErrorInvalidValue if an argument or a
// tensor map is refused.
extern "C" int mb_attention_block(const void* x, const void* w_qkv, const void* b_qkv,
                                  const void* w_o, const void* b_o, const void* ln_g,
                                  const void* ln_b, int vec_bf16, void* qkv, void* attn, void* y,
                                  void* out, int B, int n, int E, int H, float eps, int bm_qkv,
                                  int bm_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * n;
  if (H <= 0 || E <= 0 || E % H || !current_context())
    return static_cast<int>(cudaErrorInvalidValue);
  const int d = E / H, D = pad_head_dim(d), Eq = H * D, E_pad = (E + 7) / 8 * 8;
  cudaError_t err = launch_proj_bm<EPI_BIAS>(bm_qkv, x, w_qkv, qkv, b_qkv, nullptr, nullptr,
                                             vec_bf16 & 1, M, 3 * Eq, E_pad, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const bf16* q = static_cast<const bf16*>(qkv);
  const long long row = 3LL * Eq;  // the qkv buffer as (B, n, 3, H, D)
  const int aerr = attention_forward<false>(q, q + Eq, q + 2 * Eq, row * n, row, D, nullptr, attn,
                                            nullptr, B, n, H, d, 0u, 1.0f, false, s);
  if (aerr != 0) return aerr;

  err = launch_proj_bm<EPI_RESID>(bm_out, attn, w_o, nullptr, b_o, x, static_cast<float*>(y),
                                  (vec_bf16 >> 1) & 1, M, E_pad, Eq, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  layernorm_kernel<bf16><<<M, LN_THREADS, 0, s>>>(static_cast<const float*>(y), ln_g, ln_b,
                                                  static_cast<bf16*>(out), E, E_pad, eps,
                                                  vec_bf16 >> 2);
  return static_cast<int>(cudaGetLastError());
}
