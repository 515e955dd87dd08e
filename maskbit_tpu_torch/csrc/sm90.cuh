// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA copies, wgmma with shared-memory descriptors, and the host-side tensor
// map encoder (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint so that no library needs -lcuda), with a cache.
//
// Every shared-memory operand here is a tile of 64-element (128-byte) bf16
// rows, 128-byte swizzled as TMA writes it: 8-row groups 1024 bytes apart.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; the driver call is looked up)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

typedef __nv_bfloat16 bf16;

// The head dims the attention kernels take are the multiples of 16 in [16,
// 128] (nn/dropout_attention.py's HEAD_DIMS). X(W) for each but 64, for the
// switches that pick a kernel by d: in bf16 the mma.sync kernels take these
// and d = 64 the Hopper ones (attention_fwd.cuh).
#define MB_MMA_HEAD_DIMS(X) X(16) X(32) X(48) X(80) X(96) X(112) X(128)

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// Element i of a vector that is bf16 (widened exactly) or f32.
__device__ __forceinline__ float ld_vec(const void* p, bool is_bf16, int i) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// ------------------------------------------------------ PTX wrappers ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One (64 rows x 64 d) bf16 tile of a rank-4 (d, n, h, b) tensor map.
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// The box at (c0, c1) of a rank-2 tensor map.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Shared memory to the box at (c0, c1) of a rank-2 tensor map, in the
// calling thread's bulk group; the parts of the box past the map's bounds
// are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned, a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Keeps the compiler from touching accumulators across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptors for 128-byte-swizzled tiles of 64-element
// (128-byte) rows, as TMA writes them: 8-row groups 1024 bytes apart. K-major
// (the reduction dimension contiguous; the next 16-element slab is +32 bytes,
// +2 in the address field): leading offset unused. MN-major (the output
// dimension contiguous; the next 16-row slab is +2048 bytes, +128): the 8-row
// groups along K are 1024 bytes apart, and the one 64-wide block along M or N
// makes the other offset unused; both are set to 1024.
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return (static_cast<uint64_t>(smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ uint64_t desc_mnmajor(const void* p) {
  return (static_cast<uint64_t>(smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

#define MB_ACC32                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define MB_ACC32_OPS(d)                                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// D(64 x 64, f32) (+)= A(64 x 16) B(16 x 64), both from shared memory.
// TA / TB: 0 K-major, 1 MN-major. scale_d 0 overwrites D.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MB_ACC32
      ", %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : MB_ACC32_OPS(d)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D(64 x 64, f32) += A(64 x 16, bf16 fragments in registers) B(16 x 64) from
// shared memory; TB as above. The A fragment of warp w holds rows 16w..16w+15
// in mma.m16n8k16's A layout, which is the accumulator layout of the
// product before it, packed to bf16 pairs.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MB_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : MB_ACC32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator element i of a m64nN product held by this thread (warp w of
// the warpgroup, lane l, g = l / 4, c = l % 4) is D[16w + g + 8 * ((i >> 1) &
// 1)][8 * (i >> 2) + 2c + (i & 1)]. The A fragment for k slab kk of a m64n64
// accumulator takes columns 16kk..16kk+15.
__device__ __forceinline__ void acc_to_afrag(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Byte offset of bf16 element (row, col) of a tile of 64-column boxes, each
// (rows x 64) box `box_bytes` long, 128-byte swizzled as TMA reads it. A
// warp storing 2 columns a lane of one 8-column group across 8 rows hits 32
// distinct banks.
__device__ __forceinline__ int swizzled_offset(int row, int col, int box_bytes) {
  return (col >> 6) * box_bytes + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}

// ------------------------------------------------------------- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor-map encoder is a driver call and needs the device's context
// current on the calling thread, which the runtime makes current only when
// it first needs it (autograd runs the backward on a thread of its own).
bool current_context() {
  int dev;
  return cudaGetDevice(&dev) == cudaSuccess && cudaSetDevice(dev) == cudaSuccess;
}

// A map is a pure function of its arguments, so encoded maps are kept in a
// small direct-mapped cache keyed on all of them: the weights' maps, and the
// activations' while the allocator hands back the same addresses, are
// encoded once.
constexpr int MAP_KEY_WORDS = 20;
constexpr int MAP_CACHE_SLOTS = 256;

struct MapSlot {
  uint64_t key[MAP_KEY_WORDS];
  CUtensorMap map;
  bool used;
};

// cuTensorMapEncodeTiled with no interleave, 128-byte L2 promotion and zero
// fill past the bounds; `strides` in bytes for dims 1..rank-1, rank <= 5.
bool encode_tiled(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                  const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                  CUtensorMapSwizzle swizzle) {
  static std::mutex lock;
  static MapSlot slots[MAP_CACHE_SLOTS];
  uint64_t key[MAP_KEY_WORDS] = {};
  key[0] = reinterpret_cast<uint64_t>(base);
  key[1] = (static_cast<uint64_t>(type) << 32) | (static_cast<uint64_t>(rank) << 8) |
           static_cast<uint64_t>(swizzle);
  for (int i = 0; i < rank; ++i) {
    key[2 + i] = dims[i];
    key[7 + i] = box[i];
    if (i + 1 < rank) key[12 + i] = strides[i];
  }
  uint64_t h = 1469598103934665603ull;  // FNV-1a over the key words
  for (int i = 0; i < MAP_KEY_WORDS; ++i) h = (h ^ key[i]) * 1099511628211ull;
  MapSlot& slot = slots[(h >> 17) % MAP_CACHE_SLOTS];
  {
    std::lock_guard<std::mutex> guard(lock);
    if (slot.used && memcmp(slot.key, key, sizeof(key)) == 0) {
      *map = slot.map;
      return true;
    }
  }
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  if (fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  std::lock_guard<std::mutex> guard(lock);
  memcpy(slot.key, key, sizeof(key));
  slot.map = *map;
  slot.used = true;
  return true;
}

// A row-major (rows, cols) matrix as a rank-2 map of (box_cols x box_rows)
// boxes, 128-byte swizzled (box_cols * element size must be 128 bytes).
bool matrix_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base,
                long long rows, long long cols, int box_cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  return encode_tiled(map, type, 2, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) holds per device: set it
// the first time a kernel launches on each device, not on every call.
template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, int bytes, unsigned long long& done_mask) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (__atomic_load_n(&done_mask, __ATOMIC_ACQUIRE) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) __atomic_fetch_or(&done_mask, bit, __ATOMIC_RELEASE);
  return err;
}

}  // namespace
