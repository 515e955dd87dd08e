// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA copies, wgmma with shared-memory descriptors, and the host-side tensor
// map encoder (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint so that no library needs -lcuda), with a cache.
//
// Every shared-memory operand here is a tile of bf16 rows 128, 64 or 32
// bytes long, swizzled at that width as TMA writes it (CU_TENSOR_MAP_SWIZZLE_
// 128B, 64B or 32B): groups of 8 rows one after another, the 16-byte chunks
// of a row permuted by the row's place in its group.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; the driver call is looked up)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

typedef __nv_bfloat16 bf16;

// The head dims the attention kernels are instantiated at are the
// multiples of 16 in [16, 128] (nn/dropout_attention.py's HEAD_DIMS): X(W)
// for each, for the switches that pick a kernel's instantiation by d.
#define MB_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

namespace {

// The instantiation that runs head dim d in [1, 128]: d rounded up to a
// multiple of 16, on inputs zero-padded per head from d to it.
__host__ __device__ constexpr int pad_head_dim(int d) { return (d + 15) / 16 * 16; }

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

// The barrier and copy helpers take shared-memory addresses as 32-bit
// values (a producer that keeps 64-bit generic pointers to every stage and
// panel runs out of its few registers); the pointer forms convert.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  mbar_expect_tx(smem_u32(bar), bytes);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) { mbar_arrive(smem_u32(bar)); }

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_u32(bar), parity);
}

// The box at (d0, row, h, b) of a rank-4 (d, n, h, b) tensor map.
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                             int d0, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(row), "r"(h), "r"(b)
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
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A ticket between blocks: acquire-load and release-store at GPU scope.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
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

// x, hidden from the compiler's loop-invariant code motion: values computed
// from it inside a loop (the descriptors of each k slab, a map's address)
// are recomputed there, a few integer operations, instead of each being
// held in registers across the loop, where at the wide head dims they would
// crowd out the accumulators.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  uint64_t v = reinterpret_cast<uint64_t>(p);
  asm volatile("" : "+l"(v));
  return reinterpret_cast<T*>(v);
}

// Shared-memory matrix descriptor of a tile whose rows are `row_bytes` (128,
// 64 or 32) long, swizzled at that width as TMA writes it: 8-row groups
// 8 * row_bytes apart (the stride offset); the swizzle mode in bits 62-63.
// K-major (the reduction dimension contiguous along a row; the next
// 16-element slab of a row is +32 bytes): the leading offset is unused.
// MN-major (the output dimension contiguous; the next 16-row slab along
// the reduction is +16 * row_bytes): each operand here is one swizzle atom
// wide along M or N, so the leading offset (between such atoms) is unused
// too; both offsets are set to the group stride.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int row_bytes, bool mn_major) {
  const uint64_t group = 8 * row_bytes;
  const uint64_t swizzle = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return ((addr & 0x3FFFF) >> 4) | (((mn_major ? group : 16) >> 4) << 16) | ((group >> 4) << 32) |
         (swizzle << 62);
}
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return smem_desc(smem_u32(p), 128, false);
}

// wgmma m64nNk16 (bf16 in, f32 accumulate) at N = 16, 32 and 64, each
// thread holding N / 2 accumulators; one macro writes each width's two
// forms, overloaded on the accumulator array's length:
//   wgmma_ss<TA, TB>(d, da, db, scale_d): D(64 x N) (+)= A(64 x 16) B(16 x
//     N), both from shared memory; TA / TB: 0 K-major, 1 MN-major; scale_d
//     0 overwrites D;
//   wgmma_rs<TB>(d, a, db): D += A(64 x 16, bf16 fragments in registers)
//     B(16 x N) from shared memory. The A fragment of warp w holds rows
//     16w..16w+15 in mma.m16n8k16's A layout, which is the accumulator
//     layout of the product before it, packed to bf16 pairs.
#define MB_ACC8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define MB_ACC16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define MB_ACC32                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define MB_OPS8(d, i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define MB_OPS_N16(d) MB_OPS8(d, 0)
#define MB_OPS_N32(d) MB_OPS8(d, 0), MB_OPS8(d, 8)
#define MB_OPS_N64(d) MB_OPS8(d, 0), MB_OPS8(d, 8), MB_OPS8(d, 16), MB_OPS8(d, 24)

// ACC: the accumulators' operand list; SS_*, RS_*: the operand numbers that
// follow them (the predicate's source, then the rest of the instruction).
#define MB_DEFINE_WGMMA(N, ACC, SS_P, SS_REST, RS_P, RS_REST)                                 \
  template <int TA, int TB>                                                                  \
  __device__ __forceinline__ void wgmma_ss(float(&d)[N / 2], uint64_t da, uint64_t db,        \
                                           int scale_d) {                                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SS_P                                    \
                 ", 0;\nwgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " ACC SS_REST \
                 "}\n"                                                                       \
                 : MB_OPS_N##N(d)                                                            \
                 : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));                        \
  }                                                                                          \
  template <int TB>                                                                          \
  __device__ __forceinline__ void wgmma_rs(float(&d)[N / 2], const uint32_t(&a)[4],          \
                                           uint64_t db) {                                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " RS_P                                    \
                 ", 0;\nwgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " ACC RS_REST \
                 "}\n"                                                                       \
                 : MB_OPS_N##N(d)                                                            \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));    \
  }

MB_DEFINE_WGMMA(16, MB_ACC8, "%10", ", %8, %9, p, 1, 1, %11, %12;\n", "%13",
                ", {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n")
MB_DEFINE_WGMMA(32, MB_ACC16, "%18", ", %16, %17, p, 1, 1, %19, %20;\n", "%21",
                ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n")
MB_DEFINE_WGMMA(64, MB_ACC32, "%34", ", %32, %33, p, 1, 1, %35, %36;\n", "%37",
                ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n")
#undef MB_DEFINE_WGMMA

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
