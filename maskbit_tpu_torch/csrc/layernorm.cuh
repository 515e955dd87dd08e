// The LayerNorm that ends the attention block, shared by its bf16 chain
// (attention_block.cu) and its float32 chain (attention_f32.cu):
//     out[row] = (y - mean) * rsqrt(var + eps) * gamma + beta
// over the first E columns of the f32 rows y of the out-projection (row
// stride ld >= E, the padded width: columns E..ld are padding and are
// ignored), eps from the caller, mean and variance in two passes, one block
// a row, any E. Bound by bytes: it reads y once from device memory (the
// second and third passes over the row hit L1) and writes out once.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int LN_THREADS = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red is reused between calls
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < LN_THREADS / 32; ++w) t += red[w];
  return t;
}

// Four consecutive outputs, rounded to bf16 or stored as f32.
__device__ __forceinline__ void store4(bf16* dst, const float (&o)[4]) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o[0], o[1]);
  *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(o[2], o[3]);
}
__device__ __forceinline__ void store4(float* dst, const float (&o)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
}

// Columns i..i+3 of a row, those at or past E as 0.
__device__ __forceinline__ float4 load4(const float* row, int i, int E) {
  float4 v = *reinterpret_cast<const float4*>(row + i);
  if (i + 4 > E) {
    v.y = i + 1 < E ? v.y : 0.0f;
    v.z = i + 2 < E ? v.z : 0.0f;
    v.w = i + 3 < E ? v.w : 0.0f;
  }
  return v;
}

// out[row, :E] = T((y - mean) * rsqrt(var + eps) * gamma + beta), f32
// math, T bf16 or float; gamma, beta (E) bf16 where bits 0, 1 of vec_bf16
// are set. y and out rows are ld long (ld % 4 == 0, 16-byte aligned rows);
// out's columns E..ld are written with zeros. A thread takes the float4s
// at columns 4 (tid + 256 k), k = 0, 1, ..., in that order in each pass,
// so the sums are taken in the same order whatever E is.
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const float* __restrict__ y, const void* __restrict__ gamma,
                 const void* __restrict__ beta, T* __restrict__ out, int E, int ld, float eps,
                 int vec_bf16) {
  __shared__ float red[LN_THREADS / 32];
  const float* yr = y + (size_t)blockIdx.x * ld;
  const bool gamma16 = vec_bf16 & 1, beta16 = vec_bf16 & 2;
  float s = 0.0f;
  for (int i = threadIdx.x * 4; i < E; i += LN_THREADS * 4) {
    const float4 v = load4(yr, i, E);
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = block_sum(s, red) / E;
  float q = 0.0f;
  for (int i = threadIdx.x * 4; i < E; i += LN_THREADS * 4) {
    const float4 v = load4(yr, i, E);
    const float a = v.x - mean;
    const float b = i + 1 < E ? v.y - mean : 0.0f;
    const float c = i + 2 < E ? v.z - mean : 0.0f;
    const float d = i + 3 < E ? v.w - mean : 0.0f;
    q += (a * a + b * b) + (c * c + d * d);
  }
  const float rstd = rsqrtf(block_sum(q, red) / E + eps);
  T* orow = out + (size_t)blockIdx.x * ld;
  for (int i = threadIdx.x * 4; i < ld; i += LN_THREADS * 4) {
    const float4 v = load4(yr, i, E);
    const float vals[4] = {v.x, v.y, v.z, v.w};
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = i + e < E ? (vals[e] - mean) * rstd * ld_vec(gamma, gamma16, i + e) +
                             ld_vec(beta, beta16, i + e)
                       : 0.0f;
    store4(orow + i, o);
  }
}

}  // namespace
