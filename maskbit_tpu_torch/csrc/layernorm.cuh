// The LayerNorm that ends the attention block, shared by its bf16 chain
// (attention_block.cu) and its float32 chain (attention_f32.cu):
//     out[row] = (y - mean) * rsqrt(var + eps) * gamma + beta
// over the f32 rows y of the out-projection, eps from the caller, mean and
// variance in two passes over the row held in registers, one block a row.
// Bound by bytes: it reads y once and writes out once.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int LN_THREADS = 256;
constexpr int LN_VEC = 4;  // float4 per thread per pass; E <= 4 * 4 * 256

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

// out[row] = T((y - mean) * rsqrt(var + eps) * gamma + beta), f32 math, T
// bf16 or float; gamma, beta bf16 where bits 0, 1 of vec_bf16 are set.
// Requires E % 4 == 0, E <= 4096 and 16-byte aligned rows.
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const float* __restrict__ y, const void* __restrict__ gamma,
                 const void* __restrict__ beta, T* __restrict__ out, int E, float eps,
                 int vec_bf16) {
  __shared__ float red[LN_THREADS / 32];
  const float* yr = y + (size_t)blockIdx.x * E;
  const bool gamma16 = vec_bf16 & 1, beta16 = vec_bf16 & 2;
  float4 v[LN_VEC];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < LN_VEC; ++k) {
    const int i = (threadIdx.x + k * LN_THREADS) * 4;
    v[k] = i < E ? *reinterpret_cast<const float4*>(yr + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  }
  const float mean = block_sum(s, red) / E;
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < LN_VEC; ++k) {
    const int i = (threadIdx.x + k * LN_THREADS) * 4;
    if (i < E) {
      const float a = v[k].x - mean, b = v[k].y - mean, c = v[k].z - mean, d = v[k].w - mean;
      q += (a * a + b * b) + (c * c + d * d);
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / E + eps);
  T* orow = out + (size_t)blockIdx.x * E;
#pragma unroll
  for (int k = 0; k < LN_VEC; ++k) {
    const int i = (threadIdx.x + k * LN_THREADS) * 4;
    if (i < E) {
      const float vals[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = (vals[e] - mean) * rstd * ld_vec(gamma, gamma16, i + e) + ld_vec(beta, beta16, i + e);
      store4(orow + i, o);
    }
  }
}

}  // namespace
