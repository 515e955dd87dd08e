// What the attention kernels at head dims past 128 share in every library
// (included by attention_fwd.cuh after softmax_tile): WIDE_MIN_D, and the
// backward's row-stats kernel attn_bwd_wide_prep_kernel<T>, which the bf16
// backward past 128 (attention_wide_bf16.cuh) launches at T = bf16 and the
// float32 one (attention_wide_f32.cuh, in attention_f32.cu) at T = float. d
// is any width (the wrappers pad it to a multiple of 16 per head, as below
// 128, and pass the unpadded d for the scale).

#pragma once

namespace {

constexpr int WIDE_MIN_D = 129;  // the narrowest head dim the kernels past 128 run

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// Per (b, row, h), row over the padded length n_pad: stats[bh, row] =
// (lse * log2e, rowsum(g * out)) in f32, (0, 0) past n; one warp per row.
template <typename T>
__global__ void __launch_bounds__(128)
attn_bwd_wide_prep_kernel(const T* __restrict__ out, const T* __restrict__ grad,
                          const float* __restrict__ lse, float2* __restrict__ stats, int n,
                          int n_pad, int H, int D, long long rows) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
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
  for (int i = lane; i < D; i += 32) s += to_f32(out[e + i]) * to_f32(grad[e + i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) stats[bh * n_pad + row] = make_float2(lse[bh * n + row] * LOG2E, s);
}

}  // namespace
