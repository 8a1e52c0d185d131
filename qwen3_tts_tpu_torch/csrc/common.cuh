// Shared device helpers for the port's kernels: element types, the rounding
// points of the working dtype, and deterministic block reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace q3 {

// Element access for the two working types. Activations live in f32 scratch
// holding values already rounded to the working type, so `round_to<T>` is
// where a bf16 program rounds (identity for f32).
template <typename T> __device__ __forceinline__ float to_float(T v);
template <> __device__ __forceinline__ float to_float<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One elementwise op of the working type: computed in f32 and rounded, as a
// separate PyTorch op would (the _rn intrinsics are never fused into an FMA).
template <typename T> __device__ __forceinline__ float mul_t(float a, float b) {
  return round_to<T>(__fmul_rn(a, b));
}
template <typename T> __device__ __forceinline__ float add_t(float a, float b) {
  return round_to<T>(__fadd_rn(a, b));
}
template <typename T> __device__ __forceinline__ float sub_t(float a, float b) {
  return round_to<T>(__fsub_rn(a, b));
}

// Sum over the block in a fixed order (warp shuffle tree, then warp 0 over
// the per-warp sums): every block that reduces the same values gets the same
// bits. `buf` holds at least 32 floats. All threads receive the result.
__device__ __forceinline__ float block_sum(float v, float* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();  // buf may still be read by a previous call
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? buf[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) buf[0] = v;
  }
  __syncthreads();
  return buf[0];
}

}  // namespace q3
