// Kernel 2 of the port: the fused vocoder residual unit.
//
// Replaces the TPU kernel qwen3_tts_tpu/models/codec/fused_blocks.py:
// _residual_unit_kernel (entries residual_unit / _run_tiles): on [B, T, C]
// f32 with C <= 512, SnakeBeta -> causal dilated conv k7 -> SnakeBeta ->
// 1x1 conv -> + x, every row independent of where the time axis is tiled.
//
// What bounds it on an H100: arithmetic. The unit is 2*T*C*C*8 flops of f32
// at full precision (no TF32: the vocoder's precision contract), ~42 GFLOP
// per unit at C=384 / T=20480 (a 128-frame bucket), against 67 TFLOP/s of
// f32 CUDA-core peak; its bytes (read x once, write once, weights from L2)
// are small beside that. The plain PyTorch version issues 7+1 matmuls and
// 5 elementwise passes per unit, so it re-reads the activation ~14 times.
//
// Design: a block owns a 32-row time tile of one batch row and all C
// channels. It loads the tile plus 6*dilation rows of left context (zeros
// before t = 0, as the plain version's zero padding, since snake(0) == 0),
// applies snake into dynamic shared memory, runs the 7 taps in ascending
// order with each thread holding an 8-row x CT-channel register tile
// (channels strided by 64 so weight loads coalesce), then bias -> snake back
// into shared memory -> 1x1 conv -> + x, and writes each output once. Every
// output row sums taps ascending and channels ascending, whatever tile it
// falls in, so a prefix of the input gives a bit-identical prefix of the
// output (the vocoder's bucket-invariance). Elementwise steps use the same
// formulas and per-op f32 rounding as the plain version (blocks.snake_beta).

#include "common.cuh"

namespace q3 {

constexpr int kRuRows = 32;                                // time rows per block
constexpr int kRuRowsPerThread = 8;                        // register tile rows
constexpr int kRuLanes = 64;                               // channel lanes
constexpr int kRuThreads = kRuRows / kRuRowsPerThread * kRuLanes;  // 256
constexpr int kRuTaps = 7;

// x + sin(x * e^alpha)^2 / (e^beta + 1e-9), with the per-channel factors
// precomputed; each op rounds as a separate f32 PyTorch op would.
__device__ __forceinline__ float snake(float x, float a, float inv_b) {
  const float s = sinf(__fmul_rn(x, a));
  return __fadd_rn(x, __fmul_rn(__fmul_rn(s, s), inv_b));
}

template <int CT>
__global__ void __launch_bounds__(kRuThreads)
residual_unit_kernel(const float* __restrict__ x, float* __restrict__ y, int T, int C, int dil,
                     const float* __restrict__ a1, const float* __restrict__ b1, const float* __restrict__ w1,
                     const float* __restrict__ c1, const float* __restrict__ a2, const float* __restrict__ b2,
                     const float* __restrict__ w2, const float* __restrict__ c2) {
  extern __shared__ float smem[];
  const int ctx = (kRuTaps - 1) * dil;
  const int rows = kRuRows + ctx;
  float* h = smem;  // [rows, C]: snake(x) over the tile and its left context
  float* sa1 = h + (size_t)rows * C;
  float* sb1 = sa1 + C;
  float* sa2 = sb1 + C;
  float* sb2 = sa2 + C;
  const int t0 = blockIdx.x * kRuRows;
  const float* xb = x + (size_t)blockIdx.y * T * C;
  float* yb = y + (size_t)blockIdx.y * T * C;

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    sa1[c] = expf(a1[c]);
    sb1[c] = __fdiv_rn(1.f, __fadd_rn(expf(b1[c]), 1e-9f));
    sa2[c] = expf(a2[c]);
    sb2[c] = __fdiv_rn(1.f, __fadd_rn(expf(b2[c]), 1e-9f));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
    const int r = e / C, c = e - r * C, t = t0 - ctx + r;
    h[e] = (t >= 0 && t < T) ? snake(xb[(size_t)t * C + c], sa1[c], sb1[c]) : 0.f;
  }
  __syncthreads();

  const int r0 = (threadIdx.x / kRuLanes) * kRuRowsPerThread;
  const int lane = threadIdx.x % kRuLanes;
  float acc[kRuRowsPerThread][CT];
  float wv[CT];
#pragma unroll
  for (int r = 0; r < kRuRowsPerThread; ++r)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[r][j] = 0.f;

  // Dilated causal conv: output row r reads h rows r + i*dil, i = 0..6.
  for (int i = 0; i < kRuTaps; ++i) {
    const float* hrow = h + (size_t)(r0 + i * dil) * C;
    const float* wi = w1 + (size_t)i * C * C;
    for (int ci = 0; ci < C; ++ci) {
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int co = lane + j * kRuLanes;
        wv[j] = co < C ? __ldg(wi + (size_t)ci * C + co) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRuRowsPerThread; ++r) {
        const float hv = hrow[r * C + ci];
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[r][j] = fmaf(hv, wv[j], acc[r][j]);
      }
    }
  }
  __syncthreads();  // every read of h is done: reuse its first rows

#pragma unroll
  for (int r = 0; r < kRuRowsPerThread; ++r)
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int co = lane + j * kRuLanes;
      if (co < C) h[(size_t)(r0 + r) * C + co] = snake(__fadd_rn(acc[r][j], c1[co]), sa2[co], sb2[co]);
      acc[r][j] = 0.f;
    }
  __syncthreads();

  // 1x1 conv, then bias and the residual.
  for (int ci = 0; ci < C; ++ci) {
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int co = lane + j * kRuLanes;
      wv[j] = co < C ? __ldg(w2 + (size_t)ci * C + co) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRuRowsPerThread; ++r) {
      const float hv = h[(size_t)(r0 + r) * C + ci];
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[r][j] = fmaf(hv, wv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRuRowsPerThread; ++r) {
    const int t = t0 + r0 + r;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int co = lane + j * kRuLanes;
      if (co < C) yb[(size_t)t * C + co] = __fadd_rn(xb[(size_t)t * C + co], __fadd_rn(acc[r][j], c2[co]));
    }
  }
}

template <int CT>
static cudaError_t launch_residual_unit(dim3 grid, size_t smem, cudaStream_t st, const float* x, float* y, int T,
                                        int C, int dil, const float* a1, const float* b1, const float* w1,
                                        const float* c1, const float* a2, const float* b2, const float* w2,
                                        const float* c2) {
  const cudaError_t e = cudaFuncSetAttribute(residual_unit_kernel<CT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  residual_unit_kernel<CT><<<grid, kRuThreads, smem, st>>>(x, y, T, C, dil, a1, b1, w1, c1, a2, b2, w2, c2);
  return cudaGetLastError();
}

}  // namespace q3

extern "C" {

// Bytes of dynamic shared memory one block needs (0 when unsupported).
size_t q3_residual_unit_smem_bytes(int C, int dilation) {
  if (C < 1 || C > 8 * q3::kRuLanes || dilation < 1) return 0;
  const size_t bytes = ((size_t)(q3::kRuRows + (q3::kRuTaps - 1) * dilation) * C + 4 * (size_t)C) * sizeof(float);
  return bytes <= 227 * 1024 ? bytes : 0;
}

// y = residual unit of x, both [B, T, C] f32 contiguous. Parameters:
// act1/act2 alpha and beta [C], conv1_w [7, C, C] ([tap, in, out]),
// conv1_b [C], conv2_w [C, C] ([in, out]), conv2_b [C].
int q3_residual_unit(const float* x, float* y, int B, int T, int C, int dilation, const float* a1, const float* b1,
                     const float* w1, const float* c1, const float* a2, const float* b2, const float* w2,
                     const float* c2, void* stream) {
  const size_t smem = q3_residual_unit_smem_bytes(C, dilation);
  if (smem == 0 || B < 1 || B > 65535 || T < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + q3::kRuRows - 1) / q3::kRuRows, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ct = (C + q3::kRuLanes - 1) / q3::kRuLanes;
#define Q3_RU_CASE(n) \
  case n:             \
    return (int)q3::launch_residual_unit<n>(grid, smem, st, x, y, T, C, dilation, a1, b1, w1, c1, a2, b2, w2, c2);
  switch (ct) {
    Q3_RU_CASE(1)
    Q3_RU_CASE(2)
    Q3_RU_CASE(3)
    Q3_RU_CASE(4)
    Q3_RU_CASE(5)
    Q3_RU_CASE(6)
    Q3_RU_CASE(7)
    Q3_RU_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef Q3_RU_CASE
}

}  // extern "C"
