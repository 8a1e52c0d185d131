// Kernel 4 of the port: the W8A16 dequantizing matmul.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/quant.py:_make_pallas_matmul
// (from _int8_mm_core / int8_matmul): out [m, N] = x [m, K] (rounded to
// bf16) @ dequant(q8 [K, N] int8), an f32 sum, times the f32 per-column
// scale once, rounded to x's dtype -- the JAX package's
// `(dot(x_bf16, q8_bf16, f32) * scale).astype(x.dtype)`. It serves the
// int8 talker prefill (m = 10 rows) and the codec head (m = 1) every frame,
// for 1 <= m <= 1024 with K and N multiples of 128 (the JAX kernel's gate).
//
// What bounds it on an H100: at m <= 16 the int8 weight bytes (4-25 MB per
// call at 1.7B; a GEMV at m = 1); at m = 1024 the multiply-adds (a GEMM).
//
// Design (a first, simple version): a block owns a BM x 64 output tile
// (BM = 16 for m <= 16, else 64) and walks its share of K in 32-row steps.
// Each step stages x (rounded to bf16) and the int8 weight tile (converted
// to f32, exact) in shared memory; each of the 256 threads keeps BM/16 x 4
// f32 sums in registers and adds the products with FMAs (every product of a
// bf16 value and an int8 weight is exact in f32, so only the order of the
// sum differs from the plain version, and it is fixed). When the output
// tiles alone would leave most of the card's 132 SMs idle (the GEMV shapes:
// 32-192 tiles), K is split over grid.z so that there are at least 264
// blocks; each split writes f32 partial sums and a second kernel adds them
// in split order. The epilogue multiplies by the scale and rounds once. No
// cuBLAS; tensor cores (mma/wgmma) and TMA are later work.

#include "common.cuh"

namespace q3 {

constexpr int kMmCols = 64;     // output columns per block
constexpr int kMmK = 32;        // K rows per shared-memory step
constexpr int kMmThreads = 256;
constexpr int kMmMinBlocks = 264;  // two blocks per SM of an H100 SXM

template <typename T, int BM>
__global__ void __launch_bounds__(kMmThreads)
int8_mm(const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale, T* __restrict__ out,
        float* __restrict__ part, int m, int K, int N, int k_len) {
  constexpr int RM = BM / 16;  // rows per thread
  __shared__ float xs[kMmK][BM];
  __shared__ float ws[kMmK][kMmCols];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * kMmCols;
  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int k_begin = blockIdx.z * k_len;
  for (int k0 = k_begin; k0 < k_begin + k_len; k0 += kMmK) {
    for (int i = tid; i < BM * kMmK; i += kMmThreads) {
      const int r = i / kMmK, kk = i % kMmK, gr = row0 + r;
      xs[kk][r] = gr < m ? round_to<__nv_bfloat16>(to_float<T>(x[(size_t)gr * K + k0 + kk])) : 0.f;
    }
    {
      const int kk = tid / 8, c = (tid % 8) * 8;  // 32 rows x 64 int8 = 256 loads of 8 bytes
      float wv[8];
      load_w<int8_t>(w + (size_t)(k0 + kk) * N + col0 + c, wv);
#pragma unroll
      for (int j = 0; j < 8; ++j) ws[kk][c + j] = wv[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kMmK; ++kk) {
      float a[RM], b[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xs[kk][ty * RM + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + ty * RM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (part)
        part[((size_t)blockIdx.z * m + r) * N + c] = acc[i][j];
      else
        out[(size_t)r * N + c] = from_float<T>(__fmul_rn(acc[i][j], scale[c]));
    }
  }
}

// Split-K epilogue: the splits' partial sums added in split order, times
// the column's scale, rounded once.
template <typename T>
__global__ void int8_mm_finish(const float* __restrict__ part, int nsplit, const float* __restrict__ scale,
                               T* __restrict__ out, int m, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)m * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < nsplit; ++z) s += part[z * mn + i];
  out[i] = from_float<T>(__fmul_rn(s, scale[i % N]));
}

// K splits for an m x N output: the fewest that divide K into whole 32-row
// steps and give at least kMmMinBlocks blocks (1 when the tiles already do).
static int mm_splits(int m, int K, int N) {
  const int bm = m <= 16 ? 16 : 64;
  const int tiles = (N / kMmCols) * ((m + bm - 1) / bm);
  const int steps = K / kMmK;
  int n = 1;
  while (n < steps && (tiles * n < kMmMinBlocks || steps % n)) ++n;
  return n;
}

template <typename T>
static cudaError_t run_mm(const void* x, const int8_t* w, const float* scale, void* out, int m, int K, int N,
                          float* scratch, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int nsplit = mm_splits(m, K, N), k_len = K / nsplit;
  float* part = nsplit > 1 ? scratch : nullptr;
  if (m <= 16) {
    int8_mm<T, 16><<<dim3(N / kMmCols, 1, nsplit), kMmThreads, 0, st>>>(xt, w, scale, ot, part, m, K, N, k_len);
  } else {
    int8_mm<T, 64><<<dim3(N / kMmCols, (m + 63) / 64, nsplit), kMmThreads, 0, st>>>(xt, w, scale, ot, part, m, K, N,
                                                                                    k_len);
  }
  Q3_CHECK_LAUNCH();
  if (part) {
    const size_t mn = (size_t)m * N;
    int8_mm_finish<T><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(part, nsplit, scale, ot, m, N);
  }
  return cudaGetLastError();
}

static bool mm_shape_ok(int m, int K, int N) {
  return m >= 1 && m <= 1024 && K > 0 && K % kMmK == 0 && N > 0 && N % kMmCols == 0;
}

}  // namespace q3

extern "C" {

// Floats of f32 scratch (split-K partial sums) one call needs; 0 when it
// needs none or the shape is unsupported.
size_t q3_int8_matmul_scratch_floats(int m, int K, int N) {
  if (!q3::mm_shape_ok(m, K, N)) return 0;
  const int nsplit = q3::mm_splits(m, K, N);
  return nsplit > 1 ? (size_t)nsplit * m * N : 0;
}

// out [m, N] = round(bf16(x) [m, K] @ w [K, N] * scale [N]); dtype 0 = f32,
// 1 = bf16 for x and out. w int8 row-major, scale f32. 1 <= m <= 1024,
// K % 32 == 0, N % 64 == 0 (the callers pass multiples of 128). `scratch`
// holds q3_int8_matmul_scratch_floats(m, K, N) floats (may be null at 0).
int q3_int8_matmul(int dtype, const void* x, const int8_t* w, const float* scale, void* out, int m, int K, int N,
                   float* scratch, void* stream) {
  if (!(dtype == 0 || dtype == 1) || !q3::mm_shape_ok(m, K, N)) return (int)cudaErrorInvalidValue;
  if (q3::mm_splits(m, K, N) > 1 && !scratch) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? q3::run_mm<float>(x, w, scale, out, m, K, N, scratch, st)
                                   : q3::run_mm<__nv_bfloat16>(x, w, scale, out, m, K, N, scratch, st);
  return (int)e;
}

}  // extern "C"
