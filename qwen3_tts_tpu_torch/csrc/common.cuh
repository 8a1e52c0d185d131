// Shared device code for the port's kernels: element types, the rounding
// points of the working dtype, deterministic block reductions, the split-K
// GEMV (with RMSNorm / SiLU*up in its input staging), and one decode step's
// qkv finish (QK-norm, RoPE, cache append) and attention scores, that the
// talker step (talker_step.cu) and the code-predictor decode steps
// (decode_layer.cuh) are built from; and the tensor-core and
// asynchronous-copy wrappers (cp.async, ldmatrix, the bf16 mma, the exact
// int8 -> bf16 convert, mbarriers and st.async into another block of the
// cluster) of the W8A16 matmul (int8_matmul.cu), which the code-predictor
// frame (cp_frame.cu) also takes its element types, cp.async and int8
// convert from.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
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

#define Q3_CHECK_LAUNCH()                          \
  do {                                             \
    const cudaError_t e_ = cudaGetLastError();     \
    if (e_ != cudaSuccess) return e_;              \
  } while (0)

// ---------------------------------------------------------------------------
// Weights: plain (the working type) or int8 with a per-column f32 scale.
// ---------------------------------------------------------------------------

// Columns a lane reads in one load: 16 bytes of f32 / bf16, 8 bytes of int8.
template <typename W> struct WVec;
template <> struct WVec<float> { static constexpr int n = 4; };
template <> struct WVec<__nv_bfloat16> { static constexpr int n = 8; };
template <> struct WVec<int8_t> { static constexpr int n = 8; };

template <typename W> __device__ __forceinline__ void load_w(const W* p, float* out);
template <> __device__ __forceinline__ void load_w<float>(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <> __device__ __forceinline__ void load_w<__nv_bfloat16>(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <> __device__ __forceinline__ void load_w<int8_t>(const int8_t* p, float* out) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(b[i]);
}

// The type a matmul's input is rounded to: the working type for plain
// weights; bf16 for int8 weights (the JAX package's dequant-then-dot runs
// bf16 x bf16 with f32 accumulation, so every product is exact in f32).
template <typename T, typename W> struct MatIn { using type = T; };
template <typename T> struct MatIn<T, int8_t> { using type = __nv_bfloat16; };

// A matmul output column before rounding: the partial sum times the
// column's scale (int8), or the sum itself (plain: `scale` is null).
__device__ __forceinline__ float scaled(float sum, const float* scale, int col) {
  return scale ? __fmul_rn(sum, scale[col]) : sum;
}

// ---------------------------------------------------------------------------
// Split-K GEMV: part[split, col] = sum over the split's 64 rows k of
// x[k] * w[k, col]; the consumer adds the splits in a fixed order.
// ---------------------------------------------------------------------------

constexpr int kGemvRows = 64;      // K rows per split (grid.y)
constexpr int kGemvThreads = 256;  // 8 warps, each a strided subset of the 64 rows

__device__ __forceinline__ float sum_parts(const float* part, int nsplit, int n, int col) {
  float s = 0.f;
  for (int i = 0; i < nsplit; ++i) s += part[(size_t)i * n + col];
  return s;
}

// Where a GEMV reads its input vector x[k], k < K: an f32 vector `xf`; or
// row (`idx ? *idx : row`) of the T matrix `table`; or, with `gu_part`,
// round(SiLU(gate)) * up from the gate|up GEMV's partials (N = 2K there,
// columns times `gu_scale` when that projection is int8). With `ln` the
// input is RMS-normalised first (the whole vector's sum of squares, reduced
// identically in every block) and rounded to T.
template <typename T>
struct GemvInput {
  const float* xf;
  const T* table;
  const int* idx;
  int row;
  const float* gu_part;
  int gu_nsplit;
  const float* gu_scale;
  const T* ln;
  float eps;
};

template <typename T>
__device__ __forceinline__ float gemv_x(const GemvInput<T>& in, const T* row, int K, int k) {
  if (in.gu_part) {
    const float g = round_to<T>(scaled(sum_parts(in.gu_part, in.gu_nsplit, 2 * K, k), in.gu_scale, k));
    const float u = round_to<T>(scaled(sum_parts(in.gu_part, in.gu_nsplit, 2 * K, K + k), in.gu_scale, K + k));
    return mul_t<T>(round_to<T>(__fdiv_rn(g, __fadd_rn(1.f, expf(-g)))), u);
  }
  return row ? to_float<T>(row[k]) : in.xf[k];
}

// T: the working type; W: the weight type (T, or int8_t with the scale
// applied by the consumer). The staged input is rounded to MatIn<T, W>.
// Kernels defined here are `static`: every .cu that includes this header
// gets its own copy, so no two objects of the library register one kernel.
template <typename T, typename W>
static __global__ void __launch_bounds__(kGemvThreads)
gemv_partial(const GemvInput<T> in, const W* __restrict__ w, int K, int N, float* __restrict__ part) {
  using M = typename MatIn<T, W>::type;
  constexpr int VEC = WVec<W>::n;
  constexpr int COLS = 32 * VEC;
  constexpr int WARPS = kGemvThreads / 32;
  __shared__ float xs[kGemvRows];
  __shared__ float red[WARPS][COLS];
  __shared__ float buf[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * COLS, k0 = blockIdx.y * kGemvRows;
  const T* row = in.table ? in.table + (size_t)(in.idx ? in.idx[0] : in.row) * K : nullptr;

  float inv = 1.f;
  if (in.ln) {
    float ss = 0.f;
    for (int k = tid; k < K; k += kGemvThreads) {
      const float v = gemv_x(in, row, K, k);
      ss += v * v;
    }
    ss = block_sum(ss, buf);
    inv = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / K), in.eps));
  }
  if (tid < kGemvRows) {
    const int k = k0 + tid;
    float v = gemv_x(in, row, K, k);
    if (in.ln) v = round_to<T>(__fmul_rn(__fmul_rn(v, inv), to_float<T>(in.ln[k])));
    xs[tid] = round_to<M>(v);  // identity for plain weights: v is already in T
  }
  __syncthreads();

  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll
  for (int r = warp; r < kGemvRows; r += WARPS) {
    float wv[VEC];
    load_w<W>(w + (size_t)(k0 + r) * N + col0 + lane * VEC, wv);
    const float xv = xs[r];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = fmaf(xv, wv[j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) red[warp][lane * VEC + j] = acc[j];
  __syncthreads();
  for (int c = tid; c < COLS; c += kGemvThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) s += red[wi][c];
    part[(size_t)blockIdx.y * N + col0 + c] = s;
  }
}

template <typename T, typename W>
static cudaError_t gemv(const GemvInput<T>& in, const W* w, int K, int N, float* part, cudaStream_t st) {
  constexpr int COLS = 32 * WVec<W>::n;
  const dim3 grid(N / COLS, K / kGemvRows);
  gemv_partial<T, W><<<grid, kGemvThreads, 0, st>>>(in, w, K, N, part);
  return cudaGetLastError();
}

template <typename T>
static GemvInput<T> vec_input(const float* xf, const T* ln = nullptr, float eps = 0.f) {
  return GemvInput<T>{xf, nullptr, nullptr, 0, nullptr, 0, nullptr, ln, eps};
}

// Columns a GEMV block covers: N must be a multiple of it.
template <typename W> constexpr int gemv_cols() { return 32 * WVec<W>::n; }

static size_t split_size(int k, int n) { return (size_t)(k / kGemvRows) * n; }

// The K splits of column `col`, added within each chunk of `per` splits and
// then chunk after chunk, in ascending order (per >= nsplit: sum_parts).
__device__ __forceinline__ float sum_parts_chunked(const float* part, int nsplit, int per, int n, int col) {
  float acc = 0.f;
  for (int c0 = 0; c0 < nsplit; c0 += per) {
    const int c1 = min(c0 + per, nsplit);
    float s = 0.f;
    for (int i = c0; i < c1; ++i) s += part[(size_t)i * n + col];
    acc = c0 ? acc + s : s;
  }
  return acc;
}

// The o / down residual: y <- round_T(x + o) (`residual`) or o, with o =
// round_T(sum of the partials [* scale]) summed in `per`-split chunks. X is
// the residual stream's storage: f32 scratch holding T-rounded values
// (kernels 1 and 3) or T itself (the decode-layer steps). y may be x (each
// thread reads and writes one element).
template <typename T, typename X>
static __global__ void residual_out(const float* __restrict__ part, int nsplit, int per, int H,
                                    const float* __restrict__ scale, const X* x, int residual, X* y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H) return;
  const float o = round_to<T>(scaled(sum_parts_chunked(part, nsplit, per, H, i), scale, i));
  y[i] = from_float<X>(residual ? add_t<T>(to_float<X>(x[i]), o) : o);
}

// RMSNorm over the block's head_dim values `v`, then split-half RoPE at
// `pos` (cos_t/sin_t rows [pos, D/2], rounded to C), rounding as the plain
// version. `vals`: blockDim floats of shared scratch; `buf`: block_sum's.
template <typename T, typename C = T>
__device__ float qk_norm_rope(float v, const T* __restrict__ w, const float* __restrict__ cos_t,
                              const float* __restrict__ sin_t, int pos, float eps, float* vals, float* buf) {
  const int D = blockDim.x, t = threadIdx.x, half = D / 2, f = t < half ? t : t - half;
  const float ss = block_sum(v * v, buf);
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / D), eps));
  vals[t] = round_to<T>(__fmul_rn(__fmul_rn(v, inv), to_float<T>(w[t])));
  __syncthreads();
  const float c = round_to<C>(cos_t[(size_t)pos * half + f]), s = round_to<C>(sin_t[(size_t)pos * half + f]);
  const float out = t < half ? sub_t<T>(mul_t<T>(vals[t], c), mul_t<T>(vals[t + half], s))
                             : add_t<T>(mul_t<T>(vals[t], c), mul_t<T>(vals[t - half], s));
  __syncthreads();  // vals is reused by the next call
  return out;
}

// ---------------------------------------------------------------------------
// One decode step's attention pieces over a [S, KV*D] cache plane, shared by
// the talker step and the code-predictor steps. Attention splits the rows
// <= pos into kAttnChunk-row chunks (a block per q head and chunk).
// ---------------------------------------------------------------------------

constexpr int kAttnChunk = 64;   // cache rows per attention block
constexpr int kAttnWarps = 4;    // warps of a score block (one row per warp at a time)

// Blocks 0..Hq-1 (blockDim = head_dim): q head b, finished from the qkv
// partials (round_T(sum * scale)), QK-normed and rotated, into `q`. Blocks
// Hq..Hq+KV-1: kv head j's k (normed, rotated) and v, written to cache row
// `pos` of this layer. Every later pass reads row `pos` from the cache.
template <typename T, typename C = T>
static __global__ void qkv_finish(const float* __restrict__ part, int nsplit, const float* __restrict__ qkv_s,
                                  const T* __restrict__ qn, const T* __restrict__ kn, const float* __restrict__ cos_t,
                                  const float* __restrict__ sin_t, int pos, int Hq, int KV, float eps,
                                  float* __restrict__ q, T* __restrict__ ck, T* __restrict__ cv) {
  __shared__ float vals[256];
  __shared__ float buf[32];
  const int D = blockDim.x, t = threadIdx.x, b = blockIdx.x;
  const int qd = Hq * D, kvd = KV * D, N = qd + 2 * kvd;
  if (b < Hq) {
    const int c = b * D + t;
    q[c] = qk_norm_rope<T, C>(round_to<T>(scaled(sum_parts(part, nsplit, N, c), qkv_s, c)), qn, cos_t, sin_t, pos,
                              eps, vals, buf);
  } else {
    const int col = (b - Hq) * D + t, kc = qd + col, vc = qd + kvd + col;
    const float k = qk_norm_rope<T, C>(round_to<T>(scaled(sum_parts(part, nsplit, N, kc), qkv_s, kc)), kn, cos_t,
                                       sin_t, pos, eps, vals, buf);
    const float v = round_to<T>(scaled(sum_parts(part, nsplit, N, vc), qkv_s, vc));
    ck[(size_t)pos * kvd + col] = from_float<T>(k);
    cv[(size_t)pos * kvd + col] = from_float<T>(v);
  }
}

// Pass 1, grid (Hq, chunks up to pos), kAttnWarps warps: scores[h, r] =
// (q_h . k_r) * scale for the chunk's rows r <= pos, a warp per row at a
// time (lanes own head_dim/32 dims, butterfly sum), and the chunk's maximum.
template <typename T>
static __global__ void __launch_bounds__(kAttnWarps * 32)
attn_scores(const float* __restrict__ q, const T* __restrict__ ck, int pos, int Hq, int KV, int D, int S,
            float scale, float* __restrict__ scores, float* __restrict__ cmax) {
  __shared__ float qs[256];
  __shared__ float wmax[kAttnWarps];
  const int h = blockIdx.x, c = blockIdx.y, nch = gridDim.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int kvd = KV * D, koff = (h / (Hq / KV)) * D, per = D / 32;
  for (int i = t; i < D; i += blockDim.x) qs[i] = q[h * D + i];
  __syncthreads();
  const int r0 = c * kAttnChunk, r1 = min(r0 + kAttnChunk, pos + 1);
  float m = -INFINITY;
  for (int r = r0 + warp; r < r1; r += kAttnWarps) {
    const T* krow = ck + (size_t)r * kvd + koff + lane * per;
    float s = 0.f;
    for (int j = 0; j < per; ++j) s = fmaf(qs[lane * per + j], to_float<T>(krow[j]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    s = __fmul_rn(s, scale);
    if (lane == 0) scores[(size_t)h * S + r] = s;
    m = fmaxf(m, s);
  }
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  if (t == 0) {
    float bm = wmax[0];
    for (int w = 1; w < kAttnWarps; ++w) bm = fmaxf(bm, wmax[w]);
    cmax[h * nch + c] = bm;
  }
}

// ---------------------------------------------------------------------------
// Tensor-core and asynchronous-copy building blocks (inline PTX): cp.async
// 16-byte copies with commit / wait groups, ldmatrix, the bf16 m16n8k16 mma
// with f32 accumulation, the exact int8 -> bf16 convert (sm_80+), and
// mbarriers with st.async between the blocks of a cluster (sm_90).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, through L2 only (the weights are read once).
// Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
// The same, or 16 zero bytes into `smem` when `live` is false (gmem is then
// not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)), "l"(gmem),
               "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8. For an m16k16 A tile (row-major, rows 16 bytes
// apart or more) lane l points at row l % 16, column (l / 16) * 8: r[0..3]
// are then the mma's A fragment a0..a7 in order.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 sums. With g = lane / 4,
// t = lane % 4: b0 holds B[2t, g], B[2t+1, g] (low half first), b1 the rows
// 2t+8, 2t+9; d[0], d[1] are D[g, 2t], D[g, 2t+1] and d[2], d[3] row g + 8.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory barriers (mbarrier) and asynchronous stores into another
// block of the cluster that complete on the target's barrier (sm_90).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
// Arrive once, expecting `bytes` more of asynchronous transactions in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
// Makes the barriers this thread initialised visible to the cluster (before
// the cluster barrier that the other blocks wait on).
__device__ __forceinline__ void fence_mbar_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}
// This block's shared address `addr` as the same offset in block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// 16 bytes into another block's shared memory; completes as 16 transaction
// bytes on that block's barrier `bar` (both cluster addresses).
__device__ __forceinline__ void st_async_f4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
               : "memory");
}

// Four int8 (one 32-bit word, byte j = value j) -> four exact floats: each
// biased byte v + 128 becomes the low byte of 2^23's mantissa, and one
// subtraction of 2^23 + 128 leaves v (no int -> float conversion unit).
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// Two int8 words of the same four columns in rows k (lo) and k + 1 (hi) ->
// four bf16x2 words, word j = (row k, row k + 1) of column j, row k in the
// low half: an mma B-fragment register per column. Exact: an integer of at
// most 8 significant bits has a zero low half as an f32, so its high half is
// the bf16 of the same value.
__device__ __forceinline__ void i8x4_pair_to_bf16x2(uint32_t lo, uint32_t hi, uint32_t (&out)[4]) {
  float a[4], b[4];
  i8x4_to_f32(lo, a);
  i8x4_to_f32(hi, b);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = __byte_perm(__float_as_uint(a[j]), __float_as_uint(b[j]), 0x7632);
}

}  // namespace q3
