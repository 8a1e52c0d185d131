// Shared device code for the port's kernels: element types, the rounding
// points of the working dtype, deterministic block reductions, the matmul
// input type and the int8 column scale; and the tensor-core and
// asynchronous-copy wrappers (cp.async, ldmatrix, the bf16 mma, the exact
// int8 -> bf16 convert, mbarriers and st.async into another block of the
// cluster) of the W8A16 matmul (int8_matmul.cu), which the code-predictor
// frame (cp_frame.cu) also takes its element types, cp.async and int8
// convert from; and the TF32 split and mma of the vocoder residual unit's
// 3xTF32 implicit GEMM (residual_unit.cu).
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

// ---------------------------------------------------------------------------
// Weights: plain (the working type) or int8 with a per-column f32 scale.
// ---------------------------------------------------------------------------

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
// Tensor-core and asynchronous-copy building blocks (inline PTX): cp.async
// 16- and 4-byte copies with commit / wait groups, ldmatrix, the bf16
// m16n8k16 mma with f32 accumulation, the TF32 split and m16n8k8 mma of the
// 3xTF32 products, the exact int8 -> bf16 convert (sm_80+), and mbarriers
// with st.async between the blocks of a cluster (sm_90).
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

// 4 bytes global -> shared (through L1), or 4 zero bytes when `live` is false
// (gmem is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)), "l"(gmem),
               "r"(live ? 4 : 0));
}
// cp_async_wait<n> for a count known only at run time (0 <= n <= 6).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// The 3xTF32 split: x = hi + lo, hi = x rounded to TF32 (an f32 whose low 13
// mantissa bits are zero; nearest, ties away from zero: x + 2^12 in the bits,
// then the low 13 cleared, as cvt.rna.tf32.f32 does for finite x, in two
// integer ops) and lo = x - hi exactly. The tensor core reads lo's leading
// 11 bits, so hi + lo keeps ~21 of x's 24.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col), f32 sums. With g = lane / 4,
// t = lane % 4: a0 = A[g, t], a1 = A[g+8, t], a2 = A[g, t+4], a3 = A[g+8, t+4]
// (ldmatrix_x4 on rows of f32 gives them in this order); b0 = B[t, g], b1 =
// B[t+4, g]; d[0], d[1] are D[g, 2t], D[g, 2t+1] and d[2], d[3] row g + 8.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same with a zero accumulator: d = a * b.
__device__ __forceinline__ void mma_tf32_1688_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
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
