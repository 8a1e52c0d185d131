// Device pieces of the port's persistent kernels, shared by the
// code-predictor frame (cp_frame.cu, kernel 1) and the decode steps
// (talker_step.cu, kernels 3 and 7): one cooperative launch of one 256-thread
// block per SM that walks its phases itself, separated by a grid-wide
// counting barrier (with a timeout trap), and streams its weight slices
// through a shared-memory ring filled by TMA; the ring's vector loads, the
// fixed-order column and block reductions, and the RMSNorm input staging.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace q3 {

constexpr int kFrameThreads = 256;
constexpr int kSmemLimit = 232448;  // an H100 block's dynamic shared memory

// The attribute that lets a kernel take more than 48 KB of dynamic shared
// memory holds only for the device current when it is set, so each device
// sets its own: `smem_set[d]` is the most it allows so far on device d,
// raised when a launch there needs more (never during a graph capture).
constexpr int kMaxDevices = 64;
template <typename K>
inline cudaError_t allow_smem(K kernel, int* smem_set, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > smem_set[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    smem_set[dev] = bytes;
  }
  return cudaSuccess;
}

// A weight vector: 16 bytes of a row, the least a TMA box row may hold
// (4 f32, 8 bf16 or 16 int8 columns).
constexpr int kVecBytes = 16;
template <typename X> struct Vec {
  static constexpr int n = kVecBytes / (int)sizeof(X);
};

__host__ __device__ inline size_t take64(size_t& o, size_t n) {
  const size_t at = o;
  o += (n + 63) / 64 * 64;
  return at;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long atom_add_release_gpu(unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.add.release.gpu.global.u64 %0, [%1], %2;\n" : "=l"(old) : "l"(p), "l"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long ld_acquire_gpu(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A barrier that has waited this long will never open (a block is missing):
// the kernel traps, so that the launch fails with an error instead of
// holding the card.
constexpr unsigned long long kBarrierTimeoutNs = 5000000000ull;

// Every block arrives, then leaves once all have. `count` counts arrivals
// and is never reset: an arrival that finds `old` arrivals belongs to round
// old / nblocks, which is complete once the count reaches the next multiple
// of nblocks (each launch adds a multiple of nblocks, so the count carries
// over to the next launch). The arrival is a release and the wait an
// acquire at GPU scope: writes before the barrier are visible to every
// block after it (the blocks read each other's data through L2). `stamp`,
// when not null, gets the arrival and leave times.
__device__ __forceinline__ void grid_sync(unsigned long long* count, unsigned nblocks, unsigned long long* stamp) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (stamp) stamp[0] = global_ns();
    const unsigned long long old = atom_add_release_gpu(count, 1ull);
    const unsigned long long target = (old / nblocks + 1) * nblocks;
    const unsigned long long t0 = global_ns();
    while (ld_acquire_gpu(count) < target)
      if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
    if (stamp) stamp[1] = global_ns();
  }
  __syncthreads();
}

// One TMA box of `map` at (c0, c1, row r0) into shared memory, landing as
// transaction bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* smem, const CUtensorMap* map, int c0, int c1, int r0,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(r0), "r"(smem_addr(bar))
      : "memory");
}

// The same for a 4-D map: one box of `map` at (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(void* smem, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_addr(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// One weight vector from the ring as floats (int8: exact).
template <typename X> __device__ __forceinline__ void lds_w(const unsigned char* p, float* out);
template <> __device__ __forceinline__ void lds_w<float>(const unsigned char* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <> __device__ __forceinline__ void lds_w<__nv_bfloat16>(const unsigned char* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
template <> __device__ __forceinline__ void lds_w<int8_t>(const unsigned char* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
    i8x4_to_f32(words[i], f);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[4 * i + k] = f[k];
  }
}

// Sums over the row lanes of each owned column, in a fixed order: within a
// warp by an xor butterfly over the lanes of one vector (nvt a power of two
// below 32), then over the warps (or row lanes) in index order. Thread t
// holds vector t % nvt of row lane t / nvt; where nvt does not divide the
// block, the threads past the last whole row lane hold nothing. cs[n][v *
// VEC + i] for the nvt vectors of the block. `t`: the thread's index in
// that mapping, a permutation of threadIdx.x that keeps its lane (by
// default threadIdx.x itself).
template <int VEC, int NR>
__device__ void reduce_cols(float (&acc)[NR][VEC], int nvt, float* red, float* cs, int t) {
  const int lane = t & 31, warp = t >> 5, v = t % nvt, cols = nvt * VEC;
  int groups;
  if (nvt < 32 && (nvt & (nvt - 1)) == 0) {
    for (int off = 16; off >= nvt; off >>= 1) {
#pragma unroll
      for (int n = 0; n < NR; ++n) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[n][i] += __shfl_xor_sync(0xffffffffu, acc[n][i], off);
      }
    }
    groups = kFrameThreads / 32;
    if (lane < nvt) {
#pragma unroll
      for (int n = 0; n < NR; ++n) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) red[(n * groups + warp) * cols + lane * VEC + i] = acc[n][i];
      }
    }
  } else {
    groups = kFrameThreads / nvt;
    const int g = t / nvt;
    if (g < groups) {
#pragma unroll
      for (int n = 0; n < NR; ++n) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) red[(n * groups + g) * cols + v * VEC + i] = acc[n][i];
      }
    }
  }
  __syncthreads();
  for (int c = t; c < NR * cols; c += kFrameThreads) {
    const int n = c / cols, cc = c - n * cols;
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += red[(n * groups + g) * cols + cc];
    cs[c] = s;
  }
  __syncthreads();
}

template <int VEC, int NR>
__device__ void reduce_cols(float (&acc)[NR][VEC], int nvt, float* red, float* cs) {
  reduce_cols<VEC, NR>(acc, nvt, red, cs, threadIdx.x);
}

// xs[n][k] <- the matmul input M of RMSNorm(row n) with weight ln (rounded
// to T first), rows from the f32 scratch `xg` or, when it is null, the T
// rows `rows`. Every block computes the same sum of squares. buf: 32 floats.
template <typename T, typename M, int NR>
__device__ void stage_rmsnorm(const float* xg, const T* const* rows, int H, const T* ln, float eps, float* xs_all,
                              float* buf) {
  for (int n = 0; n < NR; ++n) {
    float* xs = xs_all + n * H;
    float ss = 0.f;
    for (int k = threadIdx.x; k < H; k += kFrameThreads) {
      const float v = xg ? __ldcg(xg + n * H + k) : to_float<T>(rows[n][k]);
      xs[k] = v;
      ss += v * v;
    }
    ss = block_sum(ss, buf);
    const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / H), eps));
    for (int k = threadIdx.x; k < H; k += kFrameThreads)
      xs[k] = round_to<M>(round_to<T>(__fmul_rn(__fmul_rn(xs[k], inv), to_float<T>(ln[k]))));
  }
  __syncthreads();
}

// Sums over the block of N values each thread holds, in a fixed order
// (within a warp by an xor butterfly, then the 8 warps in index order):
// every thread gets all N back in v. buf: 8 * N floats; out: N floats.
template <int N>
__device__ void block_sums(float (&v)[N], float* buf, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) buf[warp * N + i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float sum = 0.f;
    for (int w = 0; w < kFrameThreads / 32; ++w) sum += buf[w * N + threadIdx.x];
    out[threadIdx.x] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = out[i];
}

// cuTensorMapEncodeTiled, looked up once through the runtime (no libcuda link).
static cudaError_t tensor_map_encoder(PFN_cuTensorMapEncodeTiled_v12000* out) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

}  // namespace q3
