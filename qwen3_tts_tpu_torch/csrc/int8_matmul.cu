// Kernel 4 of the port: the W8A16 dequantizing matmul, on the tensor cores.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/quant.py:_make_pallas_matmul
// (from _int8_mm_core / int8_matmul): out [m, N] = x [m, K] (rounded to
// bf16) @ dequant(q8 [K, N] int8), an f32 sum, times the f32 per-column
// scale once, rounded to x's dtype -- the JAX package's
// `(dot(x_bf16, q8_bf16, f32) * scale).astype(x.dtype)`. It serves the int8
// talker prefill (m = 10 rows), the codec head (m = 1) every frame and the
// per-step code predictor's prefill and heads (m = 2 and 1), for
// 1 <= m <= 1024 with K and N multiples of 128 (the JAX kernel's gate).
// Every int8 value is exact in bf16 and every bf16 x bf16 product exact in
// f32, so the tensor cores compute the plain version's function up to the
// order of the f32 sum.
//
// What bounds it on an H100, and what the design does about it:
// - m <= 16 (every call on the main path): the int8 weight bytes (1-25 MB
//   per call at 1.7B) at 3.35 TB/s. Tier 0: a block of 4 warps owns a
//   16 x 128 output tile (rows past m are zero); the weights stream through
//   a 4-stage ring of 64 x 128 int8 tiles in shared memory, filled by
//   cp.async 16-byte copies, three stages in flight while the fourth is
//   converted and multiplied. K is split across the blocks of a
//   thread-block cluster, in whole 64-row chunks, so that blocks stream
//   weights on about three quarters of the SMs, in clusters of at most 8
//   (the plan's rule, fitted to a sweep of every split count on an H100);
//   the same segments serve every m (below).
// - m = 1024: the multiply-adds (17 GFLOP at K 2048, N 4096), which FMAs
//   on CUDA cores cap at 67 TFLOP/s. Tier 1: a block of 8 warps (2 x 4, each
//   32 x 32) owns a 64 x 128 tile and walks K in 32-row chunks through the
//   same kind of ring; the tensor cores do the products, and one int8 tile
//   converted to bf16 serves the warp's two m16 tiles.
// Both tiers multiply with mma.sync m16n8k16 bf16 -> f32. bf16 x rides the
// ring (cp.async, rows past m zero-filled); f32 x is loaded into registers
// a stage ahead and rounded to bf16 once on its way to shared memory.
// ldmatrix reads the A fragments. The int8 tile is read as 32-bit words of
// 4 neighbouring columns and converted in registers, exactly
// (i8x4_pair_to_bf16x2): a thread's word gives it its B fragment in each of
// its warp's four n8 tiles, so the n8 tiles' columns interleave and thread
// (g, t) ends holding columns 8t..8t+7 of its warp's 32, stored as one run.
// Rows of both shared tiles are padded by 16 bytes, which keeps the word
// reads and ldmatrix free of bank conflicts.
// One order of summation for every m: K is cut into S segments, segment z
// the 64-row steps [z * (K/64) / S, (z + 1) * (K/64) / S) (floors), S a
// function of (K, N) alone (the plan's). Each segment is summed from zero
// in ascending k16 steps (tier 1 walks it as pairs of its 32-row chunks),
// and the segments' partial sums are added in segment order. An output
// element's f32 sum then depends on its own row and column only, so a row
// gets the same bits whatever rows share its launch (a stream's rows at any
// batch size, a dp replica's against the whole batch), in either tier.
// Two ways to the same order, the plan's `cluster`:
// - cluster = S: the segments of one output tile are the blocks of a
//   cluster (at most 16). Each block owns a share of the tile; every block
//   sends its f32 partial sums straight into the owners' shared memory
//   (distributed shared memory) with asynchronous stores that complete on
//   the owner's mbarrier, and each owner, once its own barrier has seen
//   every byte, adds its share in segment order. One launch, no scratch in
//   device memory, no atomics, the same bits on every run. (Two earlier
//   versions were slower: adding the splits through device memory, the
//   last block of a tile, found by an atomic counter, summing them, cost a
//   fence, an atomic and L2 round trips; a full cluster barrier after the
//   stores cost most of that again.)
// - cluster = 1 (tier 1, where the tiles alone fill the card): one block
//   walks all S segments, each into a fresh accumulator that is then added
//   to the running sum, the first copied: the cluster's additions, in its
//   order, with no extra blocks.
// The launch plan (tile rows, chunk rows, segments, cluster) is the
// caller's: ops/quant.py:int8_matmul_plan, whose tiers are the two
// instantiations below; the entry refuses a plan that matches neither.

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace q3 {

constexpr int kMmBN = 128;                 // output columns per block
constexpr int kMmWStride = kMmBN + 16;     // bytes per int8 tile row in shared memory
constexpr int kMmMaxSplits = 16;           // K splits: one cluster per output tile, at most 16 blocks
constexpr int kMmMaxDevices = 64;

template <int WARPS_M, int WM, int BK, int STAGES>
struct MmTier {
  static constexpr int kBK = BK;
  static constexpr int kThreads = 32 * WARPS_M * 4;   // warps: WARPS_M x 4 (32 columns each)
  static constexpr int kBM = 16 * WM * WARPS_M;       // WM m16 tiles per warp
  static constexpr int kXStride = BK + 8;             // bf16 per x row in shared memory
  static constexpr int kWCopies = BK * kMmBN / 16 / kThreads;
  static constexpr int kWStage = BK * kMmWStride;     // bytes of one int8 stage
  static constexpr int kXStage = kBM * kXStride * 2;  // bytes of one x stage
  static constexpr int kRing = STAGES * (kWStage + kXStage);
  static constexpr int kRed = (kBM * kMmBN / 4 + kMmMaxSplits) * 16;  // split-K buffer, [S][slots] float4
  static constexpr int kSmem = kRing + kRed;
  static_assert(kBM * BK / 8 == kThreads, "one 8-value x load per thread per stage");
  static_assert(kWCopies * kThreads * 16 == BK * kMmBN, "whole 16-byte copies per thread");
};
// run_mm's two instantiations. At m <= 16 a 6- or 8-stage ring, and 8 warps
// splitting each chunk's k16 steps, measured no faster than this on an H100.
#define Q3_MM_TIER0 1, 1, 64, 4  // m <= 16
#define Q3_MM_TIER1 2, 2, 32, 4  // 16 < m <= 1024
using MmTier0 = MmTier<Q3_MM_TIER0>;
using MmTier1 = MmTier<Q3_MM_TIER1>;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Eight consecutive f32 x values of one row, held raw between the global
// load and the store to shared memory (rounded to bf16 there, once). bf16 x
// needs no rounding and rides the cp.async ring instead.
struct XF32 {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ uint4 bf16() const {
    return make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
  }
};

// One of a thread's two 4-column runs of an m16 tile's sums (see the
// epilogue): element e of acc[j] for the warp's four n8 tiles j.
__device__ __forceinline__ float4 acc_run(const float (&acc)[4][4], int e) {
  return make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
}

// Four output values, times their columns' scales, rounded once to T.
template <typename T> __device__ __forceinline__ void store4(T* p, float4 v, float4 s);
template <> __device__ __forceinline__ void store4<float>(float* p, float4 v, float4 s) {
  *reinterpret_cast<float4*>(p) =
      make_float4(__fmul_rn(v.x, s.x), __fmul_rn(v.y, s.y), __fmul_rn(v.z, s.z), __fmul_rn(v.w, s.w));
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float4 v, float4 s) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(__fmul_rn(v.x, s.x), __fmul_rn(v.y, s.y)),
                                            pack_bf16x2(__fmul_rn(v.z, s.z), __fmul_rn(v.w, s.w)));
}

// grid (N / 128, ceil(m / BM), P), clusters (1, 1, P). SERIAL (P = 1): the
// block walks all `segs` segments; else P = segs and block z walks segment
// z. Segment z is the K chunks [R * (z * C64 / segs), R * ((z + 1) * C64 /
// segs)), C64 = K / 64, R = 64 / BK (segs <= C64, so none is empty).
template <typename T, bool SERIAL, int WARPS_M, int WM, int BK, int STAGES>
__global__ void __launch_bounds__(MmTier<WARPS_M, WM, BK, STAGES>::kThreads)
int8_mm_tc(const T* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
           T* __restrict__ out, int m, int K, int N, int segs) {
  using Tier = MmTier<WARPS_M, WM, BK, STAGES>;
  constexpr int BM = Tier::kBM, THREADS = Tier::kThreads, XS = Tier::kXStride;
  // Dynamic shared memory: STAGES int8 tiles, STAGES bf16 x tiles, the
  // split-K buffer.
  extern __shared__ __align__(16) unsigned char mm_smem[];
  int8_t* const ws = reinterpret_cast<int8_t*>(mm_smem);
  __nv_bfloat16* const xs = reinterpret_cast<__nv_bfloat16*>(mm_smem + STAGES * Tier::kWStage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4, g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kMmBN, row0 = blockIdx.y * BM;
  constexpr int R = 64 / BK;  // chunks a 64-row step of K
  const int c64 = K / 64;
  // Segment z's first chunk (the cluster's blocks are the segments unless SERIAL).
  auto seg_start = [&](int z) { return R * (z * c64 / (SERIAL ? segs : (int)gridDim.z)); };
  const int c_begin = SERIAL ? 0 : seg_start(blockIdx.z);
  const int n = SERIAL ? K / BK : seg_start(blockIdx.z + 1) - c_begin;  // this block's chunks, >= 1

  // This thread's x load: row xr of the tile, values xk..xk+7 of the chunk.
  const int xr = tid / (BK / 8), xk = (tid % (BK / 8)) * 8;
  const bool x_live = row0 + xr < m;
  const T* xrow = x_live ? x + (size_t)(row0 + xr) * K + (size_t)c_begin * BK + xk : x;
  const int8_t* wsrc = w + (size_t)c_begin * BK * N + col0;
  constexpr bool kAsyncX = std::is_same<T, __nv_bfloat16>::value;
  const int S = gridDim.z;
  // Split K: this block's barrier for the partial sums it will receive
  // (every float4 e of the tile with e % S == split, from each of the S
  // splits), armed now; the cluster barrier's arrive now and wait before
  // the first store into another block make sure every block's barrier is
  // set up before anyone writes to it.
  constexpr int kTile4 = BM * kMmBN / 4;  // float4s of a partial tile
  __shared__ __align__(8) uint64_t red_bar;
  if (S > 1) {
    if (tid == 0) {
      mbar_init(&red_bar, 1);
      mbar_arrive_expect_tx(&red_bar, ((kTile4 - 1 - blockIdx.z) / S + 1) * S * 16);
      fence_mbar_init();
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);
  }

  // One chunk's copies into ring slot `slot`: the int8 tile and, for bf16,
  // the x tile (rows past m zero-filled).
  auto issue = [&](int chunk, int slot) {
    const int8_t* src = wsrc + (size_t)chunk * BK * N;
#pragma unroll
    for (int q = 0; q < Tier::kWCopies; ++q) {
      const int c = tid + q * THREADS, r = c / (kMmBN / 16), s = c % (kMmBN / 16);
      cp_async16(ws + slot * Tier::kWStage + r * kMmWStride + s * 16, src + (size_t)r * N + s * 16);
    }
    if constexpr (kAsyncX) cp_async16_zfill(xs + (slot * BM + xr) * XS + xk, xrow + (size_t)chunk * BK, x_live);
  };
  // f32 x: loaded into registers, stored rounded (zero past m).
  auto load_x = [&](XF32& v, int chunk) {
    if (x_live) v.load(reinterpret_cast<const float*>(xrow) + (size_t)chunk * BK);
    else v.zero();
  };
  auto store_x = [&](const XF32& v, int slot) {
    *reinterpret_cast<uint4*>(xs + (slot * BM + xr) * XS + xk) = v.bf16();
  };

  float acc[WM][4][4];
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  // SERIAL: the segments' running sum; segment `seg` ends before chunk `seg_end`.
  float run[SERIAL ? WM : 1][4][4] = {};
  int seg = 0, seg_end = SERIAL ? seg_start(1) : n;

  // Prologue: chunks 0..STAGES-2 in flight (one commit group each, empty
  // past the split's end, so that group i is always chunk i).
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) issue(s, s);
    cp_async_commit();
  }
  XF32 xv;
  if constexpr (!kAsyncX) {
    XF32 pre[STAGES - 1];
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
      if (s < n) load_x(pre[s], s);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
      if (s < n) store_x(pre[s], s);
  }

  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();  // chunk i has landed (this thread's copies)
    __syncthreads();                 // everyone's; and slot (i - 1) % STAGES is free
    const int nxt = i + STAGES - 1;
    const bool more = nxt < n;
    if (more) {
      issue(nxt, nxt % STAGES);
      if constexpr (!kAsyncX) load_x(xv, nxt);  // stored after this chunk's products
    }
    cp_async_commit();

    const int8_t* wt = ws + (i % STAGES) * Tier::kWStage;
    const __nv_bfloat16* xt = xs + (i % STAGES) * BM * XS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[WM][4];
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
        ldmatrix_x4(a[mi], xt + ((wm * WM + mi) * 16 + (lane & 15)) * XS + kk + (lane >> 4) * 8);
      // Rows kk + 2t, +1, +8, +9 at columns wn*32 + 4g .. +3: B fragment
      // column g of n8 tile j is the tile's physical column wn*32 + 4g + j.
      const int8_t* wp = wt + (kk + 2 * t) * kMmWStride + wn * 32 + 4 * g;
      uint32_t b0[4], b1[4];
      i8x4_pair_to_bf16x2(*reinterpret_cast<const uint32_t*>(wp),
                          *reinterpret_cast<const uint32_t*>(wp + kMmWStride), b0);
      i8x4_pair_to_bf16x2(*reinterpret_cast<const uint32_t*>(wp + 8 * kMmWStride),
                          *reinterpret_cast<const uint32_t*>(wp + 9 * kMmWStride), b1);
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[mi][j], a[mi], b0[j], b1[j]);
    }
    if constexpr (SERIAL) {
      if (i + 1 == seg_end) {  // the segment's sum joins the running sum (the first is copied), in order
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              run[mi][j][e] = seg == 0 ? acc[mi][j][e] : run[mi][j][e] + acc[mi][j][e];
              acc[mi][j][e] = 0.f;
            }
        ++seg;
        seg_end = seg < segs ? seg_start(seg + 1) : n;
      }
    }
    if constexpr (!kAsyncX)
      if (more) store_x(xv, nxt % STAGES);
  }
  cp_async_wait<0>();
  if constexpr (SERIAL) {
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = run[mi][j][e];
  }

  // Thread (g, t) holds, for m tile mi and half h, row (wm*WM + mi)*16 + g +
  // 8h and columns c + o, o = 4e + j: acc[mi][j][2h + e].
  const int cl = wn * 32 + 8 * t, c = col0 + cl;
  if (S == 1) {
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale + c));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale + c) + 1);
#pragma unroll
    for (int mi = 0; mi < WM; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + (wm * WM + mi) * 16 + g + 8 * h;
        if (r >= m) continue;
        store4<T>(out + (size_t)r * N + c, acc_run(acc[mi], 2 * h), s0);
        store4<T>(out + (size_t)r * N + c + 4, acc_run(acc[mi], 2 * h + 1), s1);
      }
    return;
  }

  // Split K: the cluster is this tile's S blocks, rank z = segment z. Block
  // q owns the tile's float4s e with e % S == q. Every block sends each of
  // its partial float4s into its owner's [S][slots] buffer, row z, by an
  // asynchronous store that completes on the owner's barrier; each owner
  // waits on its own barrier alone, then adds its float4s over z in segment
  // order, times the scale, rounded once. A block leaves only when all that
  // is sent to it has landed.
  const int slots = (kTile4 + S - 1) / S;
  float4* const red = reinterpret_cast<float4*>(mm_smem + Tier::kRing);
  const uint32_t red_s = smem_addr(red), bar_s = smem_addr(&red_bar);
  asm volatile("barrier.cluster.wait.aligned;\n" ::);
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e = ((wm * WM + mi) * 16 + g + 8 * h) * (kMmBN / 4) + cl / 4 + half, q = e % S;
        st_async_f4(cluster_addr(red_s + (blockIdx.z * slots + e / S) * 16, q), acc_run(acc[mi], 2 * h + half),
                    cluster_addr(bar_s, q));
      }
  // Bounded: a wrong byte count traps (a launch error) instead of hanging.
  for (int spin = 0; !mbar_try_wait(&red_bar, 0); ++spin)
    if (spin == (1 << 24)) __trap();
  const int live = min(BM, m - row0) * (kMmBN / 4);
  for (int e = blockIdx.z + tid * S; e < live; e += THREADS * S) {
    const int slot = e / S;
    float4 sum = red[slot];
    for (int z = 1; z < S; ++z) {
      const float4 q = red[z * slots + slot];
      sum.x += q.x;
      sum.y += q.y;
      sum.z += q.z;
      sum.w += q.w;
    }
    const int cc = col0 + (e % (kMmBN / 4)) * 4;
    store4<T>(out + (size_t)(row0 + e / (kMmBN / 4)) * N + cc, sum,
              __ldg(reinterpret_cast<const float4*>(scale + cc)));
  }
}

template <typename T, bool SERIAL, int WARPS_M, int WM, int BK, int STAGES>
static cudaError_t launch_mm(const void* x, const int8_t* w, const float* scale, void* out, int m, int K, int N,
                             int segs, cudaStream_t st) {
  using Tier = MmTier<WARPS_M, WM, BK, STAGES>;
  auto* kernel = int8_mm_tc<T, SERIAL, WARPS_M, WM, BK, STAGES>;
  const int splits = SERIAL ? 1 : segs;  // blocks a tile
  // The attributes hold for the current device only: set once per device
  // and instantiation (setting them twice, from two threads, is harmless).
  static std::atomic<bool> configured[kMmMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMmMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tier::kSmem);
    // Clusters of more than 8 blocks (up to 16 on an H100) need the opt-in.
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    configured[dev].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / kMmBN, (m + Tier::kBM - 1) / Tier::kBM, splits);
  cfg.blockDim = dim3(Tier::kThreads);
  cfg.dynamicSmemBytes = Tier::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;  // one cluster per output tile: its K segments
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), w, scale, static_cast<T*>(out), m, K, N, segs);
}

template <typename T>
static cudaError_t run_mm(bool tier0, bool serial, const void* x, const int8_t* w, const float* scale, void* out,
                          int m, int K, int N, int segs, cudaStream_t st) {
  if (tier0) return launch_mm<T, false, Q3_MM_TIER0>(x, w, scale, out, m, K, N, segs, st);
  if (serial) return launch_mm<T, true, Q3_MM_TIER1>(x, w, scale, out, m, K, N, segs, st);
  return launch_mm<T, false, Q3_MM_TIER1>(x, w, scale, out, m, K, N, segs, st);
}

}  // namespace q3

extern "C" {

// out [m, N] = round(bf16(x) [m, K] @ w [K, N] * scale [N]); dtype 0 = f32,
// 1 = bf16 for x and out; w int8 row-major, scale f32; every pointer
// 16-byte aligned. 1 <= m <= 1024, K and N multiples of 128. The plan
// (ops/quant.py:int8_matmul_plan): a tile of `bm` rows walking K in chunks
// of `bk` rows, which must be one of the two instantiations (16, 64) or
// (64, 32) -- any other is refused, so the plan cannot drift from them --;
// `splits`, the K segments (whole 64-row steps spread evenly; 1 <= splits
// <= min(K / 64, 16)); `cluster`, the blocks a tile: `splits` (a segment a
// block, each output tile's cluster) or, in tier 1 only, 1 (one block
// walks every segment).
int q3_int8_matmul(int dtype, const void* x, const int8_t* w, const float* scale, void* out, int m, int K, int N,
                   int bm, int bk, int splits, int cluster, void* stream) {
  using q3::MmTier0;
  using q3::MmTier1;
  const bool tier0 = bm == MmTier0::kBM && bk == MmTier0::kBK;
  if (!(dtype == 0 || dtype == 1) || !(tier0 || (bm == MmTier1::kBM && bk == MmTier1::kBK)))
    return (int)cudaErrorInvalidValue;
  if (m < 1 || m > 1024 || K <= 0 || K % 128 || N <= 0 || N % 128) return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > K / 64 || splits > q3::kMmMaxSplits) return (int)cudaErrorInvalidValue;
  const bool serial = cluster == 1 && splits > 1;
  if (cluster != splits && !(serial && !tier0)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(scale) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? q3::run_mm<float>(tier0, serial, x, w, scale, out, m, K, N, splits, st)
                                   : q3::run_mm<__nv_bfloat16>(tier0, serial, x, w, scale, out, m, K, N, splits, st);
  return (int)e;
}

}  // extern "C"
