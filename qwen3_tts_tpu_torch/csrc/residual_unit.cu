// Kernel 2 of the port: the fused vocoder residual unit.
//
// Replaces the TPU kernel qwen3_tts_tpu/models/codec/fused_blocks.py:
// _residual_unit_kernel (entries residual_unit / _run_tiles): on [B, T, C]
// f32 with C <= 512, SnakeBeta -> causal dilated conv k7 -> SnakeBeta ->
// 1x1 conv -> + x, every row independent of where the time axis is tiled.
//
// What bounds it on an H100: arithmetic. The unit is 2*T*C*C*8 flops of f32
// at full precision, ~48 GFLOP per unit at C=384 / T=20480 (a 128-frame
// bucket). On the CUDA cores that is 0.72 ms at 67 TFLOP/s; here it runs on
// the tensor cores as 3xTF32 (each f32 operand split into a TF32 high and low
// part, each product lo*hi + hi*lo + hi*hi summed in f32, ~21 bits of each
// operand kept: the precision of f32, not of TF32), three TF32 products at
// 495 TFLOP/s, 0.29 ms. Its bytes (x read once, y written once, the weights)
// are small beside that.
//
// Design: an implicit GEMM with the whole row in the block. A block owns a
// tile of TM time rows of one batch row and all C output channels, so the
// 1x1 conv's input never leaves the block.
//  - The window: snake(x) over the tile and its 6*dilation rows of left
//    context, copied into shared memory by cp.async and snaked in place
//    (zeros before t = 0 and past T, as the plain version's zero padding,
//    since snake(0) == 0). Tap i's
//    A operand is the same buffer shifted by i*dilation rows: no im2col copy.
//    Where the dilation exceeds TM the taps' rows do not overlap and the
//    window holds just the 7 tiles of TM rows the taps read. Where 7 taps'
//    rows would leave room only for narrow weight chunks (wide C with a
//    large dilation; C = 384 at dilation 9) it holds the rows of `taps` < 7
//    taps at a time and is built again for the next ones.
//  - B, the weights, streams through a ring of `stages` chunks of `kc` K
//    rows (cp.async, zero-filled past C), in one pass over the 7 taps of
//    conv1_w and then conv2_w: each chunk serves all TM rows.
//  - 16 warps in a WM x WN grid; a warp's tile is 2 m16 x 6 n8 mma tiles
//    (48 f32 accumulators, so that 16 warps fit the register file; on an
//    H100 this ran 14% faster than 8 warps of twice the tile). So a block
//    holds TM = 32 * WM rows and Cp = 768 / WM channels: WM = 2 / 4 / 8 for
//    the vocoder's C = 384 / 192 / 96, WM = 1 (Cp = 768) for 384 < C <= 512.
//    A fragments come by ldmatrix, B fragments by 32-bit loads (row strides
//    padded so that neither conflicts on banks); each is split into TF32
//    hi / lo in registers and multiplied lo*hi, hi*lo, then hi*hi
//    (mma.sync m16n8k8) into a fresh f32 accumulator, which is added to the
//    running sum with a rounded f32 add once a k8 step: the tensor core
//    truncates as it accumulates, and a sum kept in it across the whole K
//    drifts by ~1e-4 of its size.
//  - Epilogue 1: + conv1_b, snake with act2, written into the window's
//    first TM rows (the taps' rows are dead by then); the 1x1 conv runs the
//    same loop on them. Epilogue 2: + conv2_b + x, each output written once.
// C is padded with zeros to Cp inside the kernel (the window's columns and
// the weight chunks past C are zero). The plan (WM, kc, stages, taps) comes from fused_blocks.residual_unit_plan, which the C
// side checks. Every output row sums the same products in the same order
// (taps ascending, then the 1x1; K in chunks ascending) whatever tile it
// falls in and whatever T is: no split of K across blocks, no atomics, tiles
// at fixed multiples of TM. So a prefix of the input gives a bit-identical
// prefix of the output (the vocoder's bucket invariance), and a run gives the
// same bits twice. Elementwise steps use the same formulas and per-op f32
// rounding as the plain version (blocks.snake_beta; sinf, not __sinf).

#include "common.cuh"

namespace q3 {

constexpr int kRuThreads = 512;  // 16 warps: 4 a sub-partition, to hide shared-memory latency
constexpr int kRuWarps = kRuThreads / 32;
constexpr int kRuTaps = 7;
constexpr int kRuMaxSmem = 232448;  // an H100 block's dynamic shared memory
constexpr int kRuMaxStages = 8;     // cp_async_wait_dyn takes up to stages - 2 = 6
constexpr int kRuMT = 2, kRuNT = 6;  // a warp's m16 x n8 mma tiles

// x + sin(x * e^alpha)^2 / (e^beta + 1e-9), with the per-channel factors
// precomputed; each op rounds as a separate f32 PyTorch op would.
__device__ __forceinline__ float snake(float x, float a, float inv_b) {
  const float s = sinf(__fmul_rn(x, a));
  return __fadd_rn(x, __fmul_rn(__fmul_rn(s, s), inv_b));
}

// The launch plan, checked by ru_layout; all sizes in floats.
struct RuPlan {
  int wm, wn;          // warp grid
  int tm, cp;          // time rows a block; padded channels
  int taps;            // taps a window holds (7 but for large dilations)
  int de, rows;        // the window's rows between two taps, and its rows
  int sa, sb;          // row strides of the window and of a ring chunk
  int kc, stages;      // K rows a chunk; chunks in the ring
  size_t smem;         // bytes
};

inline int ru_pad(int n, int residue) { return n + ((residue - n) % 32 + 32) % 32; }

// The plan for C, dilation and the plan's free choices; false if the kernel
// does not take it.
inline bool ru_layout(int C, int dil, int wm, int kc, int stages, int taps, RuPlan* p) {
  if (C < 1 || C > 512 || dil < 1 || taps < 1 || taps > kRuTaps) return false;
  if (!(wm == 1 || wm == 2 || wm == 4 || wm == 8)) return false;
  p->wm = wm;
  p->wn = kRuWarps / wm;
  p->tm = 16 * kRuMT * wm;
  p->cp = 8 * kRuNT * p->wn;
  if (p->cp < C || !(kc == 8 || kc == 16 || kc == 32) || p->cp % kc || stages < 2 || stages > kRuMaxStages)
    return false;
  p->taps = taps;
  p->de = dil < p->tm ? dil : p->tm;
  p->rows = p->tm + (taps - 1) * p->de;
  p->sa = ru_pad(p->cp, 4);  // ldmatrix rows 16 bytes apart mod 128: no conflicts
  p->sb = ru_pad(p->cp, 8);  // B fragments' 4 rows x 8 columns on 32 banks
  p->kc = kc;
  p->stages = stages;
  p->smem = sizeof(float) * ((size_t)p->rows * p->sa + (size_t)stages * kc * p->sb + 2 * (size_t)p->cp);
  return p->smem <= (size_t)kRuMaxSmem;
}

struct RuArgs {
  const float* x;
  float* y;
  int T, C, dil;
  const float *a1, *b1, *w1, *c1, *a2, *b2, *w2, *c2;
  bool vec16;  // C % 4 == 0 and x and both weights 16-byte aligned: 16-byte copies
  RuPlan p;
};

// Chunk `s` of the weight stream into ring slot `slot`: K rows s*kc .. of the
// virtual [8*Cp, Cp] matrix whose first 7*Cp rows are conv1_w's taps (padded
// from C to Cp) and last Cp rows conv2_w. A chunk never spans two taps.
__device__ __forceinline__ void ru_load_chunk(const RuArgs& a, float* slot, int s) {
  const RuPlan& p = a.p;
  const int r0 = s * p.kc, tap = r0 / p.cp, k0 = r0 - tap * p.cp, C = a.C;
  const float* base = tap < kRuTaps ? a.w1 + (size_t)tap * C * C : a.w2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < p.kc; r += kRuWarps) {
    const int k = k0 + r;
    const float* src = base + (size_t)k * C;
    float* dst = slot + r * p.sb;
    if (a.vec16) {
      for (int c = lane * 4; c < p.cp; c += 128) {
        const bool live = k < C && c < C;
        cp_async16_zfill(dst + c, live ? src + c : a.w1, live);
      }
    } else {
      for (int c = lane; c < p.cp; c += 32) {
        const bool live = k < C && c < C;
        cp_async4_zfill(dst + c, live ? src + c : a.w1, live);
      }
    }
  }
}

__global__ void __launch_bounds__(kRuThreads, 1) residual_unit_tc(const RuArgs a) {
  constexpr int MT = kRuMT, NT = kRuNT;
  extern __shared__ __align__(16) float smem[];
  const RuPlan& p = a.p;
  float* win = smem;                                    // [rows, sa]
  float* ring = win + (size_t)p.rows * p.sa;            // [stages, kc, sb]
  float* s_a1 = ring + (size_t)p.stages * p.kc * p.sb;  // [cp] e^alpha1
  float* s_b1 = s_a1 + p.cp;                            // [cp] 1 / (e^beta1 + 1e-9)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warp_m = warp / p.wn, warp_n = warp - warp_m * p.wn;
  const int C = a.C, T = a.T, dil = a.dil;
  const int t0 = blockIdx.x * p.tm;
  const float* xb = a.x + (size_t)blockIdx.y * T * C;
  float* yb = a.y + (size_t)blockIdx.y * T * C;
  const int n1 = kRuTaps * p.cp / p.kc, nchunks = n1 + p.cp / p.kc;

  // The weight stream's first chunks fly while the window is built.
  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < nchunks) ru_load_chunk(a, ring + (size_t)s * p.kc * p.sb, s);
    cp_async_commit();
  }
  for (int c = threadIdx.x; c < p.cp; c += kRuThreads) {
    s_a1[c] = c < C ? expf(a.a1[c]) : 0.f;
    s_b1[c] = c < C ? __fdiv_rn(1.f, __fadd_rn(expf(a.b1[c]), 1e-9f)) : 0.f;
  }
  __syncthreads();
  // The window for taps i0 .. i0 + taps - 1: row r is time t0 + (i0 - 6) *
  // dil + r, or, where the taps' rows do not overlap (dil > tm), tile r / tm
  // of them.
  const bool seg = dil > p.tm;
  // Rows are copied in with cp.async (all in flight at once), then snake runs
  // in place; zeros stay zeros.
  auto build_window = [&](int i0) {
    for (int r = warp; r < p.rows; r += kRuWarps) {
      const int t = t0 + (i0 - (kRuTaps - 1)) * dil + (seg ? (r / p.tm) * dil + r % p.tm : r);
      const bool live = t >= 0 && t < T;
      const float* src = xb + (size_t)(live ? t : 0) * C;
      float* wrow = win + (size_t)r * p.sa;
      if (a.vec16) {
        for (int c = lane * 4; c < p.cp; c += 128) cp_async16_zfill(wrow + c, src + c, live && c < C);
      } else {
        for (int c = lane; c < p.cp; c += 32) cp_async4_zfill(wrow + c, src + c, live && c < C);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r = warp; r < p.rows; r += kRuWarps) {
      float* wrow = win + (size_t)r * p.sa;
      for (int c = lane; c < p.cp; c += 32) wrow[c] = snake(wrow[c], s_a1[c], s_b1[c]);
    }
  };
  build_window(0);

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.f;

  const int g = lane >> 2, tq = lane & 3;
  const int row0 = warp_m * 16 * MT, col0 = warp_n * 8 * NT;

  for (int s = 0; s < nchunks; ++s) {
    cp_async_wait_dyn(p.stages - 2);
    __syncthreads();  // chunk s landed for every thread; slot (s - 1) % stages is free
    {
      const int ls = s + p.stages - 1;
      if (ls < nchunks) ru_load_chunk(a, ring + (size_t)(ls % p.stages) * p.kc * p.sb, ls);
      cp_async_commit();
    }
    const int r0 = s * p.kc, tap = r0 / p.cp, k0 = r0 - tap * p.cp;
    if (k0 == 0 && tap > 0 && tap < kRuTaps && tap % p.taps == 0) {
      build_window(tap);  // every read of the last window is done
      __syncthreads();
    }
    if (s == n1) {
      // conv1 done: its bias and snake into the window's first TM rows.
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int jc = 0; jc < 2; ++jc) {
          const int c = col0 + n * 8 + 2 * tq + jc;
          const bool live = c < C;  // padded channels: a zero sum, zero factors, snake(0) = 0
          const float bias = live ? __ldg(a.c1 + c) : 0.f, ea = live ? expf(__ldg(a.a2 + c)) : 0.f;
          const float ib = live ? __fdiv_rn(1.f, __fadd_rn(expf(__ldg(a.b2 + c)), 1e-9f)) : 0.f;
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int jr = 0; jr < 2; ++jr) {
              float& v = acc[m][n][jr * 2 + jc];
              win[(size_t)(row0 + m * 16 + g + jr * 8) * p.sa + c] = snake(__fadd_rn(v, bias), ea, ib);
              v = 0.f;
            }
        }
      __syncthreads();
    }
    const int arow = (tap < kRuTaps ? (tap % p.taps) * p.de : 0) + row0 + (lane & 15);
    const float* as = win + (size_t)arow * p.sa + k0 + (lane >> 4) * 4;
    const float* bs = ring + (size_t)(s % p.stages) * p.kc * p.sb + col0 + g;
    for (int kk = 0; kk < p.kc; kk += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t r[4];
        ldmatrix_x4(r, as + (size_t)m * 16 * p.sa + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) split_tf32(__uint_as_float(r[j]), ah[m][j], al[m][j]);
      }
      const float* b = bs + (size_t)(kk + tq) * p.sb;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b[n * 8], bh0, bl0);
        split_tf32(b[4 * p.sb + n * 8], bh1, bl1);
        // The step's three products in a fresh accumulator, then one rounded
        // add into the sum: the tensor core truncates as it accumulates, so
        // a sum kept in it for the whole K would drift (~1e-4 at C = 384);
        // this keeps its error to the step's partial, of random sign.
        float part[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32_1688_zero(part[m], al[m], bh0, bh1);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32_1688(part[m], ah[m], bl0, bl1);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_tf32_1688(part[m], ah[m], bh0, bh1);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][n][j] = __fadd_rn(acc[m][n][j], part[m][j]);
      }
    }
  }
  cp_async_wait<0>();

  // conv2's bias and the residual (every load before the first store, so
  // that they fly together); each output written once.
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int jc = 0; jc < 2; ++jc) {
      const int c = col0 + n * 8 + 2 * tq + jc;
      const float bias = c < C ? __ldg(a.c2 + c) : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int jr = 0; jr < 2; ++jr) {
          const int t = t0 + row0 + m * 16 + g + jr * 8;
          float& v = acc[m][n][jr * 2 + jc];
          v = t < T && c < C ? __fadd_rn(__ldg(xb + (size_t)t * C + c), __fadd_rn(v, bias)) : 0.f;
        }
    }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int jc = 0; jc < 2; ++jc) {
      const int c = col0 + n * 8 + 2 * tq + jc;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int jr = 0; jr < 2; ++jr) {
          const int t = t0 + row0 + m * 16 + g + jr * 8;
          if (t < T && c < C) yb[(size_t)t * C + c] = acc[m][n][jr * 2 + jc];
        }
    }
}

}  // namespace q3

extern "C" {

// Bytes of dynamic shared memory the plan needs (0 when the kernel does not
// take it). The plan (models/codec/fused_blocks.py:residual_unit_plan): a
// wm x (16 / wm) warp grid (wm in {1, 2, 4, 8}), chunks of kc in {8, 16, 32}
// K rows, 2 <= stages <= 8, 1 <= taps <= 7 taps a window.
size_t q3_residual_unit_smem_bytes(int C, int dilation, int wm, int kc, int stages, int taps) {
  q3::RuPlan p;
  return q3::ru_layout(C, dilation, wm, kc, stages, taps, &p) ? p.smem : 0;
}

// y = residual unit of x, both [B, T, C] f32 contiguous. Parameters:
// act1/act2 alpha and beta [C], conv1_w [7, C, C] ([tap, in, out]),
// conv1_b [C], conv2_w [C, C] ([in, out]), conv2_b [C]; the plan as above.
int q3_residual_unit(const float* x, float* y, int B, int T, int C, int dilation, int wm, int kc, int stages,
                     int taps, const float* a1, const float* b1, const float* w1, const float* c1, const float* a2,
                     const float* b2, const float* w2, const float* c2, void* stream) {
  q3::RuArgs a{x, y, T, C, dilation, a1, b1, w1, c1, a2, b2, w2, c2, false, {}};
  if (!q3::ru_layout(C, dilation, wm, kc, stages, taps, &a.p) || B < 1 || B > 65535 || T < 1)
    return (int)cudaErrorInvalidValue;
  a.vec16 = C % 4 == 0 &&
            ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) & 15) == 0;
  // Set on every launch: the attribute is per device, and the call is cheap.
  if (a.p.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(q3::residual_unit_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((T + a.p.tm - 1) / a.p.tm, B);
  q3::residual_unit_tc<<<grid, q3::kRuThreads, a.p.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
