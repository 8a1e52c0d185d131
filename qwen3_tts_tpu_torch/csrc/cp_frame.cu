// Kernel 1 of the port: the whole code-predictor frame in one persistent
// launch.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/fused_layer.py:_cp_frame_kernel
// (entry streamed_cp_frame): all 15 acoustic codes of one frame, i.e. the two
// prefill rows (talker hidden, semantic embedding) and 14 code steps, each
// through 5 decoder layers (RMSNorm -> qkv -> QK-norm -> RoPE -> KV append ->
// GQA over <= 16 rows -> o -> residual -> RMSNorm -> SwiGLU -> residual),
// then final norm, lm head g and argmax. The code of step g feeds the
// embedding gather (and mtp projection) of step g+1 on the device; nothing
// returns to the host.
//
// What bounds it on an H100: the 15 passes of a frame are dependent (code g
// feeds pass g+1) and each needs every layer. At 1.7B the 5 layers are
// 157.3 MB in bf16 (31.5 MB each), more than the 50 MB L2, so every pass
// reads them again: with the 15 heads (62.9 MB) and the mtp projection
// (4.2 MB a pass) ~2.49 GB a frame in bf16, 0.74 ms at 3.35 TB/s (int8
// ~0.38 ms, f32 ~1.5 ms). Each pass is also a chain of 27 dependent phases
// (mtp; qkv, attention, o, gate|up, down per layer; head), so the frame
// pays ~400 grid-wide barriers; measured, each barrier costs ~0.9 us and
// the weight stream is limited by a fixed cost per ring tile, so tiles are
// as large as shared memory allows (PERF.md).
//
// Design: one cooperative launch of `grid` blocks (one per SM; all
// co-resident), 256 threads each, which walks the 15 passes itself and
// separates dependent phases with a grid barrier (a hand-written counting
// barrier in the scratch). The two prefill rows share pass 0 as a 2-row
// GEMV. Each projection's output columns are cut into vectors of 16 bytes
// of weights (4 f32, 8 bf16 or 16 int8 columns) and each block owns a fixed
// run of `nv` vectors (in each half of gate|up, so that a block finishes
// its own SiLU*up) over the whole K: its column sums are added in a fixed
// order in the block, with no float atomics and no cross-block partial
// sums, so a frame is bit-reproducible. The weights do not depend on the
// activations: every block streams its slices of all projections of the
// frame, in the order it consumes them, through a ring of `kRingStages`
// shared-memory tiles that thread 0 fills with TMA boxes (the weights'
// tensor descriptors are built once per tree), each slot completing on its
// own mbarrier; the ring runs `kRingStages - 1` tiles ahead of the consumer
// across phase boundaries, so the next phase's first tiles are in flight
// while the block waits at the barrier. Int8 tiles are converted exactly to
// f32 in registers (no bf16 copy of the weights). Activations (x, the qkv
// row, the attention row, SiLU*up; at most 2 x 3072 floats) and the 16-row
// KV cache live in a small global scratch, read after the barrier through
// L2 (__ldcg), never through L1; every block that owns columns of a
// norm-fed projection recomputes the RMSNorm of x itself, and the blocks
// that own x's columns in o and down keep them in shared memory. Attention
// is one block per q head. The head phase leaves each block's best (logit,
// index); after the barrier every block finishes the argmax over those
// itself (ties to the lowest index), which feeds the next pass's gather
// without another barrier. The grid, the ownership and the ring's tile and
// box sizes come from the Python plan (ops/fused_layer.py:cp_frame_plan);
// the entry checks them. With a trace buffer, every block stamps each
// phase's GEMV start and end and its barrier arrival and leave.
//
// Rounding points (those of the plain version, fused_layer.cp_frame_plain):
// activations are held in f32 but rounded to the working type T where the
// plain program rounds; every matmul input is rounded to MatIn<T, W> (T for
// plain weights, bf16 for int8, whose bf16 x int8 products are exact in
// f32); int8 column sums are multiplied by their scale once, then rounded
// to T (the JAX package's `acc * scale`); QK-norm and RoPE in T; scores and
// softmax in f32 with the weights rounded to T; SiLU in f32. Activations,
// norms, embeddings and the mtp projection stay in T in the int8 form.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <string.h>

#include "common.cuh"

namespace q3 {

constexpr int kCpMaxRows = 16;        // 2 prefill rows + 14 code rows
constexpr int kFrameThreads = 256;
constexpr int kRingStages = 4;        // fused_layer.CP_FRAME_STAGES
constexpr int kMiscFloats = 1888;     // the misc region's use (see cp_frame_kernel)
constexpr int kSmemLimit = 232448;    // an H100 block's dynamic shared memory

// The projections in the order a pass runs them (fused_layer.CP_FRAME_PROJS).
enum Proj { kMtp, kQkv, kO, kGu, kDown, kHead, kProjs };

struct ProjPlan {
  int nv;         // vectors a block owns (in each half of gate|up)
  int blocks;     // blocks owning vectors: block b has [b*nv, min((b+1)*nv, nvec))
  int tile_rows;  // K rows per ring tile, a multiple of box_rows
  int box_rows;   // K rows per TMA box (a power of two dividing K)
  int box_vecs;   // vectors per TMA box row segment: nv, or 256 columns' worth for a wider slice
  int col_shift;  // set at launch: log2 of the columns of the map's inner dimension (31: the whole row)
};

struct FrameArgs {
  int layers, hidden, heads, kv_heads, head_dim, inter, vocab, embed, groups, mtp;
  int grid, stage_bytes;
  // Byte offsets of the shared-memory regions after the ring (kRingStages
  // slots of stage_bytes): the staged matmul inputs, the column reduction,
  // the column sums, the block's own columns of x, the attention and argmax
  // scratch; and the total.
  int smem_xs, smem_red, smem_cs, smem_own, smem_misc, smem_bytes;
  ProjPlan proj[kProjs];
  float eps, attn_scale;
  const void *etab, *mtp_w, *mtp_b, *qkv_w, *o_w, *gu_w, *down_w, *head_w;
  const float *qkv_s, *o_s, *gu_s, *down_s, *heads_s;  // int8 form; else null
  const void *input_ln, *post_ln, *q_norm, *k_norm, *final_norm;
  const float *cos_t, *sin_t;
  float* scratch;
  unsigned long long* trace;  // null, or [grid][trace_slots(a)] ns stamps
};

// K, the row stride N, and the columns of each half (gate|up has two).
struct ProjGeom {
  int K, N, halves, half_n;
};

__host__ __device__ inline ProjGeom proj_geom(const FrameArgs& a, int j) {
  const int qd = a.heads * a.head_dim, nqkv = qd + 2 * a.kv_heads * a.head_dim;
  switch (j) {
    case kMtp: return {a.embed, a.hidden, 1, a.hidden};
    case kQkv: return {a.hidden, nqkv, 1, nqkv};
    case kO: return {qd, a.hidden, 1, a.hidden};
    case kGu: return {a.hidden, 2 * a.inter, 2, a.inter};
    case kDown: return {a.inter, a.hidden, 1, a.hidden};
    default: return {a.hidden, a.vocab, 1, a.vocab};
  }
}

// A weight vector: 16 bytes of a row, the least a TMA box row may hold
// (4 f32, 8 bf16 or 16 int8 columns).
constexpr int kVecBytes = 16;
template <typename X> struct Vec {
  static constexpr int n = kVecBytes / (int)sizeof(X);
};

// The TMA descriptors of the six projections' weights, each viewed as a
// row-major [rows, N] matrix (layers or heads stacked over rows) with a box
// of [box_rows, nv vectors]; built once per tree (q3_cp_frame_maps).
struct FrameMaps {
  CUtensorMap m[kProjs];
};

// Stamps a block records per phase when tracing: the phase's GEMV start
// (inputs staged) and end (tiles consumed), its barrier arrival and leave.
__host__ __device__ inline int trace_slots(const FrameArgs& a) {
  return a.groups * (a.mtp + 5 * a.layers + 1) * 4;
}

// Scratch (f32 units): the barrier's count, x, the qkv row, the attention row,
// SiLU*up (2 rows each), the K and V caches [L, 16, KV*D], the blocks' bests.
struct FrameLayout {
  size_t bar, x, qkv, attn, act, kc, vc, best_v, best_i, total;
};

__host__ __device__ inline size_t take64(size_t& o, size_t n) {
  const size_t at = o;
  o += (n + 63) / 64 * 64;
  return at;
}

__host__ __device__ inline FrameLayout frame_layout(const FrameArgs& a) {
  FrameLayout L{};
  size_t o = 0;
  const int qd = a.heads * a.head_dim, kvd = a.kv_heads * a.head_dim;
  L.bar = take64(o, 2);  // the barrier's 64-bit arrival count
  L.x = take64(o, 2 * (size_t)a.hidden);
  L.qkv = take64(o, 2 * (size_t)(qd + 2 * kvd));
  L.attn = take64(o, 2 * (size_t)qd);
  L.act = take64(o, 2 * (size_t)a.inter);
  L.kc = take64(o, (size_t)a.layers * kCpMaxRows * kvd);
  L.vc = take64(o, (size_t)a.layers * kCpMaxRows * kvd);
  L.best_v = take64(o, a.grid);
  L.best_i = take64(o, a.grid);
  L.total = o;
  return L;
}

static bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The plan against the dims and this file's constants (vec_t / vec_w:
// columns of a vector of T and of W): the ownership covers every column,
// the TMA boxes and ring tiles are legal, and each shared-memory region
// holds what the kernel puts there (the sizes come from the plan).
static bool frame_ok(const FrameArgs& a, int vec_t, int vec_w) {
  if (a.layers < 1 || a.hidden < 1 || a.inter < 1 || a.vocab < 1 || a.embed < 1 || a.groups < 1) return false;
  if (a.groups + 1 > kCpMaxRows || a.head_dim < 2 || a.head_dim > kFrameThreads || a.head_dim % 2) return false;
  if (a.kv_heads < 1 || a.heads % a.kv_heads || a.heads > a.grid || (!a.mtp && a.embed != a.hidden)) return false;
  if (a.grid < 1 || a.stage_bytes < 16 || a.stage_bytes % 128) return false;
  const long ring = (long)kRingStages * a.stage_bytes;
  const long at[] = {ring, a.smem_xs, a.smem_red, a.smem_cs, a.smem_own, a.smem_misc, a.smem_bytes};
  for (int i = 1; i < 7; ++i)
    if (at[i] < at[i - 1] || at[i] % 16) return false;
  if (a.smem_bytes > kSmemLimit || (long)a.smem_bytes - a.smem_misc < 4l * kMiscFloats) return false;
  // o, down and (where its vectors are as wide) mtp write the same columns of x.
  if (a.proj[kDown].nv != a.proj[kO].nv || (a.mtp && vec_t == vec_w && a.proj[kMtp].nv != a.proj[kO].nv)) return false;
  if (a.smem_misc - a.smem_own < 8l * a.proj[kO].nv * vec_w) return false;
  for (int j = a.mtp ? kMtp : kQkv; j < kProjs; ++j) {
    const ProjGeom g = proj_geom(a, j);
    const ProjPlan& p = a.proj[j];
    const int vec = j == kMtp ? vec_t : vec_w;
    if (g.half_n % vec || !pow2(p.nv) || p.nv * g.halves > kFrameThreads) return false;
    const int nvec = g.half_n / vec, nvt = p.nv * g.halves, groups = nvt < 32 ? 8 : kFrameThreads / nvt;
    if (p.blocks != (nvec + p.nv - 1) / p.nv || p.blocks > a.grid) return false;
    if (!pow2(p.box_rows) || p.box_rows > 256 || g.K % p.box_rows || p.tile_rows % p.box_rows) return false;
    // A box row segment is the slice's nv vectors, or 256 columns of it
    // (then each half's columns are whole segments).
    if (p.box_vecs == p.nv ? p.nv * vec > 256 : p.box_vecs * vec != 256 || p.nv % p.box_vecs || g.half_n % 256)
      return false;
    if (p.box_rows * p.nv * kVecBytes % 128) return false;  // TMA destinations 128-byte aligned
    if (p.tile_rows < 1 || (long)p.tile_rows * nvt * kVecBytes > a.stage_bytes) return false;
    // Two rows each: the staged inputs [K], the reduction [groups][cols], the sums [cols].
    if (a.smem_red - a.smem_xs < 8l * g.K || a.smem_cs - a.smem_red < 8l * groups * nvt * vec ||
        a.smem_own - a.smem_cs < 8l * nvt * vec)
      return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// Device pieces
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The best (value, index) of the warp's lanes into lane 0: the largest
// value, ties to the lowest index (a total order, so any tree gives it).
__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// Vectors block `b` owns of projection j (the last owning block may have fewer).
__device__ __forceinline__ int owned(const FrameArgs& a, int j, int vec) {
  const ProjGeom g = proj_geom(a, j);
  const int nvec = g.half_n / vec, first = blockIdx.x * a.proj[j].nv;
  return first < nvec ? min(a.proj[j].nv, nvec - first) : 0;
}

// The weight stream of one block: every tile of every projection slice the
// block owns, over the whole frame, in the order the block consumes them.
// Thread 0 is the producer: it loads tile q into slot q % kRingStages with
// TMA boxes (one box of box_rows rows per half), and the slot's mbarrier
// completes when all its bytes have landed. A tile's rows lie in shared
// memory as [half][row][nv vectors]. Every map is 3-D, [rows][column
// segments][columns]: a box row of at most 256 columns holds a whole
// slice row (one segment, the whole row: col_shift 31) or 256 columns of
// it (segments of 256 columns), so a box row of any slice lands whole.
template <typename T, typename W>
struct Ring {
  const FrameArgs& a;
  const FrameMaps& maps;
  unsigned char* base;
  uint64_t* full;             // kRingStages mbarriers, one per slot
  int issued = 0, consumed = 0;
  int pass = 0, ph = 0, tile = 0;  // the producer's cursor (thread 0's copy is the one used)
  const int nphase;
  unsigned long long* trace;  // this block's stamps, or null
  int phase_no = 0;           // phases (barriers) the consumer has passed

  __device__ Ring(const FrameArgs& args, const FrameMaps& m, unsigned char* ring, uint64_t* bars)
      : a(args), maps(m), base(ring), full(bars), nphase(args.mtp + 4 * args.layers + 1),
        trace(args.trace ? args.trace + (size_t)blockIdx.x * trace_slots(args) : nullptr) {}

  // Stamp k of the current phase (0: GEMV start, 1: GEMV end).
  __device__ void mark(int k) const {
    if (trace && threadIdx.x == 0) trace[phase_no * 4 + k] = global_ns();
  }

  // The barrier that ends the current phase.
  __device__ void sync(unsigned long long* bar) {
    grid_sync(bar, a.grid, trace ? trace + phase_no * 4 + 2 : nullptr);
    ++phase_no;
  }

  __device__ int proj_at(int phase, int& layer) const {
    layer = 0;
    if (a.mtp && phase == 0) return kMtp;
    const int q = phase - a.mtp;
    if (q < 4 * a.layers) {
      layer = q / 4;
      return kQkv + q % 4;
    }
    return kHead;
  }

  __device__ int tiles(int j) const {
    const int vec = j == kMtp ? Vec<T>::n : Vec<W>::n;
    if (!owned(a, j, vec)) return 0;
    const int k = proj_geom(a, j).K, r = a.proj[j].tile_rows;
    return (k + r - 1) / r;
  }

  // The first row of projection j's slice in its map's [rows, N] view.
  __device__ int first_row(int j, int layer) const {
    switch (j) {
      case kQkv: case kGu: return layer * a.hidden;
      case kO: return layer * a.heads * a.head_dim;
      case kDown: return layer * a.inter;
      case kHead: return pass * a.hidden;
      default: return 0;
    }
  }

  // Thread 0: the next tile of the frame into the next slot, if any is left.
  __device__ void issue() {
    while (pass < a.groups) {
      int layer;
      const int j = proj_at(ph, layer);
      if (tile < tiles(j)) {
        const ProjGeom g = proj_geom(a, j);
        const ProjPlan& p = a.proj[j];
        const int vec = j == kMtp ? Vec<T>::n : Vec<W>::n, slot = issued % kRingStages;
        const int k0 = tile * p.tile_rows, rows = min(p.tile_rows, g.K - k0), half_bytes = rows * p.nv * kVecBytes;
        const int row0 = first_row(j, layer) + k0, col0 = blockIdx.x * p.nv * vec;
        unsigned char* dst = base + (size_t)slot * a.stage_bytes;
        mbar_arrive_expect_tx(full + slot, half_bytes * g.halves);
        for (int h = 0; h < g.halves; ++h) {
          const int col = h * g.half_n + col0;
          for (int r = 0; r < rows; r += p.box_rows)
            tma_load_3d(dst + h * half_bytes + r * p.nv * kVecBytes, &maps.m[j], col & ((1u << p.col_shift) - 1u),
                        col >> p.col_shift, row0 + r, full + slot);
        }
        ++tile;
        ++issued;
        return;
      }
      tile = 0;
      if (++ph == nphase) {
        ph = 0;
        ++pass;
      }
    }
  }
};

struct FrameSmem {
  unsigned char* ring;
  float *xs, *red, *cs, *xown, *misc;
};

// Sums over the row lanes of each owned column, in a fixed order: within a
// warp by an xor butterfly over the lanes of one vector, then over the
// warps (or row lanes) in index order. cs[n][v * VEC + i] for the nvt
// vectors of the block.
template <int VEC, int NR>
__device__ void reduce_cols(float (&acc)[NR][VEC], int nvt, float* red, float* cs) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, v = t & (nvt - 1), cols = nvt * VEC;
  int groups;
  if (nvt < 32) {
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
#pragma unroll
    for (int n = 0; n < NR; ++n) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) red[(n * groups + g) * cols + v * VEC + i] = acc[n][i];
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

// The block's column sums of projection j over the staged inputs xs [NR][K],
// consuming its tiles from the ring (and refilling it) as they land.
template <typename T, typename W, typename X, int NR>
__device__ void gemv_proj(Ring<T, W>& ring, int j, const FrameSmem& s) {
  constexpr int VEC = Vec<X>::n;
  const FrameArgs& a = ring.a;
  const ProjGeom g = proj_geom(a, j);
  const ProjPlan& p = a.proj[j];
  const int nvt = p.nv * g.halves, t = threadIdx.x, v = t & (nvt - 1), nrl = kFrameThreads / nvt;
  const bool live = v % p.nv < owned(a, j, VEC);
  float acc[NR][VEC];
#pragma unroll
  for (int n = 0; n < NR; ++n) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[n][i] = 0.f;
  }
  const int ntiles = (g.K + p.tile_rows - 1) / p.tile_rows, h = v / p.nv, vv = v - h * p.nv;
  ring.mark(0);
  for (int q = 0; q < ntiles; ++q) {
    const int slot = ring.consumed % kRingStages;
    while (!mbar_try_wait(ring.full + slot, (ring.consumed / kRingStages) & 1)) {
    }
    __syncthreads();  // every thread is done with the slot of the tile before this one
    if (t == 0) ring.issue();  // into that slot
    ++ring.consumed;
    if (!live) continue;
    const int k0 = q * p.tile_rows, rows = min(p.tile_rows, g.K - k0);
    const unsigned char* tile = ring.base + (size_t)slot * a.stage_bytes + (size_t)h * rows * p.nv * kVecBytes;
    for (int r = t / nvt; r < rows; r += nrl) {
      float w[VEC];
      lds_w<X>(tile + (size_t)(r * p.nv + vv) * kVecBytes, w);
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        const float xv = s.xs[n * g.K + k0 + r];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[n][i] = fmaf(xv, w[i], acc[n][i]);
      }
    }
  }
  ring.mark(1);
  reduce_cols<VEC, NR>(acc, nvt, s.red, s.cs);
}

// xs[n][k] <- the matmul input M of RMSNorm(row n) with weight ln (rounded
// to T first), rows from the f32 scratch `xg` or, when it is null, the T
// rows `rows`. Every block computes the same sum of squares.
template <typename T, typename M, int NR>
__device__ void stage_rmsnorm(const float* xg, const T* const* rows, int H, const T* ln, float eps,
                              const FrameSmem& s) {
  float* buf = s.misc + 1312;
  for (int n = 0; n < NR; ++n) {
    float* xs = s.xs + n * H;
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

// xs[n][k] <- round_M(src[n][k]) for an f32 scratch row pair of width K.
template <typename M, int NR>
__device__ void stage_scratch(const float* src, int K, const FrameSmem& s) {
  for (int c = threadIdx.x; c < NR * K; c += kFrameThreads) s.xs[c] = round_to<M>(__ldcg(src + c));
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

// Block h = q head h, for the pass's NR rows at positions pos0 ...: q and
// its kv head's k (QK-norm, RoPE) and v from the qkv row, k and v appended
// to the layer's cache at row pos (by the first q head of each kv group),
// then causal GQA over rows 0..pos: rows < pos0 from the cache (written by
// earlier passes), the pass's own rows from registers; f32 scores and
// softmax, weights rounded to T. Thread t < D holds dimension t of every
// row; everything the block reads from L2 is loaded at once, and the norms
// and the scores are each one block reduction.
template <typename T, int NR>
__device__ void attention(const FrameArgs& a, int layer, int pos0, const float* qkvg, float* attn, float* kc,
                          float* vc, const FrameSmem& s) {
  constexpr int R = kCpMaxRows;
  const int D = a.head_dim, half = D / 2, Hq = a.heads, group = Hq / a.kv_heads, kvd = a.kv_heads * D;
  const int qd = Hq * D, N = qd + 2 * kvd, h = blockIdx.x, t = threadIdx.x, col = (h / group) * D + t;
  const bool live = t < D;
  float *xch = s.misc, *buf = s.misc + 1024, *out = s.misc + 1280;
  const T* qn = static_cast<const T*>(a.q_norm) + (size_t)layer * D;
  const T* kn = static_cast<const T*>(a.k_norm) + (size_t)layer * D;
  kc += (size_t)layer * R * kvd;
  vc += (size_t)layer * R * kvd;

  float qv[NR], kv[NR], vv[NR], kr[R], vr[R];
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    const float* row = qkvg + n * N;
    qv[n] = live ? __ldcg(row + h * D + t) : 0.f;
    kv[n] = live ? __ldcg(row + qd + col) : 0.f;
    vv[n] = live ? __ldcg(row + qd + kvd + col) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    kr[r] = live && r < pos0 ? __ldcg(kc + (size_t)r * kvd + col) : 0.f;
    vr[r] = live && r < pos0 ? __ldcg(vc + (size_t)r * kvd + col) : 0.f;
  }

  // QK-norm (RMSNorm over the head, rounded to T), then split-half RoPE.
  float ss[2 * NR];
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    ss[2 * n] = qv[n] * qv[n];
    ss[2 * n + 1] = kv[n] * kv[n];
  }
  block_sums<2 * NR>(ss, buf, out);
  if (live) {
#pragma unroll
    for (int j = 0; j < 2 * NR; ++j) {
      const float x = j & 1 ? kv[j / 2] : qv[j / 2], w = to_float<T>((j & 1 ? kn : qn)[t]);
      const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss[j], 1.f / D), a.eps));
      xch[j * 256 + t] = round_to<T>(__fmul_rn(__fmul_rn(x, inv), w));
    }
  }
  __syncthreads();
  float q[NR], k[NR];
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    q[n] = k[n] = 0.f;
    if (!live) continue;
    const int f = t < half ? t : t - half, pos = pos0 + n;
    const float c = round_to<T>(a.cos_t[(size_t)pos * half + f]), sn = round_to<T>(a.sin_t[(size_t)pos * half + f]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* x = xch + (2 * n + j) * 256;
      const float y = t < half ? sub_t<T>(mul_t<T>(x[t], c), mul_t<T>(x[t + half], sn))
                               : add_t<T>(mul_t<T>(x[t], c), mul_t<T>(x[t - half], sn));
      if (j)
        k[n] = y;
      else
        q[n] = y;
    }
    if (h % group == 0) {
      kc[(size_t)pos * kvd + col] = k[n];
      vc[(size_t)pos * kvd + col] = vv[n];
    }
  }

  // Scores of each row against every row up to it, in one reduction.
  float sc[NR * R];
#pragma unroll
  for (int n = 0; n < NR; ++n) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float key = kr[r];
      if (r == pos0) key = k[0];
      if constexpr (NR == 2) {
        if (r == pos0 + 1) key = k[1];
      }
      sc[n * R + r] = r <= pos0 + n ? q[n] * key : 0.f;
    }
  }
  block_sums<NR * R>(sc, buf, out);
#pragma unroll
  for (int n = 0; n < NR; ++n) {
    const int pos = pos0 + n;
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sc[n * R + r] = __fmul_rn(sc[n * R + r], a.attn_scale);
      if (r <= pos) m = fmaxf(m, sc[n * R + r]);
    }
    float den = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r <= pos) den += expf(__fsub_rn(sc[n * R + r], m));
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r > pos) continue;
      float val = vr[r];
      if (r == pos0) val = vv[0];
      if constexpr (NR == 2) {
        if (r == pos0 + 1) val = vv[1];
      }
      acc = fmaf(round_to<T>(__fdiv_rn(expf(__fsub_rn(sc[n * R + r], m)), den)), val, acc);
    }
    if (live) attn[n * qd + h * D + t] = round_to<T>(acc);
  }
}

// The argmax over the head blocks' bests, finished by every block alike.
__device__ int frame_argmax(const float* best_v, const int* best_i, int n, int vocab, int* slot) {
  if (threadIdx.x < 32) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = threadIdx.x; i < n; i += 32) {
      const float v = __ldcg(best_v + i);
      const int idx = __ldcg(best_i + i);
      if (better(v, idx, bv, bi)) {
        bv = v;
        bi = idx;
      }
    }
    warp_best(bv, bi);
    if (threadIdx.x == 0) *slot = bi < vocab ? bi : 0;  // no finite logit: code 0
  }
  __syncthreads();
  return *slot;
}

// One pass: NR rows (the 2 prefill rows, or one code row) at positions
// pos0 ..., through the mtp projection, every layer and head `pass`; leaves
// each head block's best in the scratch (after the final barrier).
template <typename T, typename W, int NR>
__device__ void frame_pass(Ring<T, W>& ring, const FrameSmem& s, const T* const (&rows)[NR], int pass, int pos0) {
  using M = typename MatIn<T, W>::type;
  constexpr int VT = Vec<T>::n, VW = Vec<W>::n;
  const FrameArgs& a = ring.a;
  const FrameLayout L = frame_layout(a);
  float* sc = a.scratch;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(sc + L.bar);
  float *xg = sc + L.x, *qkvg = sc + L.qkv, *attn = sc + L.attn, *act = sc + L.act;
  const int H = a.hidden, I = a.inter, qd = a.heads * a.head_dim, nqkv = proj_geom(a, kQkv).N;
  const int b = blockIdx.x, t = threadIdx.x;
  auto srow = [](const float* p, size_t off) { return p ? p + off : nullptr; };

  if (a.mtp) {  // x <- round(round(row @ mtp_w) + mtp_b)
    const int own = owned(a, kMtp, VT), cols = a.proj[kMtp].nv * VT;
    if (own) {
      for (int c = t; c < NR * a.embed; c += kFrameThreads)
        s.xs[c] = to_float<T>(rows[c / a.embed][c % a.embed]);
      __syncthreads();
      gemv_proj<T, W, T, NR>(ring, kMtp, s);
      const T* bias = static_cast<const T*>(a.mtp_b);
      for (int c = t; c < NR * cols; c += kFrameThreads) {
        const int n = c / cols, cc = c - n * cols, col = b * cols + cc;
        if (cc >= own * VT) continue;
        const float x = add_t<T>(round_to<T>(s.cs[c]), to_float<T>(bias[col]));
        xg[n * H + col] = x;
        if (VT == VW) s.xown[c] = x;  // the same columns as o and down
      }
    }
    ring.sync(bar);
  }

  for (int l = 0; l < a.layers; ++l) {
    const bool from_rows = !a.mtp && l == 0;  // x is still the embedding row
    // RMSNorm -> qkv.
    if (const int own = owned(a, kQkv, VW)) {
      const int cols = a.proj[kQkv].nv * VW;
      stage_rmsnorm<T, M, NR>(from_rows ? nullptr : xg, rows, H, static_cast<const T*>(a.input_ln) + (size_t)l * H,
                              a.eps, s);
      gemv_proj<T, W, W, NR>(ring, kQkv, s);
      const float* scale = srow(a.qkv_s, (size_t)l * nqkv);
      for (int c = t; c < NR * cols; c += kFrameThreads) {
        const int n = c / cols, cc = c - n * cols, col = b * cols + cc;
        if (cc < own * VW) qkvg[n * nqkv + col] = round_to<T>(scaled(s.cs[c], scale, col));
      }
    }
    ring.sync(bar);
    // QK-norm + RoPE + KV append + GQA.
    if (b < a.heads)
      attention<T, NR>(a, l, pos0, qkvg, attn, a.scratch + L.kc, a.scratch + L.vc, s);
    ring.sync(bar);
    // o + residual.
    if (const int own = owned(a, kO, VW)) {
      const int cols = a.proj[kO].nv * VW;
      stage_scratch<M, NR>(attn, qd, s);
      gemv_proj<T, W, W, NR>(ring, kO, s);
      const float* scale = srow(a.o_s, (size_t)l * H);
      for (int c = t; c < NR * cols; c += kFrameThreads) {
        const int n = c / cols, cc = c - n * cols, col = b * cols + cc;
        if (cc >= own * VW) continue;
        const float res = from_rows                ? to_float<T>(rows[n][col])
                          : l == 0 && VT != VW     ? __ldcg(xg + n * H + col)
                                                   : s.xown[c];
        xg[n * H + col] = s.xown[c] = add_t<T>(res, round_to<T>(scaled(s.cs[c], scale, col)));
      }
    }
    ring.sync(bar);
    // RMSNorm -> gate|up -> SiLU(gate) * up.
    if (const int own = owned(a, kGu, VW)) {
      const int cols = a.proj[kGu].nv * VW;
      stage_rmsnorm<T, M, NR>(xg, rows, H, static_cast<const T*>(a.post_ln) + (size_t)l * H, a.eps, s);
      gemv_proj<T, W, W, NR>(ring, kGu, s);
      const float* scale = srow(a.gu_s, (size_t)l * 2 * I);
      for (int c = t; c < NR * cols; c += kFrameThreads) {
        const int n = c / cols, cc = c - n * cols, i = b * cols + cc;
        if (cc >= own * VW) continue;
        const float gate = round_to<T>(scaled(s.cs[n * 2 * cols + cc], scale, i));
        const float up = round_to<T>(scaled(s.cs[n * 2 * cols + cols + cc], scale, I + i));
        act[n * I + i] = mul_t<T>(round_to<T>(__fdiv_rn(gate, __fadd_rn(1.f, expf(-gate)))), up);
      }
    }
    ring.sync(bar);
    // down + residual.
    if (const int own = owned(a, kDown, VW)) {
      const int cols = a.proj[kDown].nv * VW;
      stage_scratch<M, NR>(act, I, s);
      gemv_proj<T, W, W, NR>(ring, kDown, s);
      const float* scale = srow(a.down_s, (size_t)l * H);
      for (int c = t; c < NR * cols; c += kFrameThreads) {
        const int n = c / cols, cc = c - n * cols, col = b * cols + cc;
        if (cc < own * VW) xg[n * H + col] = s.xown[c] = add_t<T>(s.xown[c], round_to<T>(scaled(s.cs[c], scale, col)));
      }
    }
    ring.sync(bar);
  }

  // Final norm -> head on the pass's last row -> this block's best.
  if (const int own = owned(a, kHead, VW)) {
    const int cols = a.proj[kHead].nv * VW;
    stage_rmsnorm<T, M, 1>(xg + (NR - 1) * H, nullptr, H, static_cast<const T*>(a.final_norm), a.eps, s);
    gemv_proj<T, W, W, 1>(ring, kHead, s);
    const float* scale = srow(a.heads_s, (size_t)pass * a.vocab);
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int c = t; c < own * VW; c += kFrameThreads) {
      const int col = b * cols + c;
      const float v = round_to<T>(scaled(s.cs[c], scale, col));
      if (better(v, col, bv, bi)) {
        bv = v;
        bi = col;
      }
    }
    warp_best(bv, bi);
    float* sv = s.misc + 1344;
    int* si = reinterpret_cast<int*>(s.misc + 1600);
    if ((t & 31) == 0) {
      sv[t >> 5] = bv;
      si[t >> 5] = bi;
    }
    __syncthreads();
    if (t < 32) {
      bv = t < kFrameThreads / 32 ? sv[t] : -INFINITY;
      bi = t < kFrameThreads / 32 ? si[t] : 0x7fffffff;
      warp_best(bv, bi);
      if (t == 0) {
        sc[L.best_v + b] = bv;
        reinterpret_cast<int*>(sc + L.best_i)[b] = bi;
      }
    }
  }
  ring.sync(bar);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kFrameThreads, 1)
cp_frame_kernel(const FrameArgs a, const __grid_constant__ FrameMaps maps, const T* __restrict__ hidden,
                const T* __restrict__ semantic, int* __restrict__ codes) {
  extern __shared__ __align__(128) unsigned char smem[];
  FrameSmem s;
  s.ring = smem;
  s.xs = reinterpret_cast<float*>(smem + a.smem_xs);
  s.red = reinterpret_cast<float*>(smem + a.smem_red);
  s.cs = reinterpret_cast<float*>(smem + a.smem_cs);
  s.xown = reinterpret_cast<float*>(smem + a.smem_own);
  s.misc = reinterpret_cast<float*>(smem + a.smem_misc);
  // misc (floats): [0, 1312) attention, [1312, 1344) stage_rmsnorm's sum,
  // [1344, 1856) the head's per-warp bests, 1856 the code, [1872, 1888) the
  // ring's mbarriers.
  int* code_slot = reinterpret_cast<int*>(s.misc + 1856);
  uint64_t* full = reinterpret_cast<uint64_t*>(s.misc + 1872);
  const FrameLayout L = frame_layout(a);

  Ring<T, W> ring(a, maps, s.ring, full);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRingStages; ++i) mbar_init(full + i, 1);
    fence_mbar_init();
    for (int i = 0; i < kRingStages - 1; ++i) ring.issue();
  }
  __syncthreads();
  int code = 0;
  for (int p = 0; p < a.groups; ++p) {
    if (p == 0) {
      const T* const rows[2] = {hidden, semantic};
      frame_pass<T, W, 2>(ring, s, rows, 0, 0);
    } else {  // group p-1's embedding of code p-1
      const T* const rows[1] = {static_cast<const T*>(a.etab) + ((size_t)(p - 1) * a.vocab + code) * a.embed};
      frame_pass<T, W, 1>(ring, s, rows, p, p + 1);
    }
    code = frame_argmax(a.scratch + L.best_v, reinterpret_cast<const int*>(a.scratch + L.best_i),
                        a.proj[kHead].blocks, a.vocab, code_slot);
    if (blockIdx.x == 0 && threadIdx.x == 0) codes[p] = code;
  }
}

// log2 of the columns of projection j's map's inner dimension (31: the row).
static int col_shift(const ProjPlan& p, int vec) {
  int s = 0;
  while (p.box_vecs != p.nv && (1 << s) < p.box_vecs * vec) ++s;
  return p.box_vecs == p.nv ? 31 : s;
}

template <typename T, typename W>
static cudaError_t launch_frame(FrameArgs a, const FrameMaps& maps, const void* hidden, const void* semantic,
                                int* codes, cudaStream_t st) {
  if (!frame_ok(a, Vec<T>::n, Vec<W>::n)) return cudaErrorInvalidValue;
  for (int j = 0; j < kProjs; ++j) a.proj[j].col_shift = col_shift(a.proj[j], j == kMtp ? Vec<T>::n : Vec<W>::n);
  static int smem_set = 0;  // the attribute, once per instantiation (never during a graph capture)
  if (a.smem_bytes > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(cp_frame_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (e != cudaSuccess) return e;
    smem_set = a.smem_bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.grid);
  cfg.blockDim = dim3(kFrameThreads);
  cfg.dynamicSmemBytes = a.smem_bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // all blocks co-resident, or the launch is refused
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, cp_frame_kernel<T, W>, a, maps, static_cast<const T*>(hidden),
                            static_cast<const T*>(semantic), codes);
}

// The TMA descriptor of each projection's weights, its [rows, N] matrix of
// its element type (T for the mtp projection, W for the rest) viewed as
// [rows][N / S segments][S columns], S = N (one segment) where a slice row
// fits a box row, else 256; boxes of [box_rows][nv vectors / S][S or nv
// vectors], no swizzle (a box lands as its rows one after another).
static cudaError_t encode_maps(const FrameArgs& a, int dtype, int int8, FrameMaps* out) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const CUtensorMapDataType t_type = dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType w_type = int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : t_type;
  const int t_item = dtype == 0 ? 4 : 2, w_item = int8 ? 1 : t_item;
  const int qd = a.heads * a.head_dim;
  *out = FrameMaps{};
  for (int j = a.mtp ? kMtp : kQkv; j < kProjs; ++j) {
    const ProjGeom g = proj_geom(a, j);
    const ProjPlan& p = a.proj[j];
    const int item = j == kMtp ? t_item : w_item;
    const void* base[kProjs] = {a.mtp_w, a.qkv_w, a.o_w, a.gu_w, a.down_w, a.head_w};
    const size_t rows[kProjs] = {(size_t)a.embed, (size_t)a.layers * a.hidden, (size_t)a.layers * qd,
                                 (size_t)a.layers * a.hidden, (size_t)a.layers * a.inter, (size_t)a.groups * a.hidden};
    const int seg = p.box_vecs == p.nv ? g.N : p.box_vecs * kVecBytes / item;  // columns of a segment
    const cuuint64_t dims[3] = {(cuuint64_t)seg, (cuuint64_t)(g.N / seg), (cuuint64_t)rows[j]};
    const cuuint64_t strides[2] = {(cuuint64_t)seg * item, (cuuint64_t)g.N * item};
    const cuuint32_t box[3] = {(cuuint32_t)(p.box_vecs * kVecBytes / item), (cuuint32_t)(p.nv / p.box_vecs),
                               (cuuint32_t)p.box_rows};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult r = encode(&out->m[j], j == kMtp ? t_type : w_type, 3, const_cast<void*>(base[j]), dims, strides,
                              box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

static FrameArgs unpack(const int* n, const float* f, const void* const* p) {
  FrameArgs a{};
  a.layers = n[0]; a.hidden = n[1]; a.heads = n[2]; a.kv_heads = n[3]; a.head_dim = n[4];
  a.inter = n[5]; a.vocab = n[6]; a.embed = n[7]; a.groups = n[8]; a.mtp = n[9];
  a.grid = n[10]; a.stage_bytes = n[11]; a.smem_xs = n[12]; a.smem_red = n[13]; a.smem_cs = n[14];
  a.smem_own = n[15]; a.smem_misc = n[16]; a.smem_bytes = n[17];
  for (int j = 0; j < kProjs; ++j) {
    const int* q = n + 18 + 5 * j;
    a.proj[j] = ProjPlan{q[0], q[1], q[2], q[3], q[4], 31};
  }
  if (!a.mtp) a.proj[kMtp] = ProjPlan{1, 0, 1, 1, 1, 31};
  a.eps = f ? f[0] : 0.f;
  a.attn_scale = a.head_dim > 0 ? (float)(1.0 / sqrt((double)a.head_dim)) : 0.f;  // as Python rounds 1/sqrt(D)
  if (p) {
    a.etab = p[0]; a.mtp_w = p[1]; a.mtp_b = p[2]; a.qkv_w = p[3]; a.o_w = p[4]; a.gu_w = p[5];
    a.down_w = p[6]; a.head_w = p[7];
    a.qkv_s = static_cast<const float*>(p[8]); a.o_s = static_cast<const float*>(p[9]);
    a.gu_s = static_cast<const float*>(p[10]); a.down_s = static_cast<const float*>(p[11]);
    a.heads_s = static_cast<const float*>(p[12]);
    a.input_ln = p[13]; a.post_ln = p[14]; a.q_norm = p[15]; a.k_norm = p[16]; a.final_norm = p[17];
    a.cos_t = static_cast<const float*>(p[18]); a.sin_t = static_cast<const float*>(p[19]);
    a.scratch = static_cast<float*>(const_cast<void*>(p[20]));
  }
  return a;
}

}  // namespace q3

extern "C" {

// Floats of f32 scratch a frame needs for the dims and plan in `ints` (the
// layout of q3_cp_frame). The scratch must be zeroed once before the first
// frame (its barrier words); frames leave it ready for the next one.
size_t q3_cp_frame_scratch_floats(const int* ints) {
  return q3::frame_layout(q3::unpack(ints, nullptr, nullptr)).total;
}

// The TMA descriptors of a tree's weights (ints and ptrs as q3_cp_frame)
// into `maps` (q3_cp_frame_maps_bytes of host memory), built once per tree
// and handed to every q3_cp_frame of it. Returns a CUDA error.
size_t q3_cp_frame_maps_bytes() { return sizeof(q3::FrameMaps); }

int q3_cp_frame_maps(int dtype, int int8, const int* ints, const void* const* ptrs, void* maps) {
  const q3::FrameArgs a = q3::unpack(ints, nullptr, ptrs);
  q3::FrameMaps m;
  const cudaError_t e = q3::encode_maps(a, dtype, int8, &m);
  if (e == cudaSuccess) memcpy(maps, &m, sizeof m);
  return (int)e;
}

// Stamps one block records per frame when tracing: 4 per phase (GEMV
// start, GEMV end, barrier arrival, barrier leave; 0 where the block has
// no GEMV in the phase), phases in the order the frame runs them.
int q3_cp_frame_trace_slots(const int* ints) { return q3::trace_slots(q3::unpack(ints, nullptr, nullptr)); }

// All `groups` acoustic codes of one frame into `codes` (int32 [groups], on
// device), in one cooperative launch on `stream`. dtype 0 = f32, 1 = bf16
// for activations, norms, embeddings and the mtp projection; int8 = 0: the
// layer projections and heads in that dtype too, and the five scale
// pointers null; int8 = 1: those weights int8 with f32 per-column scales.
// ints: layers, hidden, heads, kv_heads, head_dim, inter, vocab, embed,
// groups, mtp, then the plan (fused_layer.cp_frame_plan): grid,
// stage_bytes, the byte offsets of the shared-memory regions (xs, red, cs,
// own, misc) and the total, and (nv, blocks, tile_rows, box_rows,
// box_vecs) of mtp, qkv, o, gate|up, down, head. floats: eps. ptrs: etab
// [G, V, E], mtp_w [E, H], mtp_b [H] (both null without), qkv_w
// [L, H, (Hq+2KV)*D], o_w [L, Hq*D, H], gu_w [L, H, 2I], down_w [L, I, H],
// heads [G, H, V], the scales qkv_s [L, (Hq+2KV)*D], o_s [L, H], gu_s
// [L, 2I], down_s [L, H], heads_s [G, V], input_ln / post_ln [L, H],
// q_norm / k_norm [L, D], final_norm [H], cos_t / sin_t [16, D/2] f32,
// scratch. maps: what q3_cp_frame_maps made of the
// same ints and ptrs. hidden, semantic: [E] each. Every weight pointer
// 16-byte aligned. trace: null, or [grid][q3_cp_frame_trace_slots] u64 that
// every block fills with its phases' stamps (ns, %globaltimer). Returns the
// CUDA error of the launch (a plan or shape the kernel does not take:
// cudaErrorInvalidValue).
int q3_cp_frame(int dtype, int int8, const int* ints, const float* floats, const void* const* ptrs,
                const void* maps, const void* hidden, const void* semantic, int* codes, unsigned long long* trace,
                void* stream) {
  q3::FrameArgs a = q3::unpack(ints, floats, ptrs);
  a.trace = trace;
  q3::FrameMaps m;
  memcpy(&m, maps, sizeof m);
  if (int8 && !(a.qkv_s && a.o_s && a.gu_s && a.down_s && a.heads_s)) return (int)cudaErrorInvalidValue;
  if (!int8 && (a.qkv_s || a.o_s || a.gu_s || a.down_s || a.heads_s)) return (int)cudaErrorInvalidValue;
  if (!a.mtp != !a.mtp_w || !a.mtp != !a.mtp_b) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (int8)
    e = dtype == 0 ? q3::launch_frame<float, int8_t>(a, m, hidden, semantic, codes, st)
                   : q3::launch_frame<__nv_bfloat16, int8_t>(a, m, hidden, semantic, codes, st);
  else
    e = dtype == 0 ? q3::launch_frame<float, float>(a, m, hidden, semantic, codes, st)
                   : q3::launch_frame<__nv_bfloat16, __nv_bfloat16>(a, m, hidden, semantic, codes, st);
  return (int)e;
}

}  // extern "C"
