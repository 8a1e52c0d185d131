// Kernels 5 and 6 of the port: one int8 attention sub-layer step and one
// int8 MLP sub-layer step of a decoder layer, batch 1, each in one
// persistent cooperative launch.
//
// Replace the TPU kernels qwen3_tts_tpu/ops/fused_layer.py:
// _attention_step_kernel (entry fused_attention_step) and _mlp_step_kernel
// (entry fused_mlp_step): RMSNorm -> int8 qkv -> QK-norm -> RoPE -> cache
// row `pos` -> GQA over the rows <= pos -> int8 o -> (+x), and RMSNorm ->
// int8 gate|up -> SiLU*up -> int8 down -> (+x). residual = 0 returns the
// bare o / down output: the tensor-parallel step adds the chips' partials
// before the residual.
//
// What bounds them on an H100: at the 1.7B code predictor's widths the
// attention step reads 6.29 MB of int8 weights (qkv [1024, 4096], o [2048,
// 1024]; ~1.9 us at 3.35 TB/s) and the MLP step 8.65 MB at intermediate
// 2816 (gate|up [1024, 5632], down [2816, 1024]; ~2.6 us), with a few KB of
// activations and at most 17 cache rows; one GEMV per projection at batch 1,
// so bytes, not flops. A call's weights are all it reads, so its time is
// the phases' latencies: the launch, the first tiles' arrival, the grid
// barriers between dependent phases, attention.
//
// Design: kernel 3's machinery (persistent.cuh), one launch a call of
// `grid` co-resident blocks (one per SM), 256 threads each, walking its
// phases between grid barriers. Kernel 5: (1) RMSNorm staged into the qkv
// GEMV; (2) per (q head, chunk of the rows <= pos): QK-norm, RoPE with
// cos/sin rounded to T, row `pos` of K and V written (by the first q head
// of its kv head, in the last chunk: the only row written), the chunk's
// scores, their maximum m and weight sum l = sum exp(s - m); (3) the
// normalised weights round_T(exp(s - M) / L), M and L the head's over all
// chunks (read after a barrier; with one chunk, the block's own and no
// barrier), the chunk's weighted value sum, and the head's last chunk block
// (a counter per head) adds the chunks in chunk order, rounded to T; (4)
// the o GEMV, times the scale, rounded to T, then x + o or o alone. Kernel
// 6: (1) RMSNorm -> gate|up, each block owning the same columns of both
// halves, SiLU in f32 rounded to T, times up; (2) down, times the scale,
// rounded to T, then (+x). Each projection's output columns are cut into
// groups of `nv` vectors of 16 int8 columns (the plan's,
// ops/fused_layer.py:fused_step_plan), block g owning group g over the
// whole K and summing it in a fixed order in the block: no float atomics
// and no partials added across blocks in a varying order, so a call is
// bit-reproducible. The weights do not depend on the activations: thread 0
// streams every tile of the block's slices of both projections of the
// call, in order, through a ring of kFsStages shared-memory tiles filled by
// TMA boxes of 4-D maps of the [L][K][N] weights (built once per tree, a
// tile one copy a half, each slot completing on its own mbarrier),
// kFsStages - 1 tiles ahead: the first projection's tiles at the start,
// the second's as the first's are consumed, so o's (or down's) tiles are in
// flight while the block does attention (or waits at the barrier). Activations between phases (the qkv row, the attention
// row, SiLU*up, the chunks' statistics and sums) live in the f32 scratch
// and are read through L2 (__ldcg). With a trace buffer every block stamps
// each phase's work start and end and its barrier arrival and leave.
//
// Rounding points (those of fused_layer._attention_plain / _mlp_plain with
// k_chunk None, held to the JAX kernels): every int8 matmul input rounded
// to bf16 (exact bf16 x int8 products in f32), its f32 column sum times the
// scale rounded to T (o and down one flat sum over K); QK-norm in f32
// rounded to T; RoPE in T with cos/sin rounded to T; scores f32, the
// softmax weights normalised before they are rounded to T for the value
// sum; the attention output rounded to T; SiLU in f32 rounded to T, times
// up in T. The cache is written at row `pos` only and read at the rows <=
// pos only.

#include <string.h>

#include "persistent.cuh"

namespace q3 {

constexpr int kFsStages = 4;          // fused_layer.FUSED_STEP_STAGES
constexpr int kFsMaxChunks = 32;      // attention chunks of a head, at most
constexpr int kFsChunkRows = 64;      // cache rows of an attention chunk, at least (unless fewer are live)
constexpr int kFsMaxHeadDim = 256;    // an element of q and one of k a thread (two a thread)
constexpr int kFsMiscFixed = 4096;    // misc floats before the chunk's scores
constexpr int kFsPhases = 4;          // phases a call stamps (kernel 6 uses the first 2)

// The projections (fused_layer.FUSED_STEP_PROJS); kernel 5 streams the
// first two, kernel 6 the last two.
enum FsProj { kFQkv, kFO, kFGu, kFDown, kFsProjs };

struct FsProjPlan {
  int nv;         // 16-byte vectors of each half a column group holds (the last group may hold fewer)
  int groups;     // column groups (blocks): group g holds vectors [g*nv, min((g+1)*nv, N/halves/16))
  int tile_rows;  // K rows per ring tile: a multiple of box_rows (at most 256 of them) that divides K
  int box_rows;   // K rows per box row group of the 4-D map (a power of two dividing K)
};

struct FsArgs {
  int layers, hidden, heads, kv_heads, head_dim, inter, max_seq;
  int grid, stage_bytes, max_chunks;
  // Byte offsets of the shared-memory regions after the ring (kFsStages
  // slots of stage_bytes): the staged matmul input, the column reduction,
  // the column sums, the attention scratch; and the total.
  int smem_xs, smem_red, smem_cs, smem_misc, smem_bytes;
  FsProjPlan proj[kFsProjs];
  float eps, attn_scale;
  const int8_t* w[kFsProjs];   // [L, K, N]
  const float* s[kFsProjs];    // [L, N]
  const void *input_ln, *post_ln, *q_norm, *k_norm;  // [L, H], [L, H], [L, D], [L, D]
  float* scratch;
  // The call's: layer, x [H], y [H], the layer's caches [seq, KV*D], the
  // row written, the RoPE tables [>= pos+1, D/2], the stamps (null, or
  // [grid][kFsPhases * 4]).
  int layer, residual, seq, pos;
  const void* x;
  void* y;
  void *ck, *cv;
  const float *cos_t, *sin_t;
  unsigned long long* trace;
};

// K, the row stride N, the halves (gate|up has two) and each half's columns.
struct FsGeom {
  int K, N, halves, half_n;
};

__host__ __device__ inline FsGeom fs_geom(const FsArgs& a, int j) {
  const int qd = a.heads * a.head_dim, nqkv = qd + 2 * a.kv_heads * a.head_dim;
  switch (j) {
    case kFQkv: return {a.hidden, nqkv, 1, nqkv};
    case kFO: return {qd, a.hidden, 1, a.hidden};
    case kFGu: return {a.hidden, 2 * a.inter, 2, a.inter};
    default: return {a.inter, a.hidden, 1, a.hidden};
  }
}

// The TMA descriptors of the four projections' weights, each viewed as
// [L][K / box_rows][box_rows][N] int8 with a box of [1][tile_rows /
// box_rows][box_rows][nv vectors]: a tile's rows of one half in one copy;
// built once per tree (q3_fused_step_maps).
struct FsMaps {
  CUtensorMap m[kFsProjs];
};

// The most rows an attention chunk holds for any pos < max_seq.
__host__ __device__ inline int fs_chunk_cap(const FsArgs& a) {
  const int rows = (a.max_seq + a.max_chunks - 1) / a.max_chunks;
  return rows > kFsChunkRows ? rows : kFsChunkRows;
}

__host__ __device__ inline int fs_misc_floats(const FsArgs& a) {
  return kFsMiscFixed + (fs_chunk_cap(a) + 31) / 32 * 32;
}

// Attention chunks of a head for `live` rows: one per kFsChunkRows rows,
// at most max_chunks (each then holds at most fs_chunk_cap rows).
__host__ __device__ inline int fs_chunks(const FsArgs& a, int live) {
  const int n = (live + kFsChunkRows - 1) / kFsChunkRows;
  return n < 1 ? 1 : n > a.max_chunks ? a.max_chunks : n;
}

// Scratch (f32 units): the barrier's count, the qkv row, the attention row,
// SiLU*up, each (head, chunk)'s weighted value sum and (max, weight sum),
// and a counter per head of its chunk blocks that have finished.
struct FsLayout {
  size_t bar, qkv, attn, act, att_acc, att_ml, att_cnt, total;
};

__host__ __device__ inline FsLayout fs_layout(const FsArgs& a) {
  FsLayout L{};
  size_t o = 0;
  const int qd = a.heads * a.head_dim, kvd = a.kv_heads * a.head_dim;
  L.bar = take64(o, 2);
  L.qkv = take64(o, (size_t)qd + 2 * kvd);
  L.attn = take64(o, qd);
  L.act = take64(o, a.inter);
  L.att_acc = take64(o, (size_t)a.heads * a.max_chunks * a.head_dim);
  L.att_ml = take64(o, (size_t)a.heads * a.max_chunks * 2);
  L.att_cnt = take64(o, a.heads);
  L.total = o;
  return L;
}

static bool fs_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The plan against the dims and this file's constants (vec_t: columns of a
// 16-byte vector of T): the groups cover every column once, the TMA boxes
// and ring tiles are legal and never cross K, the heads' chunks fit the
// grid, and each shared-memory region holds what the kernels put there.
static bool fs_ok(const FsArgs& a, int vec_t) {
  constexpr int VW = Vec<int8_t>::n;
  const int D = a.head_dim;
  if (a.layers < 1 || a.hidden < 1 || a.inter < 1 || a.max_seq < 1) return false;
  if (D < 2 || D > kFsMaxHeadDim || D % 2 || D % vec_t || a.kv_heads < 1 || a.heads < 1 || a.heads % a.kv_heads)
    return false;
  if (a.max_chunks < 1 || a.max_chunks > kFsMaxChunks || (long)a.heads * a.max_chunks > a.grid) return false;
  if (a.grid < 1 || a.stage_bytes < 16 || a.stage_bytes % 128) return false;
  const long ring = (long)kFsStages * a.stage_bytes;
  const long at[] = {ring, a.smem_xs, a.smem_red, a.smem_cs, a.smem_misc, a.smem_bytes};
  for (int i = 1; i < 6; ++i)
    if (at[i] < at[i - 1] || at[i] % 16) return false;
  if (a.smem_bytes > kSmemLimit || (long)a.smem_bytes - a.smem_misc < 4l * fs_misc_floats(a)) return false;
  long xs = 0;
  for (int j = 0; j < kFsProjs; ++j) {
    const FsGeom g = fs_geom(a, j);
    const FsProjPlan& p = a.proj[j];
    xs = g.K > xs ? g.K : xs;
    if (g.half_n % VW || p.nv < 1 || p.nv * g.halves > kFrameThreads || p.nv * VW > 256) return false;
    const int nvec = g.half_n / VW, nvt = p.nv * g.halves;
    if (p.groups != (nvec + p.nv - 1) / p.nv || p.groups > a.grid) return false;
    if (!fs_pow2(p.box_rows) || p.box_rows > 256 || g.K % p.box_rows || p.tile_rows < p.box_rows ||
        p.tile_rows % p.box_rows || p.tile_rows / p.box_rows > 256 || g.K % p.tile_rows)
      return false;
    if (p.box_rows * p.nv * kVecBytes % 128) return false;  // TMA destinations 128-byte aligned
    if ((long)p.tile_rows * nvt * kVecBytes > a.stage_bytes) return false;
    const int rgroups = nvt < 32 && fs_pow2(nvt) ? kFrameThreads / 32 : kFrameThreads / nvt;
    if (a.smem_cs - a.smem_red < 4l * rgroups * nvt * VW || a.smem_misc - a.smem_cs < 4l * nvt * VW) return false;
  }
  return a.smem_red - a.smem_xs >= 4 * xs;
}

// ---------------------------------------------------------------------------
// Device pieces
// ---------------------------------------------------------------------------

// The weight stream of one block in one call: every tile of the block's
// slices of projections first..last, in the order the block consumes them.
// Thread 0 is the producer: it loads tile q into slot q % kFsStages with one
// TMA box per half (tile_rows rows), and the slot's mbarrier
// completes when all its bytes have landed. A tile's rows lie in shared
// memory as [half][row][nv vectors]; the last group's boxes reach past its
// columns (into the next half, or out of bounds: zeros), unread.
struct FsRing {
  const FsArgs& a;
  const FsMaps& maps;
  unsigned char* base;
  uint64_t* full;  // kFsStages mbarriers, one per slot
  int issued = 0, consumed = 0;
  int proj, last, tile = 0;  // the producer's cursor (thread 0's copy is the one used)

  __device__ FsRing(const FsArgs& args, const FsMaps& m, unsigned char* ring, uint64_t* bars, int first, int last_)
      : a(args), maps(m), base(ring), full(bars), proj(first), last(last_) {}

  __device__ int tiles(int j) const {
    const FsProjPlan& p = a.proj[j];
    return (int)blockIdx.x < p.groups ? fs_geom(a, j).K / p.tile_rows : 0;
  }

  // Thread 0, at the start: the first tiles (up to kFsStages - 1) of the
  // first projection the block streams; the next projection's follow as the
  // ring is consumed, so that they do not take memory bandwidth from these.
  __device__ void prime() {
    while (proj < last && tiles(proj) == 0) ++proj;
    const int first = proj;
    while (issued < kFsStages - 1 && proj == first && tile < tiles(first)) issue();
  }

  // Thread 0: the next tile of the call into the next slot, if any is left.
  __device__ void issue() {
    while (proj <= last) {
      if (tile < tiles(proj)) {
        const FsGeom g = fs_geom(a, proj);
        const FsProjPlan& p = a.proj[proj];
        const int b0 = tile * (p.tile_rows / p.box_rows), half_bytes = p.tile_rows * p.nv * kVecBytes;
        const int slot = issued % kFsStages, col0 = blockIdx.x * p.nv * Vec<int8_t>::n;
        unsigned char* dst = base + (size_t)slot * a.stage_bytes;
        mbar_arrive_expect_tx(full + slot, half_bytes * g.halves);
        for (int h = 0; h < g.halves; ++h)
          tma_load_4d(dst + h * half_bytes, &maps.m[proj], h * g.half_n + col0, 0, b0, a.layer, full + slot);
        ++tile;
        ++issued;
        return;
      }
      tile = 0;
      ++proj;
    }
  }
};

// The block's column sums of its group of projection j over the whole K (one
// flat sum), the staged inputs xs[0, K), consuming its tiles from the ring
// (and refilling it) as they land: into cs[h * nv * 16 + v * 16 + i]. Thread
// t takes vector u % nvt of row lane u / nvt (nvt = nv x halves), u = t - 32
// for warps 1-7 and warp 0 (the producer's) past the last row lane, so that
// thread 0's loads of the next tiles are not on the tile loop's path (u = t
// where nvt > 224).
__device__ void fs_gemv(FsRing& ring, int j, const float* xs, float* red, float* cs) {
  constexpr int VEC = Vec<int8_t>::n;
  const FsArgs& a = ring.a;
  const FsGeom g = fs_geom(a, j);
  const FsProjPlan& p = a.proj[j];
  const int nvt = p.nv * g.halves, t = threadIdx.x;
  const int nc = nvt <= kFrameThreads - 32 ? kFrameThreads - 32 : kFrameThreads;
  const int u = (t + nc) % kFrameThreads, nrl = nc / nvt, rl = u / nvt, v = u % nvt;
  const int h = v / p.nv, vv = v - h * p.nv;
  const bool live = rl < nrl && (int)blockIdx.x * p.nv + vv < g.half_n / VEC;
  float acc[1][VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[0][i] = 0.f;
  const int ntiles = g.K / p.tile_rows, rows = p.tile_rows;
  for (int q = 0; q < ntiles; ++q) {
    const int slot = ring.consumed % kFsStages;
    // A tile that never lands (a copy the card refused) traps as a missing
    // block at a barrier would, instead of holding the card.
    for (unsigned long long t0 = 0; !mbar_try_wait(ring.full + slot, (ring.consumed / kFsStages) & 1);) {
      const unsigned long long now = global_ns();
      if (!t0) t0 = now;
      if (now - t0 > kBarrierTimeoutNs) __trap();
    }
    __syncthreads();  // every thread is done with the slot of the tile before this one
    if (t == 0) ring.issue();  // into that slot
    ++ring.consumed;
    if (live) {
      const unsigned char* tile = ring.base + (size_t)slot * a.stage_bytes + (size_t)h * rows * p.nv * kVecBytes;
      const float* x = xs + q * rows;
      for (int r = rl; r < rows; r += nrl) {
        float w[VEC];
        lds_w<int8_t>(tile + (size_t)(r * p.nv + vv) * kVecBytes, w);
        const float xv = x[r];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[0][i] = fmaf(xv, w[i], acc[0][i]);
      }
    }
  }
  reduce_cols<VEC, 1>(acc, nvt, red, cs, u);
}

// misc (floats), W = kFsMaxHeadDim: [0, 2W) normed q | k, [2W, 3W) rotated
// q, [3W, 4W) rotated k, [4W, 5W) v, [5W, 5W + 32) block_sum's (also
// stage_rmsnorm's), [5W + 32, 5W + 64) block_sums' and the last-block flag,
// [5W + 72, 5W + 80) the ring's mbarriers, [5W + 80, 5W + 82) the chunk's
// (max, weight sum), [5W + 96, 5W + 96 + 2 * kFsMaxChunks) every chunk's of
// the head, [2048, 4096) the value sums' row lanes, [4096, ...) the chunk's
// scores, then weights.
constexpr int kFsBuf = 5 * kFsMaxHeadDim;
constexpr int kFsBars = kFsBuf + 72;
constexpr int kFsStats = kFsBuf + 80;
constexpr int kFsChunkStats = kFsBuf + 96;
static_assert(kFsChunkStats + 2 * kFsMaxChunks <= 2048, "the attention scratch's regions overlap");

// The rows <= pos of the block's chunk: [r0, r0 + n) of chunk c of nch.
struct FsChunk {
  int h, c, kvh, r0, n;
};

__device__ inline FsChunk fs_chunk(const FsArgs& a, int nch) {
  const int b = blockIdx.x, h = b / nch, c = b % nch, rows = a.pos + 1, cr = (rows + nch - 1) / nch, r0 = c * cr;
  return {h, c, h / (a.heads / a.kv_heads), r0, max(min(r0 + cr, rows) - r0, 0)};
}

// Threads a score row (a power of two that divides the row's nvr 16-byte
// vectors and leaves a thread for every one of the chunk's n rows, up to
// 256; at most 32).
__device__ inline int fs_score_lanes(int nvr, int n) {
  const int cap = min(min(nvr & -nvr, 32), kFrameThreads / max(n, 1));
  int lanes = 1;
  while (lanes * 2 <= cap) lanes *= 2;
  return lanes;
}

// Phase 2 of kernel 5, block (h, c): q head h and its kv head's k from the
// qkv row (QK-norm, RoPE at pos), row pos written to the cache by the kv
// head's first q head in the last chunk, the chunk's scores (f32) into
// misc's scores, their maximum m and weight sum l = sum exp(s - m) into
// misc's statistics and, with more than one chunk, att_ml[h][c]. First it
// loads the thread's first batch of V vectors for fs_values into `vpre`:
// they depend on nothing the phase computes, and in flight here their
// latency hides behind the scores and the barrier (with many chunks of
// cold cache rows, the larger part of the value sums' time).
template <typename T>
__device__ void fs_scores(const FsArgs& a, int nch, const float* qkvg, float* att_ml, float* misc, uint4 (&vpre)[8]) {
  constexpr int VT = Vec<T>::n, kW = kFsMaxHeadDim, kE = 2 * kW / kFrameThreads;
  const int D = a.head_dim, half = D / 2, group = a.heads / a.kv_heads, kvd = a.kv_heads * D, qd = a.heads * D;
  const FsChunk ch = fs_chunk(a, nch);
  const int t = threadIdx.x, pos = a.pos, nvr = D / VT;
  float *vals = misc, *qrot = misc + 2 * kW, *kloc = misc + 3 * kW, *vloc = misc + 4 * kW, *buf = misc + kFsBuf;
  float *bsum = buf + 32, *sc = misc + kFsMiscFixed;
  T* ck = static_cast<T*>(a.ck) + ch.kvh * D;
  T* cv = static_cast<T*>(a.cv) + ch.kvh * D;
  const int lanes = fs_score_lanes(nvr, ch.n), per = nvr / lanes, nrl = kFrameThreads / lanes, li = t % lanes;
  {
    const int vrl = kFrameThreads / nvr, rl = t / nvr, vi = t % nvr;
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int i = rl + x * vrl;
      if (rl < vrl && i < ch.n && ch.r0 + i != pos)
        vpre[x] = *reinterpret_cast<const uint4*>(cv + (size_t)(ch.r0 + i) * kvd + vi * VT);
    }
  }

  // QK-norm of q (elements [0, D) of q | k) and k ([D, 2D)), then
  // split-half RoPE: element e on thread e % 256. Its q | k element, its
  // cos / sin and v come in one round of loads.
  float x[kE], cs[kE], sn[kE], ss[2] = {0.f, 0.f};
  const float vt = t < D ? __ldcg(qkvg + qd + kvd + ch.kvh * D + t) : 0.f;
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const int e = t + r * kFrameThreads, which = e / D, d = e - which * D, f = d < half ? d : d - half;
    const bool qk = e < 2 * D;
    x[r] = qk ? __ldcg(qkvg + (which ? qd + ch.kvh * D + d : ch.h * D + d)) : 0.f;
    cs[r] = qk ? round_to<T>(a.cos_t[(size_t)pos * half + f]) : 0.f;
    sn[r] = qk ? round_to<T>(a.sin_t[(size_t)pos * half + f]) : 0.f;
    ss[0] += qk && which == 0 ? x[r] * x[r] : 0.f;
    ss[1] += qk && which == 1 ? x[r] * x[r] : 0.f;
  }
  block_sums<2>(ss, bsum, bsum + 16);
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const int e = t + r * kFrameThreads, which = e / D, d = e - which * D;
    if (e < 2 * D) {
      const T* w = static_cast<const T*>(which ? a.k_norm : a.q_norm) + (size_t)a.layer * D;
      const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss[which], 1.f / D), a.eps));
      vals[e] = round_to<T>(__fmul_rn(__fmul_rn(x[r], inv), to_float<T>(w[d])));
    }
  }
  if (t < D) vloc[t] = vt;
  __syncthreads();
  const bool writes = ch.h % group == 0 && ch.c == nch - 1;
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const int e = t + r * kFrameThreads, which = e / D, d = e - which * D;
    if (e < 2 * D) {
      const float* xv = vals + which * D;
      const float y = d < half ? sub_t<T>(mul_t<T>(xv[d], cs[r]), mul_t<T>(xv[d + half], sn[r]))
                               : add_t<T>(mul_t<T>(xv[d], cs[r]), mul_t<T>(xv[d - half], sn[r]));
      (which ? kloc : qrot)[d] = y;
      if (which && writes) {
        ck[(size_t)pos * kvd + d] = from_float<T>(y);
        cv[(size_t)pos * kvd + d] = from_float<T>(vloc[d]);
      }
    }
  }
  __syncthreads();

  // Scores: `lanes` threads a row (fs_score_lanes), each summing its run of
  // the row's vectors in order (batches of 8 loads in flight), then an xor
  // butterfly over the lanes; row pos from shared memory.
  float m = -INFINITY;
  for (int i0 = 0; i0 < ch.n; i0 += nrl) {  // the same trips in every thread (the butterfly's shuffles)
    const int i = i0 + t / lanes, r = ch.r0 + i;
    float s = 0.f;
    if (i < ch.n && r == pos) {
      for (int e = li * per * VT; e < (li + 1) * per * VT; ++e) s = fmaf(qrot[e], kloc[e], s);
    } else if (i < ch.n) {
      const uint4* row = reinterpret_cast<const uint4*>(ck + (size_t)r * kvd) + li * per;
      const float* q = qrot + li * per * VT;
      for (int v0 = 0; v0 < per; v0 += 8) {
        uint4 raw[8];
#pragma unroll
        for (int v = 0; v < 8; ++v)
          if (v0 + v < per) raw[v] = row[v0 + v];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          if (v0 + v >= per) break;
          float kv[VT];
          lds_w<T>(reinterpret_cast<const unsigned char*>(raw + v), kv);
#pragma unroll
          for (int e = 0; e < VT; ++e) s = fmaf(q[(v0 + v) * VT + e], kv[e], s);
        }
      }
    }
    for (int off = lanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (li == 0 && i < ch.n) {
      s = __fmul_rn(s, a.attn_scale);
      sc[i] = s;
      m = fmaxf(m, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((t & 31) == 0) buf[t >> 5] = m;
  __syncthreads();
  m = buf[0];
  for (int w = 1; w < kFrameThreads / 32; ++w) m = fmaxf(m, buf[w]);
  float lsum = 0.f;
  for (int i = t; i < ch.n; i += kFrameThreads) lsum += expf(__fsub_rn(sc[i], m));
  lsum = block_sum(lsum, buf);
  if (t == 0) {
    misc[kFsStats] = m;
    misc[kFsStats + 1] = lsum;
    if (nch > 1) {
      float* ml = att_ml + ((size_t)ch.h * a.max_chunks + ch.c) * 2;
      ml[0] = m;
      ml[1] = lsum;
    }
  }
  __syncthreads();
}

// Phase 3 of kernel 5, block (h, c): the head's maximum M and weight sum L
// (the block's own with one chunk; else every chunk's (m, l) in chunk
// order, L = sum l_c exp(m_c - M)), the weights round_T(exp(s - M) / L),
// the chunk's weighted sum of V rows (row pos from shared memory) and, with
// one chunk, the attention row of head h; with more, into att_acc[h][c],
// and the head's last chunk block to finish adds the chunks in order.
template <typename T>
__device__ void fs_values(const FsArgs& a, int nch, const float* att_ml, float* att_acc, unsigned* att_cnt,
                          float* attn, float* misc, const uint4 (&vpre)[8]) {
  constexpr int VT = Vec<T>::n;
  const int D = a.head_dim, kvd = a.kv_heads * D, t = threadIdx.x, pos = a.pos, nvr = D / VT;
  const FsChunk ch = fs_chunk(a, nch);
  float *vloc = misc + 4 * kFsMaxHeadDim, *buf = misc + kFsBuf, *vred = misc + 2048, *sc = misc + kFsMiscFixed;
  int* last = reinterpret_cast<int*>(buf + 60);
  const T* cv = static_cast<const T*>(a.cv) + ch.kvh * D;
  float mg = misc[kFsStats], lt = misc[kFsStats + 1];
  if (nch > 1) {  // every chunk's (m, l), loaded at once, then combined in chunk order
    float* mls = misc + kFsChunkStats;
    if (t < 2 * nch) mls[t] = __ldcg(att_ml + (size_t)ch.h * a.max_chunks * 2 + t);
    __syncthreads();
    mg = -INFINITY;
    for (int q = 0; q < nch; ++q) mg = fmaxf(mg, mls[2 * q]);
    for (int q = 0; q < nch; ++q) {
      const float lv = __fmul_rn(mls[2 * q + 1], expf(__fsub_rn(mls[2 * q], mg)));
      lt = q ? __fadd_rn(lt, lv) : lv;
    }
  }
  for (int i = t; i < ch.n; i += kFrameThreads) sc[i] = round_to<T>(__fdiv_rn(expf(__fsub_rn(sc[i], mg)), lt));
  __syncthreads();

  // Values: D / VT lanes of a row (16 bytes each), 256 / (D / VT) row lanes,
  // rows in batches of 8 loads in flight (the first from fs_scores), summed
  // in row order.
  const int nrl = kFrameThreads / nvr, rl = t / nvr, vi = t % nvr;
  if (rl < nrl) {
    float acc[VT];
#pragma unroll
    for (int e = 0; e < VT; ++e) acc[e] = 0.f;
    for (int i0 = rl; i0 < ch.n; i0 += 8 * nrl) {
      uint4 raw[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int i = i0 + x * nrl;
        if (i < ch.n && ch.r0 + i != pos)
          raw[x] = i0 == rl ? vpre[x] : *reinterpret_cast<const uint4*>(cv + (size_t)(ch.r0 + i) * kvd + vi * VT);
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int i = i0 + x * nrl;
        if (i >= ch.n) break;
        float v[VT];
        if (ch.r0 + i == pos) {
#pragma unroll
          for (int e = 0; e < VT; ++e) v[e] = vloc[vi * VT + e];
        } else {
          lds_w<T>(reinterpret_cast<const unsigned char*>(raw + x), v);
        }
        const float w = sc[i];
#pragma unroll
        for (int e = 0; e < VT; ++e) acc[e] = fmaf(w, v[e], acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < VT; ++e) vred[rl * D + vi * VT + e] = acc[e];
  }
  __syncthreads();
  const size_t at = (size_t)ch.h * a.max_chunks + ch.c;
  if (t < D) {
    float s = 0.f;
    for (int q = 0; q < nrl; ++q) s += vred[q * D + t];
    if (nch == 1) {
      attn[ch.h * D + t] = round_to<T>(s);
      return;
    }
    att_acc[at * D + t] = s;
  }
  if (nch == 1) return;

  // The head's last chunk block: attn[h] <- its chunks' sums in chunk order.
  __threadfence();
  __syncthreads();
  if (t == 0) *last = atomicAdd(att_cnt + ch.h, 1u) == (unsigned)nch - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (t == 0) att_cnt[ch.h] = 0;  // every chunk block has counted: ready for the next call
  if (t < D) {  // every chunk's sum loaded at once, added in chunk order
    const float* acc = att_acc + (size_t)ch.h * a.max_chunks * D + t;
    float v[kFsMaxChunks];
#pragma unroll
    for (int q = 0; q < kFsMaxChunks; ++q) v[q] = q < nch ? __ldcg(acc + (size_t)q * D) : 0.f;
    float s = v[0];
#pragma unroll
    for (int q = 1; q < kFsMaxChunks; ++q)
      if (q < nch) s = __fadd_rn(s, v[q]);
    attn[ch.h * D + t] = round_to<T>(s);
  }
}

// What both kernels share: the shared-memory regions, the scratch, the ring
// (started: its mbarriers set and its first tiles issued), the phases'
// stamps and barriers.
struct FsBlock {
  float *xs, *red, *cs, *misc, *buf;
  FsLayout lo;
  unsigned long long *bar, *stamps;
  int phase = 0;

  __device__ FsBlock(const FsArgs& a, unsigned char* smem) {
    xs = reinterpret_cast<float*>(smem + a.smem_xs);
    red = reinterpret_cast<float*>(smem + a.smem_red);
    cs = reinterpret_cast<float*>(smem + a.smem_cs);
    misc = reinterpret_cast<float*>(smem + a.smem_misc);
    buf = misc + kFsBuf;
    lo = fs_layout(a);
    bar = reinterpret_cast<unsigned long long*>(a.scratch + lo.bar);
    stamps = a.trace ? a.trace + (size_t)blockIdx.x * kFsPhases * 4 : nullptr;
  }
  __device__ uint64_t* full() const { return reinterpret_cast<uint64_t*>(misc + kFsBars); }
  __device__ void start(FsRing& ring) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kFsStages; ++i) mbar_init(full() + i, 1);
      fence_mbar_init();
      ring.prime();
    }
    __syncthreads();
  }
  __device__ void mark(int k) {
    if (stamps && threadIdx.x == 0) stamps[phase * 4 + k] = global_ns();
  }
  // The phase's end: a grid barrier (`sync`), or none.
  __device__ void end_phase(const FsArgs& a, bool sync) {
    if (sync) {
      grid_sync(bar, a.grid, stamps ? stamps + phase * 4 + 2 : nullptr);
    } else if (stamps && threadIdx.x == 0) {
      stamps[phase * 4 + 2] = stamps[phase * 4 + 3] = global_ns();
    }
    ++phase;
  }
  // Columns of group blockIdx.x of projection j (per half), and its first.
  __device__ static int owned(const FsArgs& a, int j) {
    const int nvec = fs_geom(a, j).half_n / Vec<int8_t>::n;
    return min(a.proj[j].nv, nvec - (int)blockIdx.x * a.proj[j].nv) * Vec<int8_t>::n;
  }
  __device__ static int first_col(const FsArgs& a, int j) { return blockIdx.x * a.proj[j].nv * Vec<int8_t>::n; }
};

// y <- x + round_T(column sums * scale) (residual) or the bare rounded
// output, for the block's columns of projection j (o or down).
template <typename T>
__device__ void fs_out(const FsArgs& a, int j, const float* cs) {
  const int own = FsBlock::owned(a, j), col0 = FsBlock::first_col(a, j);
  const float* s = a.s[j] + (size_t)a.layer * a.hidden;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  for (int c = threadIdx.x; c < own; c += kFrameThreads) {
    const int col = col0 + c;
    const float o = round_to<T>(scaled(cs[c], s, col));
    y[col] = from_float<T>(a.residual ? add_t<T>(to_float<T>(x[col]), o) : o);
  }
}

// Kernel 5: four phases, three grid barriers (two with one chunk a head).
template <typename T>
__global__ void __launch_bounds__(kFrameThreads, 1)
attention_step_kernel(const FsArgs a, const __grid_constant__ FsMaps maps) {
  using M = __nv_bfloat16;  // int8 matmul inputs
  extern __shared__ __align__(128) unsigned char smem[];
  FsBlock k(a, smem);
  FsRing ring(a, maps, smem, k.full(), kFQkv, kFO);
  k.start(ring);
  float* sc = a.scratch;
  float *qkvg = sc + k.lo.qkv, *attn = sc + k.lo.attn, *att_acc = sc + k.lo.att_acc, *att_ml = sc + k.lo.att_ml;
  unsigned* att_cnt = reinterpret_cast<unsigned*>(sc + k.lo.att_cnt);
  const int b = blockIdx.x, t = threadIdx.x, H = a.hidden, qd = a.heads * a.head_dim;
  const int nch = fs_chunks(a, a.pos + 1);
  const T* x = static_cast<const T*>(a.x);

  // RMSNorm -> qkv.
  if (b < a.proj[kFQkv].groups) {
    stage_rmsnorm<T, M, 1>(nullptr, &x, H, static_cast<const T*>(a.input_ln) + (size_t)a.layer * H, a.eps, k.xs,
                           k.buf);
    k.mark(0);
    fs_gemv(ring, kFQkv, k.xs, k.red, k.cs);
    k.mark(1);
    const int own = FsBlock::owned(a, kFQkv), col0 = FsBlock::first_col(a, kFQkv);
    const float* s = a.s[kFQkv] + (size_t)a.layer * fs_geom(a, kFQkv).N;
    for (int c = t; c < own; c += kFrameThreads) qkvg[col0 + c] = round_to<T>(scaled(k.cs[c], s, col0 + c));
  }
  k.end_phase(a, true);
  // QK-norm, RoPE, row pos, the chunk's scores and statistics.
  const bool attends = b < a.heads * nch;
  uint4 vpre[8];
  if (attends) {
    k.mark(0);
    fs_scores<T>(a, nch, qkvg, att_ml, k.misc, vpre);
    k.mark(1);
  }
  k.end_phase(a, nch > 1);
  // The normalised weights, the value sums, the chunks combined.
  if (attends) {
    k.mark(0);
    fs_values<T>(a, nch, att_ml, att_acc, att_cnt, attn, k.misc, vpre);
    k.mark(1);
  }
  k.end_phase(a, true);
  // o (+ x).
  if (b < a.proj[kFO].groups) {
    for (int i = t; i < qd; i += kFrameThreads) k.xs[i] = round_to<M>(__ldcg(attn + i));
    __syncthreads();
    k.mark(0);
    fs_gemv(ring, kFO, k.xs, k.red, k.cs);
    k.mark(1);
    fs_out<T>(a, kFO, k.cs);
  }
  k.end_phase(a, false);
}

// Kernel 6: two phases, one grid barrier.
template <typename T>
__global__ void __launch_bounds__(kFrameThreads, 1)
mlp_step_kernel(const FsArgs a, const __grid_constant__ FsMaps maps) {
  using M = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  FsBlock k(a, smem);
  FsRing ring(a, maps, smem, k.full(), kFGu, kFDown);
  k.start(ring);
  float* act = a.scratch + k.lo.act;
  const int b = blockIdx.x, t = threadIdx.x, H = a.hidden, I = a.inter;
  const T* x = static_cast<const T*>(a.x);

  // RMSNorm -> gate|up -> SiLU(gate) * up.
  if (b < a.proj[kFGu].groups) {
    stage_rmsnorm<T, M, 1>(nullptr, &x, H, static_cast<const T*>(a.post_ln) + (size_t)a.layer * H, a.eps, k.xs,
                           k.buf);
    k.mark(0);
    fs_gemv(ring, kFGu, k.xs, k.red, k.cs);
    k.mark(1);
    const int own = FsBlock::owned(a, kFGu), col0 = FsBlock::first_col(a, kFGu);
    const int half = a.proj[kFGu].nv * Vec<int8_t>::n;
    const float* s = a.s[kFGu] + (size_t)a.layer * 2 * I;
    for (int c = t; c < own; c += kFrameThreads) {
      const int i = col0 + c;
      const float gate = round_to<T>(scaled(k.cs[c], s, i)), up = round_to<T>(scaled(k.cs[half + c], s, I + i));
      const float silu = round_to<T>(__fmul_rn(gate, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-gate)))));
      act[i] = mul_t<T>(silu, up);
    }
  }
  k.end_phase(a, true);
  // down (+ x).
  if (b < a.proj[kFDown].groups) {
    for (int i = t; i < I; i += kFrameThreads) k.xs[i] = round_to<M>(__ldcg(act + i));
    __syncthreads();
    k.mark(0);
    fs_gemv(ring, kFDown, k.xs, k.red, k.cs);
    k.mark(1);
    fs_out<T>(a, kFDown, k.cs);
  }
  k.end_phase(a, false);
}

// One cooperative launch of `kernel` (attention_step_kernel or
// mlp_step_kernel of one T); `smem_set` the shared memory its attribute
// allows so far on each device (``allow_smem``).
template <typename K>
static cudaError_t launch_fs(K kernel, int* smem_set, const FsArgs& a, const FsMaps& maps, cudaStream_t st) {
  if (const cudaError_t e = allow_smem(kernel, smem_set, a.smem_bytes)) return e;
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
  return cudaLaunchKernelEx(&cfg, kernel, a, maps);
}

static FsArgs unpack_fs(const int* n, const float* f, const void* const* p) {
  FsArgs a{};
  a.layers = n[0]; a.hidden = n[1]; a.heads = n[2]; a.kv_heads = n[3]; a.head_dim = n[4];
  a.inter = n[5]; a.max_seq = n[6]; a.grid = n[7]; a.stage_bytes = n[8]; a.max_chunks = n[9];
  a.smem_xs = n[10]; a.smem_red = n[11]; a.smem_cs = n[12]; a.smem_misc = n[13]; a.smem_bytes = n[14];
  for (int j = 0; j < kFsProjs; ++j) {
    const int* q = n + 15 + 4 * j;
    a.proj[j] = FsProjPlan{q[0], q[1], q[2], q[3]};
  }
  a.eps = f ? f[0] : 0.f;
  a.attn_scale = a.head_dim > 0 ? (float)(1.0 / sqrt((double)a.head_dim)) : 0.f;  // as Python rounds 1/sqrt(D)
  if (p) {
    for (int j = 0; j < kFsProjs; ++j) {
      a.w[j] = static_cast<const int8_t*>(p[j]);
      a.s[j] = static_cast<const float*>(p[kFsProjs + j]);
    }
    a.input_ln = p[8]; a.post_ln = p[9]; a.q_norm = p[10]; a.k_norm = p[11];
    a.scratch = static_cast<float*>(const_cast<void*>(p[12]));
  }
  return a;
}

// The TMA descriptor of each projection's int8 weights, [L][K / box_rows]
// [box_rows][N] (rows N bytes apart, layers K * N), boxes of [1][tile_rows
// / box_rows][box_rows][nv vectors], no swizzle (a box lands as its rows
// one after another).
static cudaError_t encode_fs_maps(const FsArgs& a, FsMaps* out) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  if (const cudaError_t e = tensor_map_encoder(&encode)) return e;
  *out = FsMaps{};
  for (int j = 0; j < kFsProjs; ++j) {
    const FsGeom g = fs_geom(a, j);
    const FsProjPlan& p = a.proj[j];
    const cuuint64_t dims[4] = {(cuuint64_t)g.N, (cuuint64_t)p.box_rows, (cuuint64_t)(g.K / p.box_rows),
                                (cuuint64_t)a.layers};
    const cuuint64_t strides[3] = {(cuuint64_t)g.N, (cuuint64_t)p.box_rows * g.N, (cuuint64_t)g.K * g.N};
    const cuuint32_t box[4] = {(cuuint32_t)(p.nv * kVecBytes), (cuuint32_t)p.box_rows,
                               (cuuint32_t)(p.tile_rows / p.box_rows), 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = encode(&out->m[j], CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(a.w[j]), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// The checks both entries share, then the launch.
template <typename T>
static cudaError_t launch_fs_t(const FsArgs& a, const FsMaps& m, bool attention, cudaStream_t st) {
  if (!fs_ok(a, Vec<T>::n)) return cudaErrorInvalidValue;
  static int smem_set[2][kMaxDevices] = {};
  return attention ? launch_fs(attention_step_kernel<T>, smem_set[0], a, m, st)
                   : launch_fs(mlp_step_kernel<T>, smem_set[1], a, m, st);
}

static int fs_entry(FsArgs& a, bool attention, int dtype, const void* maps, void* stream) {
  if (!(dtype == 0 || dtype == 1) || a.layer < 0 || a.layer >= a.layers) return (int)cudaErrorInvalidValue;
  FsMaps m;
  memcpy(&m, maps, sizeof m);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? launch_fs_t<float>(a, m, attention, st)
                          : launch_fs_t<__nv_bfloat16>(a, m, attention, st));
}

}  // namespace q3

extern "C" {

// Floats of f32 scratch the two kernels need for the dims and plan in
// `ints` (the layout of q3_fused_step_call). The scratch must be zeroed once
// before the first call (its barrier and counter words); calls leave it
// ready for the next one. One scratch serves one call at a time.
size_t q3_fused_step_scratch_floats(const int* ints) { return q3::fs_layout(q3::unpack_fs(ints, nullptr, nullptr)).total; }

// The TMA descriptors of a tree's weights (ints and ptrs as
// q3_fused_step_call) into `maps` (q3_fused_step_maps_bytes of host memory),
// built once per tree and handed to every call of either kernel on it.
size_t q3_fused_step_maps_bytes() { return sizeof(q3::FsMaps); }

int q3_fused_step_maps(const int* ints, const void* const* ptrs, void* maps) {
  const q3::FsArgs a = q3::unpack_fs(ints, nullptr, ptrs);
  q3::FsMaps m;
  const cudaError_t e = q3::encode_fs_maps(a, &m);
  if (e == cudaSuccess) memcpy(maps, &m, sizeof m);
  return (int)e;
}

// Stamps one block records per call when tracing: 4 per phase (work start,
// work end, barrier arrival, barrier leave; 0 where the block has no work
// in the phase, and arrival = leave where no barrier follows), 4 phases
// (kernel 6 fills the first 2).
int q3_fused_step_trace_slots() { return q3::kFsPhases * 4; }

// The argument slots of one call of q3_fused_step_call, as int64
// (fused_layer.FUSED_STEP_CALL_SLOTS): a pack fills the first five once, a
// call the rest.
enum FsSlot {
  kSlDtype, kSlInts, kSlFloats, kSlPtrs, kSlMaps,
  kSlKernel, kSlLayer, kSlX, kSlY, kSlCk, kSlCv, kSlCos, kSlSin, kSlSeq, kSlPos, kSlResidual, kSlTrace, kSlStream,
  kFsSlots
};

size_t q3_fused_step_call_slots() { return kFsSlots; }

// One call of kernel 5 (slot kernel 0) or kernel 6 (1) of layer `layer` in
// one cooperative launch on `stream`, its arguments in the slots s (one
// ctypes argument: a call's host cost is mostly its arguments' conversion).
// Kernel 5: y [H] <- x + o (residual) or o, and row `pos` of ck, cv [seq,
// KV*D] (that layer's planes) written in place (seq <= max_seq, pos < seq),
// cos_t / sin_t [>= pos+1, D/2] f32. Kernel 6: y [H] <- x + down (residual)
// or down (its cache and table slots unread). dtype 0 = f32, 1 = bf16 for
// x, y, the norms and the caches. ints: layers, hidden, heads, kv_heads,
// head_dim, inter, max_seq, then the plan (fused_layer.fused_step_plan):
// grid, stage_bytes, max_chunks, the byte offsets of the shared-memory
// regions (xs, red, cs, misc) and the total, and (nv, groups, tile_rows,
// box_rows) of qkv, o, gate|up, down. floats: eps. ptrs: the fused int8
// projections [in, out] stacked over layers, qkv_w [L, H, (Hq+2KV)*D], o_w
// [L, Hq*D, H], gu_w [L, H, 2I], down_w [L, I, H], their f32 scales qkv_s
// [L, (Hq+2KV)*D], o_s [L, H], gu_s [L, 2I], down_s [L, H], input_ln /
// post_ln [L, H], q_norm / k_norm [L, D], scratch. maps: what
// q3_fused_step_maps made of the same ints and ptrs. Every weight and cache
// pointer 16-byte aligned. trace: null, or [grid][q3_fused_step_trace_slots]
// u64 (ns, %globaltimer). Returns the CUDA error of the launch (a plan,
// shape or pos the kernel does not take: cudaErrorInvalidValue).
int q3_fused_step_call(const long long* s) {
  q3::FsArgs a = q3::unpack_fs(reinterpret_cast<const int*>(s[kSlInts]), reinterpret_cast<const float*>(s[kSlFloats]),
                               reinterpret_cast<const void* const*>(s[kSlPtrs]));
  a.layer = (int)s[kSlLayer];
  a.x = reinterpret_cast<const void*>(s[kSlX]);
  a.y = reinterpret_cast<void*>(s[kSlY]);
  a.ck = reinterpret_cast<void*>(s[kSlCk]);
  a.cv = reinterpret_cast<void*>(s[kSlCv]);
  a.cos_t = reinterpret_cast<const float*>(s[kSlCos]);
  a.sin_t = reinterpret_cast<const float*>(s[kSlSin]);
  a.seq = (int)s[kSlSeq];
  a.pos = (int)s[kSlPos];
  a.residual = (int)s[kSlResidual];
  a.trace = reinterpret_cast<unsigned long long*>(s[kSlTrace]);
  const bool attention = s[kSlKernel] == 0;
  if (!(attention || s[kSlKernel] == 1)) return (int)cudaErrorInvalidValue;
  if (attention && (a.seq < 1 || a.seq > a.max_seq || a.pos < 0 || a.pos >= a.seq || !a.cos_t || !a.sin_t))
    return (int)cudaErrorInvalidValue;
  return q3::fs_entry(a, attention, (int)s[kSlDtype], reinterpret_cast<const void*>(s[kSlMaps]),
                      reinterpret_cast<void*>(s[kSlStream]));
}

}  // extern "C"
