// Kernels 3 and 7 of the port: one batch-1 decode step of a layer stack in
// one persistent launch. Kernel 3 is the talker's step, on int8 weights or
// on plain weights in the working type; kernel 7 the code predictor's step,
// on int8 weights. One body serves both: they differ at two rounding points
// only (the "normalised" form below).
//
// Replaces the TPU kernels qwen3_tts_tpu/ops/fused_layer.py:
// _streamed_talker_kernel (entry streamed_talker_step), in both its forms
// (`quantized` True / False), and _streamed_step_kernel (entry
// streamed_decode_step): the step's input through every layer (RMSNorm ->
// qkv -> QK-norm -> RoPE -> KV append at row `pos` -> GQA over the cache
// rows <= pos -> o -> residual -> RMSNorm -> gate|up -> SiLU*up -> down ->
// residual), returning the last layer's output (the final norm and the
// codec head or lm heads stay outside, as in the JAX package).
//
// What bounds it on an H100: at 1.7B a talker step streams 28 layers of
// weights, 50.3 MB each in int8 (1.41 GB, ~0.42 ms at 3.35 TB/s), 100.7 MB
// in bf16 (2.82 GB, ~0.84 ms) or 201 MB in f32, each weight read once (they
// do not fit the 50 MB L2), plus the live cache rows (2 x 28 x (pos+1) x
// 1024 bf16: 117 KB per row); a code-predictor step 5 layers of 15.73 MB
// int8 (78.6 MB, ~23.5 us) and at most 17 cache rows. One GEMV per
// projection at batch 1: bytes, not flops. The layers are dependent and
// each is five dependent phases, so a step also pays 5 grid-wide barriers a
// layer and as many stagings and epilogues.
//
// Design: one cooperative launch of `grid` blocks (one per SM, all
// co-resident), 256 threads each, that walks the layers itself, five
// phases a layer separated by kernel 1's counting grid barrier
// (persistent.cuh): RMSNorm -> qkv; QK-norm, RoPE, KV append and attention;
// o + residual; RMSNorm -> gate|up -> SiLU*up; down + residual. Nothing in
// the launch depends on `pos` but the work inside it, so the launch is the
// same every step. Each projection's output columns are cut into groups of
// `nv` vectors (16 bytes of weights: 4 f32, 8 bf16 or 16 int8 columns; the
// same columns of both halves of gate|up), as many groups as the card has
// SMs (so every SM streams a slice of every projection, and at any moment
// the blocks read neighbouring columns of the same K rows); block g owns
// group g over the whole K and sums its columns in a fixed order in the
// block, chunk by chunk for o and down (the plain version's H-wide K
// chunks, added in ascending order): no float atomics and no cross-block
// partial sums, so a step is bit-reproducible. The weights do not depend on
// the activations: every block streams its slices of all projections of
// the step, in the order it consumes them, through a ring of `kStepStages`
// shared-memory tiles that thread 0 fills with TMA boxes of 3-D maps
// [L][K][N] (built once per tree), each slot completing on its own
// mbarrier; the ring runs kStepStages - 1 tiles ahead across phase
// boundaries, so the next phase's tiles (and the next layer's qkv) are in
// flight while the block waits at a barrier or does attention; warp 0 only
// issues the loads and the other 7 warps consume the tiles. Attention: the rows <= pos of each q head are cut
// into `nch` chunks (at least kStepChunkRows rows each, at most
// kStepMaxChunks, heads x nch <= grid: the kernel picks nch from pos), a
// block per (head, chunk), which finishes q and its kv head's k from the
// qkv row itself (the head's first q head, in the last chunk, appends row
// pos of K and V), and leaves its chunk's maximum score m, f32 weight sum l
// and weighted value sum; the last of a head's chunk blocks to finish (a
// counter per head) combines the head's chunks in a fixed order (each
// chunk times exp(m - the largest m)) into the attention row, so the
// combine costs no barrier. Activations (x, the qkv row, the attention
// row, SiLU*up) live in the f32 scratch, read after a barrier through L2
// (__ldcg). The grid, the groups and the ring's tile and box sizes come
// from the Python plan (ops/fused_layer.py:talker_step_plan); the entry
// checks them. With a trace buffer, every block stamps each phase's work
// start and end and its barrier arrival and leave.
//
// Rounding points (those of the plain versions, fused_layer.talker_step_plain
// and streamed_decode_step_plain, which are the JAX kernels'): every matmul
// input is rounded to MatIn<T, W> (T for plain weights, bf16 for int8,
// whose bf16 x int8 products are exact in f32); int8 column sums are
// multiplied by their scale once, then rounded to T (the JAX kernel's `acc
// * scale`); QK-norm and RoPE in T; scores f32; SiLU in f32. Kernel 3:
// cos/sin rounded to T; the unnormalised weights exp(s - m) rounded to T
// before the value sum, m the chunk's maximum (one chunk up to 256 rows:
// the plain version's global maximum, as the JAX kernel's first 256-row
// block; it rescales the later blocks the same way), divided by their f32
// sum after it. Kernel 7, the normalised form (kNorm): cos/sin rounded to
// bf16 even when T is f32; the softmax weights exp(s - m) / l normalised
// before they are rounded to T (so a head's rows stay in one chunk: its
// caches hold at most kStepChunkRows rows). The cache is written at row
// `pos` only, in place in the [L, S, KV*D] planes.

#include <string.h>

#include <type_traits>

#include "persistent.cuh"

namespace q3 {

constexpr int kStepStages = 4;         // fused_layer.TALKER_STEP_STAGES
constexpr int kStepMaxChunks = 8;      // attention chunks of a head, at most
constexpr int kStepChunkRows = 256;    // cache rows of an attention chunk, at least (unless fewer are live)
constexpr int kStepMaxHeadDim = 128;   // kernel 3: q and k of a head on the block's 256 threads
constexpr int kStepMaxHeadDimNorm = 256;  // the normalised form: an element of q and one of k a thread
constexpr int kStepMaxHeads = 128;     // q heads the plan takes
constexpr int kStepMiscFixed = 4096;   // misc floats before the chunk's scores (see talker_step_kernel)

// The projections in the order a layer runs them (fused_layer.TALKER_STEP_PROJS).
enum StepProj { kSQkv, kSO, kSGu, kSDown, kStepProjs };

struct StepProjPlan {
  int nv;         // vectors of each half a column group holds (the last group may hold fewer)
  int groups;     // column groups (blocks): group g holds vectors [g*nv, min((g+1)*nv, N/halves/vec))
  int tile_rows;  // K rows per ring tile: a multiple of box_rows that divides the chunk
  int box_rows;   // K rows per TMA box (a power of two dividing the chunk)
};

struct StepArgs {
  int layers, hidden, heads, kv_heads, head_dim, inter, max_seq;
  int grid, stage_bytes;
  // Byte offsets of the shared-memory regions after the ring (kStepStages
  // slots of stage_bytes): the staged matmul input, the column reduction,
  // the column sums (two rows: a chunk's and the running total), the
  // attention scratch; and the total.
  int smem_xs, smem_red, smem_cs, smem_misc, smem_bytes;
  StepProjPlan proj[kStepProjs];
  float eps, attn_scale;
  const void *qkv_w, *o_w, *gu_w, *down_w;
  const float *qkv_s, *o_s, *gu_s, *down_s;  // int8 form; else null
  const void *input_ln, *post_ln, *q_norm, *k_norm;
  const float *cos_t, *sin_t;  // [max_seq, D/2]
  float* scratch;
  // The step's: input x [H], output y [H], caches [L, seq, KV*D], the row
  // written, and the stamps (null, or [grid][step_trace_slots]).
  const void* x;
  void* y;
  void *ck, *cv;
  int seq, pos;
  unsigned long long* trace;
};

// K, the row stride N, the columns of each half (gate|up has two) and the
// K rows of a fixed-order chunk (the whole K for qkv and gate|up).
struct StepGeom {
  int K, N, halves, half_n, chunk;
};

__host__ __device__ inline StepGeom step_geom(const StepArgs& a, int j) {
  const int qd = a.heads * a.head_dim, nqkv = qd + 2 * a.kv_heads * a.head_dim;
  switch (j) {
    case kSQkv: return {a.hidden, nqkv, 1, nqkv, a.hidden};
    case kSO: return {qd, a.hidden, 1, a.hidden, a.hidden};
    case kSGu: return {a.hidden, 2 * a.inter, 2, a.inter, a.hidden};
    default: return {a.inter, a.hidden, 1, a.hidden, a.hidden};
  }
}

// The TMA descriptors of the four projections' weights, each viewed as
// [L][K][N] with a box of [1][box_rows][nv vectors]; built once per tree
// (q3_talker_step_maps).
struct StepMaps {
  CUtensorMap m[kStepProjs];
};

// Stamps a block records per step when tracing: per phase (5 a layer) its
// work start (input staged) and end, its barrier arrival and leave.
__host__ __device__ inline int step_trace_slots(const StepArgs& a) { return 5 * a.layers * 4; }

// Attention chunks of a head at most: kStepMaxChunks, and a block each.
__host__ __device__ inline int step_max_chunks(const StepArgs& a) {
  const int n = a.grid / a.heads;
  return n < kStepMaxChunks ? n : kStepMaxChunks;
}

// The most rows an attention chunk holds for any pos < max_seq.
__host__ __device__ inline int step_chunk_cap(const StepArgs& a) {
  const int n = step_max_chunks(a), rows = (a.max_seq + n - 1) / n;
  return rows > kStepChunkRows ? rows : kStepChunkRows;
}

// The attention scratch's floats for q | k, rotated q and k, and v of the
// form's widest head (its first region; 640 in kernel 3).
template <bool kNorm>
__host__ __device__ constexpr int step_head_floats() {
  return 5 * (kNorm ? kStepMaxHeadDimNorm : kStepMaxHeadDim);
}

__host__ __device__ inline int step_misc_floats(const StepArgs& a) {
  return kStepMiscFixed + (step_chunk_cap(a) + 31) / 32 * 32;
}

// Scratch (f32 units): the barrier's count, x, the qkv row, the attention
// row, SiLU*up, each (head, chunk)'s weighted value sum and (max, weight
// sum), and a counter per head of its chunk blocks that have finished.
struct StepLayout {
  size_t bar, x, qkv, attn, act, att_acc, att_ml, att_cnt, total;
};

__host__ __device__ inline StepLayout step_layout(const StepArgs& a) {
  StepLayout L{};
  size_t o = 0;
  const int qd = a.heads * a.head_dim, kvd = a.kv_heads * a.head_dim;
  L.bar = take64(o, 2);
  L.x = take64(o, a.hidden);
  L.qkv = take64(o, (size_t)qd + 2 * kvd);
  L.attn = take64(o, qd);
  L.act = take64(o, a.inter);
  L.att_acc = take64(o, (size_t)a.heads * kStepMaxChunks * a.head_dim);
  L.att_ml = take64(o, (size_t)a.heads * kStepMaxChunks * 2);
  L.att_cnt = take64(o, a.heads);
  L.total = o;
  return L;
}

static bool step_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The plan against the dims and this file's constants (vec_t / vec_w:
// columns of a vector of T and of W; max_d: the form's widest head): the
// groups cover every column once, the TMA boxes and ring tiles are legal
// and never cross a chunk, and each shared-memory region holds what the
// kernel puts there.
static bool step_ok(const StepArgs& a, int vec_t, int vec_w, int max_d) {
  const int D = a.head_dim;
  if (a.layers < 1 || a.hidden < 1 || a.inter < 1 || a.max_seq < 1) return false;
  if (D < 2 || D > max_d || D % 2 || D % vec_t || a.kv_heads < 1 || a.heads % a.kv_heads) return false;
  if (a.heads > kStepMaxHeads || a.heads > a.grid || a.stage_bytes < 16 || a.stage_bytes % 128) return false;
  const long ring = (long)kStepStages * a.stage_bytes;
  const long at[] = {ring, a.smem_xs, a.smem_red, a.smem_cs, a.smem_misc, a.smem_bytes};
  for (int i = 1; i < 6; ++i)
    if (at[i] < at[i - 1] || at[i] % 16) return false;
  if (a.smem_bytes > kSmemLimit || (long)a.smem_bytes - a.smem_misc < 4l * step_misc_floats(a)) return false;
  long xs = 0;
  for (int j = 0; j < kStepProjs; ++j) {
    const StepGeom g = step_geom(a, j);
    const StepProjPlan& p = a.proj[j];
    xs = g.K > xs ? g.K : xs;
    if (g.half_n % vec_w || p.nv < 1 || p.nv * g.halves > kFrameThreads || p.nv * vec_w > 256) return false;
    const int nvec = g.half_n / vec_w, nvt = p.nv * g.halves;
    if (p.groups != (nvec + p.nv - 1) / p.nv || p.groups > a.grid || g.K % g.chunk) return false;
    if (!step_pow2(p.box_rows) || p.box_rows > 256 || g.chunk % p.box_rows || p.tile_rows < p.box_rows ||
        p.tile_rows % p.box_rows || g.chunk % p.tile_rows)
      return false;
    if (p.box_rows * p.nv * kVecBytes % 128) return false;  // TMA destinations 128-byte aligned
    if ((long)p.tile_rows * nvt * kVecBytes > a.stage_bytes) return false;
    const int rgroups = nvt < 32 && step_pow2(nvt) ? kFrameThreads / 32 : kFrameThreads / nvt;
    if (a.smem_cs - a.smem_red < 4l * rgroups * nvt * vec_w || a.smem_misc - a.smem_cs < 8l * nvt * vec_w)
      return false;
  }
  return a.smem_red - a.smem_xs >= 4 * xs;
}

// ---------------------------------------------------------------------------
// Device pieces
// ---------------------------------------------------------------------------

// The weight stream of one block: every tile of every projection slice the
// block streams, over the whole step, in the order the block consumes them.
// Thread 0 is the producer: it loads tile q into slot q % kStepStages with
// TMA boxes (one box of box_rows rows per half), and the slot's mbarrier
// completes when all its bytes have landed. A tile's rows lie in shared
// memory as [half][row][nv vectors]; the last group's boxes reach past its
// columns (into the next half, or out of bounds: zeros), unread.
template <typename W>
struct StepRing {
  const StepArgs& a;
  const StepMaps& maps;
  unsigned char* base;
  uint64_t* full;  // kStepStages mbarriers, one per slot
  int issued = 0, consumed = 0;
  int layer = 0, proj = 0, tile = 0;  // the producer's cursor (thread 0's copy is the one used)

  __device__ StepRing(const StepArgs& args, const StepMaps& m, unsigned char* ring, uint64_t* bars)
      : a(args), maps(m), base(ring), full(bars) {}

  __device__ int tiles(int j) const {
    const StepProjPlan& p = a.proj[j];
    if ((int)blockIdx.x >= p.groups) return 0;
    return (step_geom(a, j).K + p.tile_rows - 1) / p.tile_rows;
  }

  // Thread 0: the next tile of the step into the next slot, if any is left.
  __device__ void issue() {
    while (layer < a.layers) {
      if (tile < tiles(proj)) {
        const StepGeom g = step_geom(a, proj);
        const StepProjPlan& p = a.proj[proj];
        const int k0 = tile * p.tile_rows, rows = min(p.tile_rows, g.K - k0), half_bytes = rows * p.nv * kVecBytes;
        const int slot = issued % kStepStages, col0 = blockIdx.x * p.nv * Vec<W>::n;
        unsigned char* dst = base + (size_t)slot * a.stage_bytes;
        mbar_arrive_expect_tx(full + slot, half_bytes * g.halves);
        for (int h = 0; h < g.halves; ++h)
          for (int r = 0; r < rows; r += p.box_rows)
            tma_load_3d(dst + h * half_bytes + r * p.nv * kVecBytes, &maps.m[proj], h * g.half_n + col0, k0 + r,
                        layer, full + slot);
        ++tile;
        ++issued;
        return;
      }
      tile = 0;
      if (++proj == kStepProjs) {
        proj = 0;
        ++layer;
      }
    }
  }
};

// The block's column sums of its group of projection j over the whole K,
// the staged inputs xs[0, K), consuming its tiles from the ring (and
// refilling it) as they land: into cs[h * nv * VEC + v * VEC + i], each
// fixed-order chunk summed on its own (through tot, the running total) and
// the chunks added in ascending order. Thread t takes vector u % nvt of row
// lane u / nvt (nvt = nv x halves), u = t - 32 for warps 1-7 and warp 0
// (the producer's) past the last row lane, so that thread 0's loads of the
// next tiles are not on the tile loop's path (u = t where nvt > 224).
template <typename W>
__device__ void step_gemv(StepRing<W>& ring, int j, const float* xs, float* red, float* cs, float* tot) {
  constexpr int VEC = Vec<W>::n;
  const StepArgs& a = ring.a;
  const StepGeom g = step_geom(a, j);
  const StepProjPlan& p = a.proj[j];
  const int nvt = p.nv * g.halves, t = threadIdx.x, cols = nvt * VEC;
  const int nc = nvt <= kFrameThreads - 32 ? kFrameThreads - 32 : kFrameThreads;
  const int u = (t + nc) % kFrameThreads, nrl = nc / nvt, rl = u / nvt, v = u % nvt;
  const int h = v / p.nv, vv = v - h * p.nv;
  const bool live = rl < nrl && (int)blockIdx.x * p.nv + vv < g.half_n / VEC;
  float acc[1][VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[0][i] = 0.f;
  const int ntiles = (g.K + p.tile_rows - 1) / p.tile_rows;
  for (int q = 0; q < ntiles; ++q) {
    const int slot = ring.consumed % kStepStages;
    // A tile that never lands (a copy the card refused) traps as a missing
    // block at a barrier would, instead of holding the card.
    for (unsigned long long t0 = 0; !mbar_try_wait(ring.full + slot, (ring.consumed / kStepStages) & 1);) {
      const unsigned long long now = global_ns();
      if (!t0) t0 = now;
      if (now - t0 > kBarrierTimeoutNs) __trap();
    }
    __syncthreads();  // every thread is done with the slot of the tile before this one
    if (t == 0) ring.issue();  // into that slot
    ++ring.consumed;
    const int k0 = q * p.tile_rows, rows = min(p.tile_rows, g.K - k0);
    if (live) {
      const unsigned char* tile = ring.base + (size_t)slot * a.stage_bytes + (size_t)h * rows * p.nv * kVecBytes;
      for (int r = rl; r < rows; r += nrl) {
        float w[VEC];
        lds_w<W>(tile + (size_t)(r * p.nv + vv) * kVecBytes, w);
        const float xv = xs[k0 + r];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[0][i] = fmaf(xv, w[i], acc[0][i]);
      }
    }
    if ((k0 + rows) % g.chunk == 0 && q + 1 < ntiles) {  // a chunk ends before the last tile
      reduce_cols<VEC, 1>(acc, nvt, red, cs, u);
      for (int c = t; c < cols; c += kFrameThreads) tot[c] = k0 + rows == g.chunk ? cs[c] : tot[c] + cs[c];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[0][i] = 0.f;
    }
  }
  reduce_cols<VEC, 1>(acc, nvt, red, cs, u);
  if (g.K > g.chunk) {
    for (int c = t; c < cols; c += kFrameThreads) cs[c] = tot[c] + cs[c];
    __syncthreads();
  }
}

// Block (h, c) = (b / nch, b % nch): q head h and its kv head's k from the
// qkv row (QK-norm, RoPE at pos), the chunk's rows of the causal window
// [0, pos]: scores (f32), their maximum m, the weights exp(s - m) (their
// f32 sum l, and rounded to T; kNorm: divided by l, then rounded, in one
// chunk) and the weighted sum of V rows, into att_acc[h][c] and
// att_ml[h][c] = (m, l). Row pos comes from registers;
// the head's first q head, in the last chunk, writes it to the cache. The
// head's last chunk block to finish combines its chunks into attn[h].
// misc (floats), W the form's widest head (step_head_floats): [0, 2W)
// normed q | k, [2W, 3W) rotated q, [3W, 4W) rotated k, [4W, 5W) v, [5W,
// 5W + 32) block_sum's, [5W + 32, 5W + 64) block_sums' and the last-block
// flag, [2048, 4096) the value sums' row lanes, [4096, ...) the chunk's
// scores, then weights.
template <typename T, bool kNorm>
__device__ void step_attention(const StepArgs& a, int l, int nch, const float* qkvg, float* att_acc, float* att_ml,
                               unsigned* att_cnt, float* attn, float* misc) {
  constexpr int VT = Vec<T>::n;  // columns of a 16-byte vector
  constexpr int kW = step_head_floats<kNorm>() / 5, kE = 2 * kW / kFrameThreads;  // elements of q | k a thread
  using C = std::conditional_t<kNorm, __nv_bfloat16, T>;  // the type cos/sin round to
  const int D = a.head_dim, half = D / 2, group = a.heads / a.kv_heads, kvd = a.kv_heads * D, qd = a.heads * D;
  const int b = blockIdx.x, h = b / nch, c = b % nch, kvh = h / group, t = threadIdx.x, pos = a.pos;
  float *vals = misc, *qrot = misc + 2 * kW, *kloc = misc + 3 * kW, *vloc = misc + 4 * kW, *buf = misc + 5 * kW;
  float *bsum = buf + 32, *vred = misc + 2048, *sc = misc + kStepMiscFixed;
  int* last = reinterpret_cast<int*>(buf + 60);
  const size_t plane = (size_t)l * a.seq * kvd + (size_t)kvh * D;
  T* ck = static_cast<T*>(a.ck) + plane;
  T* cv = static_cast<T*>(a.cv) + plane;
  const int rows = pos + 1, cr = (rows + nch - 1) / nch, r0 = c * cr, n = max(min(r0 + cr, rows) - r0, 0);
  const int nvr = D / VT;  // 16-byte vectors of a row

  // QK-norm of q (elements [0, D) of q | k) and k ([D, 2D)), then
  // split-half RoPE: element e on thread e % 256 (kE a thread: one in
  // kernel 3, two in the normalised form, for its heads of up to 256).
  float x[kE], ss[2];
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const int e = t + r * kFrameThreads, which = e / D, d = e - which * D;
    const bool qk = e < 2 * D;
    x[r] = qk ? __ldcg(qkvg + (which ? qd + kvh * D + d : h * D + d)) : 0.f;
    const float s0 = qk && which == 0 ? x[r] * x[r] : 0.f, s1 = qk && which == 1 ? x[r] * x[r] : 0.f;
    ss[0] = r ? ss[0] + s0 : s0;
    ss[1] = r ? ss[1] + s1 : s1;
  }
  block_sums<2>(ss, bsum, bsum + 16);
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const int e = t + r * kFrameThreads, which = e / D, d = e - which * D;
    if (e < 2 * D) {
      const T* w = static_cast<const T*>(which ? a.k_norm : a.q_norm) + (size_t)l * D;
      const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss[which], 1.f / D), a.eps));
      vals[e] = round_to<T>(__fmul_rn(__fmul_rn(x[r], inv), to_float<T>(w[d])));
    }
  }
  if (t < D) vloc[t] = __ldcg(qkvg + qd + kvd + kvh * D + t);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const int e = t + r * kFrameThreads, which = e / D, d = e - which * D;
    if (e < 2 * D) {
      const int f = d < half ? d : d - half;
      const float cs = round_to<C>(a.cos_t[(size_t)pos * half + f]);
      const float sn = round_to<C>(a.sin_t[(size_t)pos * half + f]);
      const float* xv = vals + which * D;
      const float y = d < half ? sub_t<T>(mul_t<T>(xv[d], cs), mul_t<T>(xv[d + half], sn))
                               : add_t<T>(mul_t<T>(xv[d], cs), mul_t<T>(xv[d - half], sn));
      (which ? kloc : qrot)[d] = y;
      if (which && h % group == 0 && c == nch - 1) {
        ck[(size_t)pos * kvd + d] = from_float<T>(y);
        cv[(size_t)pos * kvd + d] = from_float<T>(vloc[d]);
      }
    }
  }
  __syncthreads();

  // Scores: a thread per row, the head's dims in order (the row's vectors
  // in batches of 8 loads in flight).
  float m = -INFINITY;
  for (int i = t; i < n; i += kFrameThreads) {
    const int r = r0 + i;
    float s = 0.f;
    if (r == pos) {
      for (int e = 0; e < D; ++e) s = fmaf(qrot[e], kloc[e], s);
    } else {
      const uint4* row = reinterpret_cast<const uint4*>(ck + (size_t)r * kvd);
      for (int v0 = 0; v0 < nvr; v0 += 8) {
        uint4 raw[8];
#pragma unroll
        for (int v = 0; v < 8; ++v)
          if (v0 + v < nvr) raw[v] = row[v0 + v];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          if (v0 + v >= nvr) break;
          float kv[VT];
          lds_w<T>(reinterpret_cast<const unsigned char*>(raw + v), kv);
#pragma unroll
          for (int e = 0; e < VT; ++e) s = fmaf(qrot[(v0 + v) * VT + e], kv[e], s);
        }
      }
    }
    s = __fmul_rn(s, a.attn_scale);
    sc[i] = s;
    m = fmaxf(m, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((t & 31) == 0) buf[t >> 5] = m;
  __syncthreads();
  m = buf[0];
  for (int w = 1; w < kFrameThreads / 32; ++w) m = fmaxf(m, buf[w]);
  float lsum = 0.f;
  for (int i = t; i < n; i += kFrameThreads) {
    const float p = expf(__fsub_rn(sc[i], m));
    lsum += p;
    sc[i] = kNorm ? p : round_to<T>(p);
  }
  lsum = block_sum(lsum, buf);  // its barriers also publish the weights
  if (kNorm) {  // one chunk (step_ok): m and l are the head's
    for (int i = t; i < n; i += kFrameThreads) sc[i] = round_to<T>(__fdiv_rn(sc[i], lsum));
    __syncthreads();
  }

  // Values: D / VT lanes of a row (16 bytes each), 256 / (D / VT) row lanes,
  // rows in batches of 8 loads in flight, summed in row order.
  const int nrl = kFrameThreads / nvr, rl = t / nvr, vi = t % nvr;
  if (rl < nrl) {
    float acc[VT];
#pragma unroll
    for (int e = 0; e < VT; ++e) acc[e] = 0.f;
    for (int i0 = rl; i0 < n; i0 += 8 * nrl) {
      uint4 raw[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int i = i0 + x * nrl;
        if (i < n && r0 + i != pos) raw[x] = *reinterpret_cast<const uint4*>(cv + (size_t)(r0 + i) * kvd + vi * VT);
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int i = i0 + x * nrl;
        if (i >= n) break;
        float v[VT];
        if (r0 + i == pos) {
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
  const size_t at = (size_t)h * kStepMaxChunks + c;
  if (t < D) {
    float s = 0.f;
    for (int q = 0; q < nrl; ++q) s += vred[q * D + t];
    if (nch == 1) {  // the combine below of one chunk: f = exp(0) = 1
      attn[h * D + t] = kNorm ? s : __fdiv_rn(s, lsum);
      return;
    }
    att_acc[at * D + t] = s;
  }
  if (nch == 1) return;
  if (t == 0) {
    att_ml[at * 2] = m;
    att_ml[at * 2 + 1] = lsum;
  }

  // The head's last chunk block: attn[h] <- its chunks combined in order,
  // every chunk's sums times exp(m_c - max_c m_c), divided.
  __threadfence();
  __syncthreads();
  if (t == 0) *last = atomicAdd(att_cnt + h, 1u) == (unsigned)nch - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (t == 0) att_cnt[h] = 0;  // every chunk block has counted: ready for the next layer
  if (t < D) {
    const float* ml = att_ml + (size_t)h * kStepMaxChunks * 2;
    const float* acc = att_acc + (size_t)h * kStepMaxChunks * D + t;
    float mg = -INFINITY;
    for (int q = 0; q < nch; ++q) mg = fmaxf(mg, __ldcg(ml + 2 * q));
    float lt = 0.f, s = 0.f;
    for (int q = 0; q < nch; ++q) {
      const float f = expf(__fsub_rn(__ldcg(ml + 2 * q), mg));
      const float lv = __fmul_rn(__ldcg(ml + 2 * q + 1), f), av = __fmul_rn(__ldcg(acc + (size_t)q * D), f);
      lt = q ? __fadd_rn(lt, lv) : lv;
      s = q ? __fadd_rn(s, av) : av;
    }
    attn[h * D + t] = __fdiv_rn(s, lt);
  }
}

template <typename T, typename W, bool kNorm>
__global__ void __launch_bounds__(kFrameThreads, 1)
talker_step_kernel(const StepArgs a, const __grid_constant__ StepMaps maps) {
  using M = typename MatIn<T, W>::type;
  constexpr int VW = Vec<W>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + a.smem_xs);
  float* red = reinterpret_cast<float*>(smem + a.smem_red);
  float* cs = reinterpret_cast<float*>(smem + a.smem_cs);
  float* tot = cs + (a.smem_misc - a.smem_cs) / 8;  // the second row of the column sums
  float* misc = reinterpret_cast<float*>(smem + a.smem_misc);
  // misc (floats), B = step_head_floats: [0, B + 64) attention
  // (step_attention), also [B, B + 32) stage_rmsnorm's sum; [B + 72, B +
  // 80) the ring's mbarriers; [2048, ...) attention again.
  constexpr int B = step_head_floats<kNorm>();
  uint64_t* full = reinterpret_cast<uint64_t*>(misc + B + 72);
  float* buf = misc + B;
  const StepLayout Lo = step_layout(a);
  float* sc = a.scratch;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(sc + Lo.bar);
  float *xg = sc + Lo.x, *qkvg = sc + Lo.qkv, *attn = sc + Lo.attn, *act = sc + Lo.act;
  float *att_acc = sc + Lo.att_acc, *att_ml = sc + Lo.att_ml;
  unsigned* att_cnt = reinterpret_cast<unsigned*>(sc + Lo.att_cnt);
  const int b = blockIdx.x, t = threadIdx.x, H = a.hidden, I = a.inter, qd = a.heads * a.head_dim;
  const int nqkv = step_geom(a, kSQkv).N;
  const T* xin = static_cast<const T*>(a.x);
  const T* in_ln = static_cast<const T*>(a.input_ln);
  const T* post_ln = static_cast<const T*>(a.post_ln);

  StepRing<W> ring(a, maps, smem, full);
  if (t == 0) {
    for (int i = 0; i < kStepStages; ++i) mbar_init(full + i, 1);
    fence_mbar_init();
    for (int i = 0; i < kStepStages - 1; ++i) ring.issue();
  }
  __syncthreads();
  const int live = a.pos + 1;
  const int nch = max(min(step_max_chunks(a), (live + kStepChunkRows - 1) / kStepChunkRows), 1);
  unsigned long long* stamps = a.trace ? a.trace + (size_t)b * step_trace_slots(a) : nullptr;
  int phase = 0;
  auto mark = [&](int k) {
    if (stamps && t == 0) stamps[phase * 4 + k] = global_ns();
  };
  auto end_phase = [&]() {
    if (phase + 1 < 5 * a.layers) {
      grid_sync(bar, a.grid, stamps ? stamps + phase * 4 + 2 : nullptr);
    } else if (stamps && t == 0) {  // the step's end: no barrier
      stamps[phase * 4 + 2] = stamps[phase * 4 + 3] = global_ns();
    }
    ++phase;
  };
  // The columns of its group the block finishes (per half), and their first.
  auto owned = [&](int j) {
    const int nvec = step_geom(a, j).half_n / VW;
    return min(a.proj[j].nv, nvec - b * a.proj[j].nv) * VW;
  };
  auto first_col = [&](int j) { return b * a.proj[j].nv * VW; };
  auto streams = [&](int j) { return b < a.proj[j].groups; };
  auto srow = [](const float* s, size_t off) { return s ? s + off : nullptr; };

  for (int l = 0; l < a.layers; ++l) {
    // RMSNorm -> qkv.
    if (streams(kSQkv)) {
      stage_rmsnorm<T, M, 1>(l ? xg : nullptr, &xin, H, in_ln + (size_t)l * H, a.eps, xs, buf);
      mark(0);
      step_gemv<W>(ring, kSQkv, xs, red, cs, tot);
      mark(1);
      const int own = owned(kSQkv), col0 = first_col(kSQkv);
      const float* s = srow(a.qkv_s, (size_t)l * nqkv);
      for (int c = t; c < own; c += kFrameThreads) qkvg[col0 + c] = round_to<T>(scaled(cs[c], s, col0 + c));
    }
    end_phase();
    // QK-norm + RoPE + KV append + attention over the chunks, combined by
    // each head's last chunk block.
    if (b < a.heads * nch) {
      mark(0);
      step_attention<T, kNorm>(a, l, nch, qkvg, att_acc, att_ml, att_cnt, attn, misc);
      mark(1);
    }
    end_phase();
    // o + residual.
    if (streams(kSO)) {
      for (int k = t; k < qd; k += kFrameThreads) xs[k] = round_to<M>(__ldcg(attn + k));
      __syncthreads();
      mark(0);
      step_gemv<W>(ring, kSO, xs, red, cs, tot);
      mark(1);
      const int own = owned(kSO), col0 = first_col(kSO);
      const float* s = srow(a.o_s, (size_t)l * H);
      for (int c = t; c < own; c += kFrameThreads) {
        const int col = col0 + c;
        const float res = l ? __ldcg(xg + col) : to_float<T>(xin[col]);
        xg[col] = add_t<T>(res, round_to<T>(scaled(cs[c], s, col)));
      }
    }
    end_phase();
    // RMSNorm -> gate|up -> SiLU(gate) * up.
    if (streams(kSGu)) {
      stage_rmsnorm<T, M, 1>(xg, &xin, H, post_ln + (size_t)l * H, a.eps, xs, buf);
      mark(0);
      step_gemv<W>(ring, kSGu, xs, red, cs, tot);
      mark(1);
      const int own = owned(kSGu), col0 = first_col(kSGu), half = a.proj[kSGu].nv * VW;
      const float* s = srow(a.gu_s, (size_t)l * 2 * I);
      for (int c = t; c < own; c += kFrameThreads) {
        const int i = col0 + c;
        const float gate = round_to<T>(scaled(cs[c], s, i)), up = round_to<T>(scaled(cs[half + c], s, I + i));
        act[i] = mul_t<T>(round_to<T>(__fdiv_rn(gate, __fadd_rn(1.f, expf(-gate)))), up);
      }
    }
    end_phase();
    // down + residual (the last layer's is the step's output).
    if (streams(kSDown)) {
      for (int k = t; k < I; k += kFrameThreads) xs[k] = round_to<M>(__ldcg(act + k));
      __syncthreads();
      mark(0);
      step_gemv<W>(ring, kSDown, xs, red, cs, tot);
      mark(1);
      const int own = owned(kSDown), col0 = first_col(kSDown);
      const float* s = srow(a.down_s, (size_t)l * H);
      T* y = static_cast<T*>(a.y);
      for (int c = t; c < own; c += kFrameThreads) {
        const int col = col0 + c;
        const float v = add_t<T>(__ldcg(xg + col), round_to<T>(scaled(cs[c], s, col)));
        xg[col] = v;
        if (l == a.layers - 1) y[col] = from_float<T>(v);
      }
    }
    end_phase();
  }
}

template <typename T, typename W, bool kNorm>
static cudaError_t launch_step(const StepArgs& a, const StepMaps& maps, cudaStream_t st) {
  // The normalised form divides by the head's weight sum before the value
  // sum: every live row in one chunk.
  if (!step_ok(a, Vec<T>::n, Vec<W>::n, step_head_floats<kNorm>() / 5) || (kNorm && a.max_seq > kStepChunkRows))
    return cudaErrorInvalidValue;
  static int smem_set[kMaxDevices] = {};  // the attribute, per device and instantiation
  if (const cudaError_t e = allow_smem(talker_step_kernel<T, W, kNorm>, smem_set, a.smem_bytes)) return e;
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
  return cudaLaunchKernelEx(&cfg, talker_step_kernel<T, W, kNorm>, a, maps);
}

// The TMA descriptor of each projection's weights, [L][K][N] of W (its
// rows N * item bytes apart, its layers K * N * item), boxes of [1][box_rows]
// [nv vectors], no swizzle (a box lands as its rows one after another).
static cudaError_t encode_step_maps(const StepArgs& a, int dtype, int int8, StepMaps* out) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  if (const cudaError_t e = tensor_map_encoder(&encode)) return e;
  const CUtensorMapDataType type =
      int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int item = int8 ? 1 : dtype == 0 ? 4 : 2;
  const void* base[kStepProjs] = {a.qkv_w, a.o_w, a.gu_w, a.down_w};
  *out = StepMaps{};
  for (int j = 0; j < kStepProjs; ++j) {
    const StepGeom g = step_geom(a, j);
    const StepProjPlan& p = a.proj[j];
    const cuuint64_t dims[3] = {(cuuint64_t)g.N, (cuuint64_t)g.K, (cuuint64_t)a.layers};
    const cuuint64_t strides[2] = {(cuuint64_t)g.N * item, (cuuint64_t)g.K * g.N * item};
    const cuuint32_t box[3] = {(cuuint32_t)(p.nv * kVecBytes / item), (cuuint32_t)p.box_rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult r = encode(&out->m[j], type, 3, const_cast<void*>(base[j]), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

static StepArgs unpack_step(const int* n, const float* f, const void* const* p) {
  StepArgs a{};
  a.layers = n[0]; a.hidden = n[1]; a.heads = n[2]; a.kv_heads = n[3]; a.head_dim = n[4];
  a.inter = n[5]; a.max_seq = n[6]; a.grid = n[7]; a.stage_bytes = n[8];
  a.smem_xs = n[9]; a.smem_red = n[10]; a.smem_cs = n[11]; a.smem_misc = n[12]; a.smem_bytes = n[13];
  for (int j = 0; j < kStepProjs; ++j) {
    const int* q = n + 14 + 4 * j;
    a.proj[j] = StepProjPlan{q[0], q[1], q[2], q[3]};
  }
  a.eps = f ? f[0] : 0.f;
  a.attn_scale = a.head_dim > 0 ? (float)(1.0 / sqrt((double)a.head_dim)) : 0.f;  // as Python rounds 1/sqrt(D)
  if (p) {
    a.qkv_w = p[0]; a.o_w = p[1]; a.gu_w = p[2]; a.down_w = p[3];
    a.qkv_s = static_cast<const float*>(p[4]); a.o_s = static_cast<const float*>(p[5]);
    a.gu_s = static_cast<const float*>(p[6]); a.down_s = static_cast<const float*>(p[7]);
    a.input_ln = p[8]; a.post_ln = p[9]; a.q_norm = p[10]; a.k_norm = p[11];
    a.cos_t = static_cast<const float*>(p[12]); a.sin_t = static_cast<const float*>(p[13]);
    a.scratch = static_cast<float*>(const_cast<void*>(p[14]));
  }
  return a;
}

// The checks both entries share, then the launch of the form `norm`.
static int step_entry(StepArgs& a, bool norm, int dtype, int int8, const void* maps, const void* x, void* y, void* ck,
                      void* cv, int seq, int pos, unsigned long long* trace, void* stream) {
  a.x = x;
  a.y = y;
  a.ck = ck;
  a.cv = cv;
  a.seq = seq;
  a.pos = pos;
  a.trace = trace;
  if (seq < 1 || seq > a.max_seq || pos < 0 || pos >= seq || !a.cos_t || !a.sin_t) return (int)cudaErrorInvalidValue;
  const bool scales = a.qkv_s && a.o_s && a.gu_s && a.down_s, no_scales = !a.qkv_s && !a.o_s && !a.gu_s && !a.down_s;
  if (int8 ? !scales : !no_scales) return (int)cudaErrorInvalidValue;
  StepMaps m;
  memcpy(&m, maps, sizeof m);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (norm)  // kernel 7: int8 only
    e = !int8 ? cudaErrorInvalidValue
        : dtype == 0 ? launch_step<float, int8_t, true>(a, m, st)
                     : launch_step<__nv_bfloat16, int8_t, true>(a, m, st);
  else if (int8)
    e = dtype == 0 ? launch_step<float, int8_t, false>(a, m, st) : launch_step<__nv_bfloat16, int8_t, false>(a, m, st);
  else
    e = dtype == 0 ? launch_step<float, float, false>(a, m, st)
                   : launch_step<__nv_bfloat16, __nv_bfloat16, false>(a, m, st);
  return (int)e;
}

}  // namespace q3

extern "C" {

// Floats of f32 scratch a step needs for the dims and plan in `ints` (the
// layout of q3_talker_step). The scratch must be zeroed once before the
// first step (its barrier and counter words); steps leave it ready for the
// next one.
size_t q3_talker_step_scratch_floats(const int* ints) {
  return q3::step_layout(q3::unpack_step(ints, nullptr, nullptr)).total;
}

// The TMA descriptors of a tree's weights (ints and ptrs as
// q3_talker_step) into `maps` (q3_talker_step_maps_bytes of host memory),
// built once per tree and handed to every q3_talker_step or q3_cp_step of it.
size_t q3_talker_step_maps_bytes() { return sizeof(q3::StepMaps); }

int q3_talker_step_maps(int dtype, int int8, const int* ints, const void* const* ptrs, void* maps) {
  const q3::StepArgs a = q3::unpack_step(ints, nullptr, ptrs);
  q3::StepMaps m;
  const cudaError_t e = q3::encode_step_maps(a, dtype, int8, &m);
  if (e == cudaSuccess) memcpy(maps, &m, sizeof m);
  return (int)e;
}

// Stamps one block records per step when tracing: 4 per phase (work start,
// work end, barrier arrival, barrier leave; 0 where the block has no work
// in the phase), phases in the order the step runs them (5 a layer).
int q3_talker_step_trace_slots(const int* ints) { return q3::step_trace_slots(q3::unpack_step(ints, nullptr, nullptr)); }

// Kernel 3: one decode step in one cooperative launch on `stream`: y [H] <-
// the last layer's output for input x [H], and row `pos` of every layer of
// ck, cv [L, seq, KV*D] written in place (seq <= max_seq, pos < seq). dtype
// 0 = f32, 1 = bf16 for x, y, the norms and the caches; int8 = 0: the
// projections in that dtype, the four scale pointers null; int8 = 1: int8
// with f32 per-column scales. ints: layers, hidden, heads, kv_heads,
// head_dim, inter, max_seq, then the plan (fused_layer.talker_step_plan):
// grid, stage_bytes, the byte offsets of the shared-memory regions (xs,
// red, cs, misc) and the total, and (nv, groups, tile_rows, box_rows) of
// qkv, o, gate|up, down. floats: eps. ptrs: the fused
// projections [in, out] stacked over layers, qkv_w [L, H, (Hq+2KV)*D], o_w
// [L, Hq*D, H], gu_w [L, H, 2I], down_w [L, I, H], the scales qkv_s [L,
// (Hq+2KV)*D], o_s [L, H], gu_s [L, 2I], down_s [L, H], input_ln / post_ln
// [L, H], q_norm / k_norm [L, D], cos_t / sin_t [max_seq, D/2] f32,
// scratch. maps: what q3_talker_step_maps made of the same ints and ptrs.
// Every weight and cache pointer 16-byte aligned. trace: null, or
// [grid][q3_talker_step_trace_slots] u64 that every block fills with its
// phases' stamps (ns, %globaltimer). Returns the CUDA error of the launch
// (a plan, shape or pos the kernel does not take: cudaErrorInvalidValue).
int q3_talker_step(int dtype, int int8, const int* ints, const float* floats, const void* const* ptrs,
                   const void* maps, const void* x, void* y, void* ck, void* cv, int seq, int pos,
                   unsigned long long* trace, void* stream) {
  q3::StepArgs a = q3::unpack_step(ints, floats, ptrs);
  return q3::step_entry(a, false, dtype, int8, maps, x, y, ck, cv, seq, pos, trace, stream);
}

// Kernel 7: one code-predictor decode step, the normalised form, in one
// cooperative launch on `stream`. Arguments as q3_talker_step's, int8
// weights only and max_seq <= 256 (a plan of talker_step_plan(...,
// normalised=True)); cos_t / sin_t [>= pos+1, D/2] f32 are the caller's
// RoPE tables (ptrs' two slots for them are not read).
int q3_cp_step(int dtype, const int* ints, const float* floats, const void* const* ptrs, const void* maps,
               const void* x, void* y, void* ck, void* cv, const float* cos_t, const float* sin_t, int seq, int pos,
               unsigned long long* trace, void* stream) {
  q3::StepArgs a = q3::unpack_step(ints, floats, ptrs);
  a.cos_t = cos_t;
  a.sin_t = sin_t;
  return q3::step_entry(a, true, dtype, 1, maps, x, y, ck, cv, seq, pos, trace, stream);
}

}  // extern "C"
