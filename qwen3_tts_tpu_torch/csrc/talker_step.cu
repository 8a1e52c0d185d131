// Kernel 3 of the port: one batch-1 talker decode step, on int8 weights or
// on plain weights in the working type.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/fused_layer.py:
// _streamed_talker_kernel (entry streamed_talker_step), in both its forms
// (`quantized` True / False): the step's input embedding through every
// talker layer (RMSNorm -> qkv -> QK-norm -> RoPE -> KV append at row `pos`
// -> GQA over the cache rows <= pos -> o -> residual -> RMSNorm -> gate|up
// -> SiLU*up -> down -> residual), returning the last layer's output (the
// final norm and codec head stay outside, as in the JAX package).
//
// What bounds it on an H100: at 1.7B a step streams 28 layers of weights,
// 50.3 MB each in int8 (1.41 GB, ~0.42 ms at 3.35 TB/s) or 100.7 MB in bf16
// (2.82 GB, ~0.84 ms), plus the live cache rows (2 x 28 x (pos+1) x 1024
// bf16: 117 KB per row); one GEMV per projection at batch 1, so bytes, not
// flops -- and in this first version the ~280 dependent launches of a step.
//
// Design: one C entry point per step runs a fixed sequence of simple
// kernels on the caller's stream, built from the split-K GEMV of the
// code-predictor frame (common.cuh), instantiated for the weight type W:
// int8 weights read one byte each with the per-column scale applied once to
// the finished column sum (the JAX kernel's `acc * scale`), matmul inputs
// rounded to bf16; plain weights (W = T, the JAX kernel's `quantized=False`)
// read in their own type, no scale, matmul inputs kept in T. RMSNorm and
// SiLU*up are fused into the GEMV input staging, partial sums are added in a
// fixed order (deterministic, no atomics), and o and down add their K
// splits in H-wide chunks in ascending order, as the JAX kernel adds its
// K tiles. The TPU kernel's [H, H] tile re-layout, weight DMA ring,
// per-layer cache-plane copies and 16-row write-back slab are TPU
// artefacts: here the weights stay in the canonical [L, K, N] layout and
// the step writes row `pos` of each layer's K and V in place in the [L, S,
// KV*D] cache view. Attention splits the rows <= pos into 64-row chunks (a
// block per q head and chunk: 16 x 33 blocks at the 2048-frame tier), in
// three passes with a fixed-order combine: scores and each chunk's maximum;
// exp against the maximum over all chunks, each chunk's weight sum and
// weighted value sum (weights rounded to the working type); the combine and
// division. The result does not depend on timing or on the chunking of
// other blocks.

#include <algorithm>

#include "common.cuh"

namespace q3 {

struct TalkerDims {
  int layers, hidden, heads, kv_heads, head_dim, inter, max_seq;
  int qdim() const { return heads * head_dim; }
  int kvdim() const { return kv_heads * head_dim; }
  int nqkv() const { return qdim() + 2 * kvdim(); }
  int nchunks() const { return (max_seq + kAttnChunk - 1) / kAttnChunk; }
};

struct TalkerLayout {
  size_t x, q, attn, part, gu_part, scores, cmax, lsum, acc, total;
};

static TalkerLayout talker_layout(const TalkerDims& d) {
  TalkerLayout L{};
  size_t o = 0;
  auto take = [&](size_t n) {
    const size_t at = o;
    o += (n + 63) / 64 * 64;
    return at;
  };
  size_t part = split_size(d.hidden, d.nqkv());
  part = std::max(part, split_size(d.qdim(), d.hidden));
  part = std::max(part, split_size(d.inter, d.hidden));
  const size_t hc = (size_t)d.heads * d.nchunks();
  L.x = take(d.hidden);
  L.q = take(d.qdim());
  L.attn = take(d.qdim());
  L.part = take(part);
  L.gu_part = take(split_size(d.hidden, 2 * d.inter));
  L.scores = take((size_t)d.heads * d.max_seq);
  L.cmax = take(hc);
  L.lsum = take(hc);
  L.acc = take(hc * d.head_dim);
  L.total = o;
  return L;
}

template <typename T>
__global__ void load_input(const T* __restrict__ in, int H, float* __restrict__ x) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < H) x[i] = to_float<T>(in[i]);
}

template <typename T>
__global__ void store_output(const float* __restrict__ x, int H, T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < H) out[i] = from_float<T>(x[i]);
}

// Pass 2, grid (Hq, chunks), blockDim = head_dim: against the maximum over
// all chunks, p_r = exp(s_r - max); the chunk's sum of p (f32) and, per
// dim, sum of round_T(p_r) * v_r.
template <typename T>
__global__ void attn_values(const float* __restrict__ scores, const float* __restrict__ cmax,
                            const T* __restrict__ cv, int pos, int Hq, int KV, int S, float* __restrict__ lsum,
                            float* __restrict__ acc) {
  const int h = blockIdx.x, c = blockIdx.y, nch = gridDim.y, D = blockDim.x, t = threadIdx.x;
  const int kvd = KV * D, voff = (h / (Hq / KV)) * D;
  float mx = cmax[h * nch];
  for (int i = 1; i < nch; ++i) mx = fmaxf(mx, cmax[h * nch + i]);
  const int r0 = c * kAttnChunk, r1 = min(r0 + kAttnChunk, pos + 1);
  float l = 0.f, a = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float p = expf(__fsub_rn(scores[(size_t)h * S + r], mx));
    l += p;
    a = fmaf(round_to<T>(p), to_float<T>(cv[(size_t)r * kvd + voff + t]), a);
  }
  acc[((size_t)h * nch + c) * D + t] = a;
  if (t == 0) lsum[h * nch + c] = l;
}

// Pass 3, grid Hq, blockDim = head_dim: chunks added in order, divided.
// The o GEMV rounds the result to bf16 in its input staging.
__global__ void attn_combine(const float* __restrict__ lsum, const float* __restrict__ acc, int nch,
                             float* __restrict__ out) {
  const int h = blockIdx.x, D = blockDim.x, t = threadIdx.x;
  float l = 0.f, a = 0.f;
  for (int c = 0; c < nch; ++c) {
    l += lsum[h * nch + c];
    a += acc[((size_t)h * nch + c) * D + t];
  }
  out[h * D + t] = __fdiv_rn(a, l);
}

// The projections are int8 with f32 per-column scales, or plain (the
// working type, scales null).
struct TalkerArgs {
  const void* x;
  const void *qkv_w, *o_w, *gu_w, *down_w;
  const float *qkv_s, *o_s, *gu_s, *down_s;
  const void *input_ln, *post_ln, *q_norm, *k_norm;
  const float *cos_t, *sin_t;
  void *ck, *cv;
  int pos;
  float eps;
  float* scratch;
  void* y;
};

// A scale row of layer l, or null for plain weights.
static const float* layer_scale(const float* s, int l, int n) { return s ? s + (size_t)l * n : nullptr; }

template <typename T, typename W>
static cudaError_t run_step(const TalkerDims& d, const TalkerArgs& a, cudaStream_t st) {
  const TalkerLayout Lo = talker_layout(d);
  float* s = a.scratch;
  float *x = s + Lo.x, *q = s + Lo.q, *attn = s + Lo.attn, *part = s + Lo.part, *gu_part = s + Lo.gu_part;
  float *scores = s + Lo.scores, *cmax = s + Lo.cmax, *lsum = s + Lo.lsum, *acc = s + Lo.acc;
  const int H = d.hidden, D = d.head_dim, I = d.inter, S = d.max_seq;
  const int Hq = d.heads, KV = d.kv_heads, kvd = d.kvdim(), qd = d.qdim(), nqkv = d.nqkv();
  const T* in_ln = static_cast<const T*>(a.input_ln);
  const T* post_ln = static_cast<const T*>(a.post_ln);
  const T* qn = static_cast<const T*>(a.q_norm);
  const T* kn = static_cast<const T*>(a.k_norm);
  T* ck = static_cast<T*>(a.ck);
  T* cv = static_cast<T*>(a.cv);
  const W* qkv_w = static_cast<const W*>(a.qkv_w);
  const W* o_w = static_cast<const W*>(a.o_w);
  const W* gu_w = static_cast<const W*>(a.gu_w);
  const W* down_w = static_cast<const W*>(a.down_w);
  const float scale = (float)(1.0 / sqrt((double)D));  // as Python rounds 1/sqrt(D)
  const int ew = 256, nlive = a.pos / kAttnChunk + 1, per = H / kGemvRows;
  const dim3 attn_grid(Hq, nlive);
  cudaError_t e;

  load_input<T><<<(H + ew - 1) / ew, ew, 0, st>>>(static_cast<const T*>(a.x), H, x);
  Q3_CHECK_LAUNCH();
  for (int l = 0; l < d.layers; ++l) {
    T* ckl = ck + (size_t)l * S * kvd;
    T* cvl = cv + (size_t)l * S * kvd;
    // RMSNorm -> qkv; q / k norms, RoPE, k|v append; attention; o; residual.
    if ((e = gemv<T, W>(vec_input<T>(x, in_ln + (size_t)l * H, a.eps), qkv_w + (size_t)l * H * nqkv, H, nqkv, part,
                        st)))
      return e;
    qkv_finish<T><<<Hq + KV, D, 0, st>>>(part, H / kGemvRows, layer_scale(a.qkv_s, l, nqkv), qn + (size_t)l * D,
                                         kn + (size_t)l * D, a.cos_t, a.sin_t, a.pos, Hq, KV, a.eps, q, ckl, cvl);
    Q3_CHECK_LAUNCH();
    attn_scores<T><<<attn_grid, kAttnWarps * 32, 0, st>>>(q, ckl, a.pos, Hq, KV, D, S, scale, scores, cmax);
    Q3_CHECK_LAUNCH();
    attn_values<T><<<attn_grid, D, 0, st>>>(scores, cmax, cvl, a.pos, Hq, KV, S, lsum, acc);
    Q3_CHECK_LAUNCH();
    attn_combine<<<Hq, D, 0, st>>>(lsum, acc, nlive, attn);
    Q3_CHECK_LAUNCH();
    if ((e = gemv<T, W>(vec_input<T>(attn), o_w + (size_t)l * qd * H, qd, H, part, st))) return e;
    residual_out<T, float><<<(H + ew - 1) / ew, ew, 0, st>>>(part, qd / kGemvRows, per, H, layer_scale(a.o_s, l, H),
                                                             x, 1, x);
    Q3_CHECK_LAUNCH();
    // RMSNorm -> gate|up; SiLU*up feeding down; residual.
    if ((e = gemv<T, W>(vec_input<T>(x, post_ln + (size_t)l * H, a.eps), gu_w + (size_t)l * H * 2 * I, H, 2 * I,
                        gu_part, st)))
      return e;
    const GemvInput<T> swiglu_in{nullptr, nullptr, nullptr, 0, gu_part, H / kGemvRows,
                                 layer_scale(a.gu_s, l, 2 * I), nullptr, 0.f};
    if ((e = gemv<T, W>(swiglu_in, down_w + (size_t)l * I * H, I, H, part, st))) return e;
    residual_out<T, float><<<(H + ew - 1) / ew, ew, 0, st>>>(part, I / kGemvRows, per, H,
                                                             layer_scale(a.down_s, l, H), x, 1, x);
    Q3_CHECK_LAUNCH();
  }
  store_output<T><<<(H + ew - 1) / ew, ew, 0, st>>>(x, H, static_cast<T*>(a.y));
  Q3_CHECK_LAUNCH();
  return cudaSuccess;
}

template <typename W>
static bool talker_dims_ok(const TalkerDims& d) {
  const int cols = gemv_cols<W>();
  const int ns[] = {d.nqkv(), d.hidden, 2 * d.inter};
  for (int n : ns)
    if (n % cols) return false;
  const int ks[] = {d.hidden, d.qdim(), d.inter};
  for (int k : ks)
    if (k % kGemvRows) return false;
  return d.head_dim % 32 == 0 && d.head_dim <= 256 && d.heads % d.kv_heads == 0 && d.layers > 0 &&
         d.max_seq > 0;
}

// Whether the kernel takes these shapes for dtype (0 f32, 1 bf16) and
// weight kind (quantized: int8, else plain in the working type).
static bool talker_takes(int dtype, int quantized, const TalkerDims& d) {
  if (quantized != 0 && quantized != 1) return false;
  if (dtype == 0) return quantized ? talker_dims_ok<int8_t>(d) : talker_dims_ok<float>(d);
  if (dtype == 1) return quantized ? talker_dims_ok<int8_t>(d) : talker_dims_ok<__nv_bfloat16>(d);
  return false;
}

}  // namespace q3

extern "C" {

// Floats of f32 scratch one step needs (0 when the kernel does not take the
// dtype, weight kind or shapes).
size_t q3_talker_step_scratch_floats(int dtype, int quantized, int layers, int hidden, int heads, int kv_heads,
                                     int head_dim, int inter, int max_seq) {
  const q3::TalkerDims d{layers, hidden, heads, kv_heads, head_dim, inter, max_seq};
  return q3::talker_takes(dtype, quantized, d) ? q3::talker_layout(d).total : 0;
}

// One decode step: y [H] <- the last layer's output for input x [H], and
// row `pos` of every layer of ck, cv [L, S, KV*D] written in place. dtype
// 0 = f32, 1 = bf16 for x, y, the norms and the caches. The projections are
// fused and stacked over layers, [in, out]: qkv_w [L, H, (Hq+2KV)*D], o_w
// [L, Hq*D, H], gu_w [L, H, 2I], down_w [L, I, H]; quantized = 1: int8 with
// f32 per-column scales qkv_s [L, (Hq+2KV)*D], o_s [L, H], gu_s [L, 2I],
// down_s [L, H]; quantized = 0: plain in the working type, scales null.
// input_ln/post_ln [L, H], q_norm/k_norm [L, D]; cos_t/sin_t [S, D/2] f32.
int q3_talker_step(int dtype, int quantized, const void* x, const void* qkv_w, const float* qkv_s, const void* o_w,
                   const float* o_s, const void* gu_w, const float* gu_s, const void* down_w, const float* down_s,
                   const void* input_ln, const void* post_ln, const void* q_norm, const void* k_norm,
                   const float* cos_t, const float* sin_t, void* ck, void* cv, int layers, int hidden, int heads,
                   int kv_heads, int head_dim, int inter, int max_seq, int pos, float eps, float* scratch, void* y,
                   void* stream) {
  const q3::TalkerDims d{layers, hidden, heads, kv_heads, head_dim, inter, max_seq};
  if (!q3::talker_takes(dtype, quantized, d) || pos < 0 || pos >= max_seq) return (int)cudaErrorInvalidValue;
  const bool scales = qkv_s && o_s && gu_s && down_s, no_scales = !qkv_s && !o_s && !gu_s && !down_s;
  if (quantized ? !scales : !no_scales) return (int)cudaErrorInvalidValue;
  const q3::TalkerArgs a{x,        qkv_w,   o_w,    gu_w,   down_w, qkv_s, o_s, gu_s,    down_s, input_ln,
                         post_ln,  q_norm,  k_norm, cos_t,  sin_t,  ck,    cv,  pos,     eps,    scratch, y};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = quantized ? q3::run_step<float, int8_t>(d, a, st) : q3::run_step<float, float>(d, a, st);
  else
    e = quantized ? q3::run_step<__nv_bfloat16, int8_t>(d, a, st)
                  : q3::run_step<__nv_bfloat16, __nv_bfloat16>(d, a, st);
  return (int)e;
}

}  // extern "C"
