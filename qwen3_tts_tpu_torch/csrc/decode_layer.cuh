// One batch-1 decode step of one layer on int8 weights, as two sub-layer
// sequences of simple launches: kernels 5 + 6 (fused_step.cu).
//
//   attention: RMSNorm -> int8 qkv -> QK-norm -> RoPE -> cache append at row
//     `pos` -> GQA over the rows <= pos -> int8 o -> (+x);
//   MLP: RMSNorm -> int8 gate|up -> SiLU*up -> int8 down -> (+x).
//
// Rounding points, those of the JAX package's _attention_step_kernel /
// _mlp_step_kernel: every int8 matmul's input is rounded to bf16 and its
// f32 column sum times the column's scale is rounded to the working type T
// (o and down: one flat sum over K); QK-norm in f32 rounded to T; RoPE in T
// with cos/sin rounded to T; scores and the softmax in f32 over the rows <=
// pos, the NORMALISED weights rounded to T before the value sum; the
// attention output rounded to T.
//
// The residual stream stays in T between the sub-layers (its values are
// T-rounded anyway), so a sub-layer reads x and writes y = x + out (or out
// alone, the tensor-parallel partial) and y may be x. Only rows <= pos of
// the cache are read: rows above may hold anything. Row `pos` is the only
// row written.

#pragma once

#include <algorithm>

#include "common.cuh"

namespace q3 {

// heads = 0: the MLP only; inter = 0: the attention only.
struct LayerDims {
  int hidden, heads, kv_heads, head_dim, inter, max_seq;
  bool attention() const { return heads > 0; }
  bool mlp() const { return inter > 0; }
  int qdim() const { return heads * head_dim; }
  int kvdim() const { return kv_heads * head_dim; }
  int nqkv() const { return qdim() + 2 * kvdim(); }
  int nchunks() const { return (max_seq + kAttnChunk - 1) / kAttnChunk; }
};

struct LayerLayout {
  size_t q, attn, part, gu_part, scores, cmax, acc, total;
};

static LayerLayout layer_layout(const LayerDims& d) {
  LayerLayout L{};
  size_t o = 0;
  auto take = [&](size_t n) {
    const size_t at = o;
    o += (n + 63) / 64 * 64;
    return at;
  };
  const bool at = d.attention();
  size_t part = 0;
  if (at) part = std::max(split_size(d.hidden, d.nqkv()), split_size(d.qdim(), d.hidden));
  if (d.mlp()) part = std::max(part, split_size(d.inter, d.hidden));
  const size_t hc = at ? (size_t)d.heads * d.nchunks() : 0;
  L.q = take(at ? d.qdim() : 0);
  L.attn = take(at ? d.qdim() : 0);
  L.part = take(part);
  L.gu_part = take(d.mlp() ? split_size(d.hidden, 2 * d.inter) : 0);
  L.scores = take(at ? (size_t)d.heads * d.max_seq : 0);
  L.cmax = take(hc);
  L.acc = take(hc * (at ? d.head_dim : 0));
  L.total = o;
  return L;
}

static bool layer_dims_ok(const LayerDims& d) {
  const int cols = gemv_cols<int8_t>();  // a multiple of kGemvRows
  if (d.hidden <= 0 || d.hidden % cols || d.heads < 0 || d.inter < 0 || !(d.attention() || d.mlp())) return false;
  if (d.attention() &&
      (d.kv_heads <= 0 || d.heads % d.kv_heads || d.head_dim <= 0 || d.head_dim % 32 || d.head_dim > 256 ||
       d.max_seq <= 0 || d.nqkv() % cols || d.qdim() % kGemvRows))
    return false;
  return !d.mlp() || ((2 * d.inter) % cols == 0 && d.inter % kGemvRows == 0);
}

// Pass 2 of the normalised attention, grid (Hq, chunks up to pos), blockDim
// = head_dim: the maximum over all chunks' maxima; the denominator, the sum
// of exp(s - max) over the rows <= pos (one block reduction, which every
// block of the head computes alike); then the chunk's per-dim sum of
// round_T(exp(s - max) / denominator) * v.
template <typename T>
static __global__ void attn_softmax_values(const float* __restrict__ scores, const float* __restrict__ cmax,
                                           const T* __restrict__ cv, int pos, int Hq, int KV, int S,
                                           float* __restrict__ acc) {
  __shared__ float buf[32];
  const int h = blockIdx.x, c = blockIdx.y, nch = gridDim.y, D = blockDim.x, t = threadIdx.x;
  const int kvd = KV * D, voff = (h / (Hq / KV)) * D;
  const float* sh = scores + (size_t)h * S;
  float mx = cmax[h * nch];
  for (int i = 1; i < nch; ++i) mx = fmaxf(mx, cmax[h * nch + i]);
  float den = 0.f;
  for (int r = t; r <= pos; r += D) den += expf(__fsub_rn(sh[r], mx));
  den = block_sum(den, buf);
  const int r0 = c * kAttnChunk, r1 = min(r0 + kAttnChunk, pos + 1);
  float a = 0.f;
  for (int r = r0; r < r1; ++r) {
    const float w = round_to<T>(__fdiv_rn(expf(__fsub_rn(sh[r], mx)), den));
    a = fmaf(w, to_float<T>(cv[(size_t)r * kvd + voff + t]), a);
  }
  acc[((size_t)h * nch + c) * D + t] = a;
}

// Pass 3, grid Hq, blockDim = head_dim: the chunks' sums in chunk order,
// rounded to T (the o GEMV rounds its input to bf16 in its staging).
template <typename T>
static __global__ void attn_sum_chunks(const float* __restrict__ acc, int nch, float* __restrict__ out) {
  const int h = blockIdx.x, D = blockDim.x, t = threadIdx.x;
  float a = 0.f;
  for (int c = 0; c < nch; ++c) a += acc[((size_t)h * nch + c) * D + t];
  out[h * D + t] = round_to<T>(a);
}

struct AttnArgs {
  const void *x, *ln;
  const int8_t* qkv_w;
  const float* qkv_s;
  const void *q_norm, *k_norm;
  const float *cos_t, *sin_t;  // [>= pos+1, D/2] f32
  const int8_t* o_w;
  const float* o_s;
  void *ck, *cv;  // [S, KV*D] planes of this layer
  int pos;
  float eps;
  int residual;
  void* y;
};

// The attention sub-layer: 7 launches.
template <typename T>
static cudaError_t attention_sublayer(const LayerDims& d, const AttnArgs& a, float* scratch, cudaStream_t st) {
  const LayerLayout Lo = layer_layout(d);
  float *q = scratch + Lo.q, *attn = scratch + Lo.attn, *part = scratch + Lo.part;
  float *scores = scratch + Lo.scores, *cmax = scratch + Lo.cmax, *acc = scratch + Lo.acc;
  const int H = d.hidden, D = d.head_dim, Hq = d.heads, KV = d.kv_heads, qd = d.qdim(), S = d.max_seq;
  const T* x = static_cast<const T*>(a.x);
  T* ck = static_cast<T*>(a.ck);
  T* cv = static_cast<T*>(a.cv);
  const float scale = (float)(1.0 / sqrt((double)D));  // as Python rounds 1/sqrt(D)
  const int nlive = a.pos / kAttnChunk + 1, ew = 256;
  const dim3 grid(Hq, nlive);
  cudaError_t e;

  const GemvInput<T> x_in{nullptr, x, nullptr, 0, nullptr, 0, nullptr, static_cast<const T*>(a.ln), a.eps};
  if ((e = gemv<T, int8_t>(x_in, a.qkv_w, H, d.nqkv(), part, st))) return e;
  qkv_finish<T><<<Hq + KV, D, 0, st>>>(part, H / kGemvRows, a.qkv_s, static_cast<const T*>(a.q_norm),
                                       static_cast<const T*>(a.k_norm), a.cos_t, a.sin_t, a.pos, Hq, KV, a.eps, q,
                                       ck, cv);
  Q3_CHECK_LAUNCH();
  attn_scores<T><<<grid, kAttnWarps * 32, 0, st>>>(q, ck, a.pos, Hq, KV, D, S, scale, scores, cmax);
  Q3_CHECK_LAUNCH();
  attn_softmax_values<T><<<grid, D, 0, st>>>(scores, cmax, cv, a.pos, Hq, KV, S, acc);
  Q3_CHECK_LAUNCH();
  attn_sum_chunks<T><<<Hq, D, 0, st>>>(acc, nlive, attn);
  Q3_CHECK_LAUNCH();
  if ((e = gemv<T, int8_t>(vec_input<T>(attn), a.o_w, qd, H, part, st))) return e;
  residual_out<T><<<(H + ew - 1) / ew, ew, 0, st>>>(part, qd / kGemvRows, H, a.o_s, x, a.residual,
                                                    static_cast<T*>(a.y));
  Q3_CHECK_LAUNCH();
  return cudaSuccess;
}

struct MlpArgs {
  const void *x, *ln;
  const int8_t* gu_w;
  const float* gu_s;
  const int8_t* down_w;
  const float* down_s;
  float eps;
  int residual;
  void* y;
};

// The MLP sub-layer: 3 launches (SiLU*up is the down GEMV's input staging).
template <typename T>
static cudaError_t mlp_sublayer(const LayerDims& d, const MlpArgs& a, float* scratch, cudaStream_t st) {
  const LayerLayout Lo = layer_layout(d);
  float *part = scratch + Lo.part, *gu_part = scratch + Lo.gu_part;
  const int H = d.hidden, I = d.inter, ew = 256;
  const T* x = static_cast<const T*>(a.x);
  cudaError_t e;

  const GemvInput<T> x_in{nullptr, x, nullptr, 0, nullptr, 0, nullptr, static_cast<const T*>(a.ln), a.eps};
  if ((e = gemv<T, int8_t>(x_in, a.gu_w, H, 2 * I, gu_part, st))) return e;
  const GemvInput<T> swiglu_in{nullptr, nullptr, nullptr, 0, gu_part, H / kGemvRows, a.gu_s, nullptr, 0.f};
  if ((e = gemv<T, int8_t>(swiglu_in, a.down_w, I, H, part, st))) return e;
  residual_out<T><<<(H + ew - 1) / ew, ew, 0, st>>>(part, I / kGemvRows, H, a.down_s, x, a.residual,
                                                    static_cast<T*>(a.y));
  Q3_CHECK_LAUNCH();
  return cudaSuccess;
}

}  // namespace q3
