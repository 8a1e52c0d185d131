// Kernel 1 of the port: the whole code-predictor frame.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/fused_layer.py:_cp_frame_kernel
// (entry streamed_cp_frame): all 15 acoustic codes of one frame, i.e. the two
// prefill rows (talker hidden, semantic embedding) and 14 code steps, each
// through 5 decoder layers (RMSNorm -> qkv -> QK-norm -> RoPE -> KV append ->
// GQA over <= 16 rows -> o -> residual -> RMSNorm -> SwiGLU -> residual),
// then final norm, lm head g and argmax. The code of step g feeds the
// embedding gather of step g+1 on the device; nothing returns to the host.
//
// What bounds it on an H100: at 1.7B every position streams ~31.5 MB of bf16
// layer weights (x5 layers x16 positions ~2.4 GB per frame, plus 15 heads and
// embedding rows), so the frame is bound by device-memory bandwidth at batch
// 1 (one GEMV per projection: 2 flops per weight byte pair), and, in this
// first version, by launch latency: the frame is ~640 small launches.
//
// Design: one C entry point per frame runs a fixed sequence of simple
// kernels on the caller's stream. GEMVs read the [in, out] weights with
// 16-byte (int8: 8-byte) vector loads, split K over grid.y into 64-row slices (>= 128 blocks
// per GEMV so the card's SMs all stream), and write f32 partial sums that the
// consumer kernel adds in a fixed order -- deterministic, no atomics. The
// RMSNorm that precedes a projection is fused into the GEMV's input staging,
// and so is SiLU*up into the down GEMV's; QK-norm + RoPE + KV append + GQA
// over <= 16 rows is one kernel with a block per q head; the argmax is two
// passes (ties -> lowest index, as jnp.argmax / torch.argmax). Activations live in an f32 scratch
// holding values rounded to the working type at the same points as the
// plain PyTorch version, so the f32 program equals it up to summation order.
// The TPU kernel's VMEM residency, DMA rings and split embedding tables are
// TPU artefacts and are not carried over; wgmma/TMA/persistence come later.
//
// Int8 mode (weight-only int8, the TPU kernel's int8 tiles): the layer
// projections and the lm heads are int8 with per-column f32 scales, read as
// one byte each (half the bytes of bf16); every GEMV input is rounded to
// bf16 and the scale multiplies the finished column sum once, before the
// column is rounded to the working type -- the JAX package's
// `acc * scale` points. Activations, norms, embeddings and the mtp
// projection stay in the working type (f32 or bf16). The split-K GEMV and
// its input staging are shared with the talker step (common.cuh).

#include <algorithm>

#include "common.cuh"

namespace q3 {

constexpr int kCpMaxRows = 16;     // 2 prefill rows + 14 code rows

// x <- the input row of a position: round(round(row @ mtp_w) + mtp_b) when
// `part` holds the mtp GEMV, else the raw row of `table`.
template <typename T>
__global__ void embed_post(const float* __restrict__ part, int nsplit, const T* __restrict__ bias,
                           const T* __restrict__ table, const int* __restrict__ idx, int row_const, int H,
                           float* __restrict__ x) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H) return;
  if (part) {
    x[i] = add_t<T>(round_to<T>(sum_parts(part, nsplit, H, i)), to_float<T>(bias[i]));
  } else {
    x[i] = to_float<T>(table[(size_t)(idx ? idx[0] : row_const) * H + i]);
  }
}

// One block per q head (blockDim = head_dim): finish the qkv sums, QK-norm +
// RoPE on q and on its kv head's k, append k and v to cache row `pos` (the
// first q head of each kv group writes them), then causal GQA over rows
// 0..pos, row `pos` from registers; f32 scores and softmax, weights rounded
// to T. Rows < pos were written by earlier launches, so no block reads a row
// that another block of this launch writes.
template <typename T>
__global__ void attention_step(const float* __restrict__ part, int nsplit, const float* __restrict__ qkv_s,
                               const T* __restrict__ qn,
                               const T* __restrict__ kn, const float* __restrict__ cos_t,
                               const float* __restrict__ sin_t, int pos, int Hq, int KV, float eps, float scale,
                               float* __restrict__ kc, float* __restrict__ vc, float* __restrict__ out) {
  __shared__ float vals[256];
  __shared__ float buf[32];
  __shared__ float sc[kCpMaxRows];
  const int D = blockDim.x, t = threadIdx.x, h = blockIdx.x, group = Hq / KV;
  const int N = (Hq + 2 * KV) * D, kvd = KV * D, col = (h / group) * D + t;
  const int qc = h * D + t, kc_ = Hq * D + col, vc_ = (Hq + KV) * D + col;
  const float q = qk_norm_rope<T>(round_to<T>(scaled(sum_parts(part, nsplit, N, qc), qkv_s, qc)), qn, cos_t, sin_t,
                                  pos, eps, vals, buf);
  const float k = qk_norm_rope<T>(round_to<T>(scaled(sum_parts(part, nsplit, N, kc_), qkv_s, kc_)), kn, cos_t,
                                  sin_t, pos, eps, vals, buf);
  const float v = round_to<T>(scaled(sum_parts(part, nsplit, N, vc_), qkv_s, vc_));
  if (h % group == 0) {
    kc[(size_t)pos * kvd + col] = k;
    vc[(size_t)pos * kvd + col] = v;
  }
  for (int r = 0; r <= pos; ++r) {
    const float s = block_sum(q * (r == pos ? k : kc[(size_t)r * kvd + col]), buf);
    if (t == 0) sc[r] = __fmul_rn(s, scale);
  }
  __syncthreads();
  float m = -INFINITY;
  for (int r = 0; r <= pos; ++r) m = fmaxf(m, sc[r]);
  float den = 0.f;
  for (int r = 0; r <= pos; ++r) den += expf(__fsub_rn(sc[r], m));
  float acc = 0.f;
  for (int r = 0; r <= pos; ++r) {
    const float wgt = round_to<T>(__fdiv_rn(expf(__fsub_rn(sc[r], m)), den));
    acc = fmaf(wgt, r == pos ? v : vc[(size_t)r * kvd + col], acc);
  }
  out[h * D + t] = round_to<T>(acc);
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Pass 1 of the argmax: each 256-column block of the logits (rounded to T).
template <typename T>
__global__ void argmax_partial(const float* __restrict__ part, int nsplit, int V, const float* __restrict__ scale,
                               float* __restrict__ best_v, int* __restrict__ best_i) {
  __shared__ float sv[256];
  __shared__ int si[256];
  const int t = threadIdx.x, c = blockIdx.x * 256 + t;
  sv[t] = c < V ? round_to<T>(scaled(sum_parts(part, nsplit, V, c), scale, c)) : -INFINITY;
  si[t] = c < V ? c : 0x7fffffff;
  __syncthreads();
  for (int s = 128; s > 0; s >>= 1) {
    if (t < s && better(sv[t + s], si[t + s], sv[t], si[t])) {
      sv[t] = sv[t + s];
      si[t] = si[t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    best_v[blockIdx.x] = sv[0];
    best_i[blockIdx.x] = si[0];
  }
}

// Pass 2: the blocks in index order; the first maximum wins.
__global__ void argmax_final(const float* __restrict__ best_v, const int* __restrict__ best_i, int n,
                             int* __restrict__ code) {
  float bv = best_v[0];
  int bi = best_i[0];
  for (int b = 1; b < n; ++b)
    if (better(best_v[b], best_i[b], bv, bi)) {
      bv = best_v[b];
      bi = best_i[b];
    }
  *code = bi;
}

struct CpDims {
  int layers, hidden, heads, kv_heads, head_dim, inter, vocab, embed, groups;
  int qdim() const { return heads * head_dim; }
  int kvdim() const { return kv_heads * head_dim; }
  int nqkv() const { return qdim() + 2 * kvdim(); }
};

struct CpLayout {
  size_t x, attn, part, gu_part, kc, vc, best_v, best_i, total;
};

static CpLayout cp_layout(const CpDims& d) {
  CpLayout L{};
  size_t o = 0;
  auto take = [&](size_t n) {
    const size_t at = o;
    o += (n + 63) / 64 * 64;
    return at;
  };
  size_t part = split_size(d.hidden, d.nqkv());
  part = std::max(part, split_size(d.qdim(), d.hidden));
  part = std::max(part, split_size(d.inter, d.hidden));
  part = std::max(part, split_size(d.hidden, d.vocab));
  part = std::max(part, split_size(d.embed, d.hidden));
  L.x = take(d.hidden);
  L.attn = take(d.qdim());
  L.part = take(part);
  L.gu_part = take(split_size(d.hidden, 2 * d.inter));
  L.kc = take((size_t)d.layers * kCpMaxRows * d.kvdim());
  L.vc = take((size_t)d.layers * kCpMaxRows * d.kvdim());
  L.best_v = take(256);
  L.best_i = take(256);
  L.total = o;
  return L;
}

struct CpArgs {
  const void *xs, *etab, *mtp_w, *mtp_b, *qkv_w, *o_w, *gu_w, *down_w;
  const float *qkv_s, *o_s, *gu_s, *down_s;  // int8 mode: [L, N] scales; else null
  const void *input_ln, *post_ln, *q_norm, *k_norm, *final_norm, *heads;
  const float* heads_s;  // int8 mode: [G, V]; else null
  const float *cos_t, *sin_t;
  float eps;
  float* scratch;
  int* codes;
};

// T: activations, norms, embeddings, mtp projection; W: the layer
// projections and heads (T, or int8_t with the scales in `a`).
template <typename T, typename W>
static cudaError_t run_frame(const CpDims& d, const CpArgs& a, cudaStream_t st) {
  const CpLayout L = cp_layout(d);
  float* s = a.scratch;
  float *x = s + L.x, *attn = s + L.attn, *part = s + L.part, *gu_part = s + L.gu_part;
  float *kc = s + L.kc, *vc = s + L.vc, *best_v = s + L.best_v;
  int* best_i = reinterpret_cast<int*>(s + L.best_i);
  const int H = d.hidden, D = d.head_dim, I = d.inter, V = d.vocab, E = d.embed;
  const int Hq = d.heads, KV = d.kv_heads, kvd = d.kvdim(), qd = d.qdim(), nqkv = d.nqkv();
  const T* xs = static_cast<const T*>(a.xs);
  const T* etab = static_cast<const T*>(a.etab);
  const T* mtp_w = static_cast<const T*>(a.mtp_w);
  const T* mtp_b = static_cast<const T*>(a.mtp_b);
  const W* qkv_w = static_cast<const W*>(a.qkv_w);
  const W* o_w = static_cast<const W*>(a.o_w);
  const W* gu_w = static_cast<const W*>(a.gu_w);
  const W* down_w = static_cast<const W*>(a.down_w);
  const T* in_ln = static_cast<const T*>(a.input_ln);
  const T* post_ln = static_cast<const T*>(a.post_ln);
  const T* qn = static_cast<const T*>(a.q_norm);
  const T* kn = static_cast<const T*>(a.k_norm);
  const T* fnorm = static_cast<const T*>(a.final_norm);
  const W* heads = static_cast<const W*>(a.heads);
  // Per-layer / per-head scale rows (null in plain mode).
  auto srow = [](const float* s, size_t off) { return s ? s + off : nullptr; };
  const float scale = (float)(1.0 / sqrt((double)D));  // as Python rounds 1/sqrt(D)
  const int ew = 256;
  cudaError_t e;

  for (int p = 0; p <= d.groups; ++p) {
    // Input row: a prefill row, or group (p-2)'s embedding of code p-2.
    const T* table = p < 2 ? xs : etab + (size_t)(p - 2) * V * E;
    const int* idx = p < 2 ? nullptr : a.codes + (p - 2);
    const int row = p < 2 ? p : 0;
    if (mtp_w) {
      const GemvInput<T> row_in{nullptr, table, idx, row, nullptr, 0, nullptr, nullptr, 0.f};
      if ((e = gemv<T, T>(row_in, mtp_w, E, H, part, st))) return e;
      embed_post<T><<<(H + ew - 1) / ew, ew, 0, st>>>(part, E / kGemvRows, mtp_b, nullptr, nullptr, 0, H, x);
    } else {
      embed_post<T><<<(H + ew - 1) / ew, ew, 0, st>>>(nullptr, 0, nullptr, table, idx, row, H, x);
    }
    Q3_CHECK_LAUNCH();

    for (int l = 0; l < d.layers; ++l) {
      // RMSNorm -> qkv; QK-norm + RoPE + KV append + GQA; o; residual.
      if ((e = gemv<T, W>(vec_input<T>(x, in_ln + (size_t)l * H, a.eps), qkv_w + (size_t)l * H * nqkv, H, nqkv,
                          part, st)))
        return e;
      attention_step<T><<<Hq, D, 0, st>>>(part, H / kGemvRows, srow(a.qkv_s, (size_t)l * nqkv), qn + (size_t)l * D,
                                          kn + (size_t)l * D, a.cos_t, a.sin_t, p, Hq, KV, a.eps, scale,
                                          kc + (size_t)l * kCpMaxRows * kvd, vc + (size_t)l * kCpMaxRows * kvd, attn);
      Q3_CHECK_LAUNCH();
      if ((e = gemv<T, W>(vec_input<T>(attn), o_w + (size_t)l * qd * H, qd, H, part, st))) return e;
      residual_out<T, float><<<(H + ew - 1) / ew, ew, 0, st>>>(
          part, qd / kGemvRows, qd / kGemvRows, H, srow(a.o_s, (size_t)l * H), x, 1, x);
      Q3_CHECK_LAUNCH();
      // RMSNorm -> gate|up; SiLU*up feeding down; residual.
      if ((e = gemv<T, W>(vec_input<T>(x, post_ln + (size_t)l * H, a.eps), gu_w + (size_t)l * H * 2 * I, H, 2 * I,
                          gu_part, st)))
        return e;
      const GemvInput<T> swiglu_in{nullptr, nullptr, nullptr, 0, gu_part, H / kGemvRows,
                                   srow(a.gu_s, (size_t)l * 2 * I), nullptr, 0.f};
      if ((e = gemv<T, W>(swiglu_in, down_w + (size_t)l * I * H, I, H, part, st))) return e;
      residual_out<T, float><<<(H + ew - 1) / ew, ew, 0, st>>>(
          part, I / kGemvRows, I / kGemvRows, H, srow(a.down_s, (size_t)l * H), x, 1, x);
      Q3_CHECK_LAUNCH();
    }

    if (p >= 1) {  // head p-1 predicts code p-1
      if ((e = gemv<T, W>(vec_input<T>(x, fnorm, a.eps), heads + (size_t)(p - 1) * H * V, H, V, part, st))) return e;
      const int nb = (V + 255) / 256;
      argmax_partial<T><<<nb, 256, 0, st>>>(part, H / kGemvRows, V, srow(a.heads_s, (size_t)(p - 1) * V), best_v,
                                            best_i);
      Q3_CHECK_LAUNCH();
      argmax_final<<<1, 1, 0, st>>>(best_v, best_i, nb, a.codes + (p - 1));
      Q3_CHECK_LAUNCH();
    }
  }
  return cudaSuccess;
}

static bool cp_dims_ok(const CpDims& d, int dtype, int int8) {
  const int cols = int8 ? gemv_cols<int8_t>() : dtype == 0 ? gemv_cols<float>() : gemv_cols<__nv_bfloat16>();
  const int ns[] = {d.nqkv(), d.hidden, 2 * d.inter, d.vocab};
  for (int n : ns)
    if (n % cols) return false;
  const int ks[] = {d.hidden, d.qdim(), d.inter, d.embed};
  for (int k : ks)
    if (k % kGemvRows) return false;
  // The mtp projection [E, H] keeps the working type in both modes.
  if (d.hidden % (dtype == 0 ? gemv_cols<float>() : gemv_cols<__nv_bfloat16>())) return false;
  return d.groups + 1 <= kCpMaxRows && d.head_dim % 64 == 0 && d.head_dim <= 256 && d.heads % d.kv_heads == 0 &&
         d.vocab <= 256 * 256 && d.layers > 0;
}

}  // namespace q3

extern "C" {

// Floats of f32 scratch one frame needs (0 when the shapes are unsupported).
size_t q3_cp_frame_scratch_floats(int dtype, int int8, int layers, int hidden, int heads, int kv_heads,
                                  int head_dim, int inter, int vocab, int embed, int groups) {
  const q3::CpDims d{layers, hidden, heads, kv_heads, head_dim, inter, vocab, embed, groups};
  return q3::cp_dims_ok(d, dtype, int8) ? q3::cp_layout(d).total : 0;
}

// All `groups` acoustic codes of one frame into `codes` (int32, on device).
// dtype 0 = f32, 1 = bf16 for activations, norms, embeddings and the mtp
// projection; int8 = 0: the layer projections and heads in that dtype too,
// and the five scale pointers null; int8 = 1: those weights int8 with f32
// per-column scales (qkv_s [L, (Hq+2KV)*D], o_s [L, H], gu_s [L, 2I],
// down_s [L, H], heads_s [G, V]). Weight layouts (fused, stacked over
// layers, [in, out]): qkv_w [L, H, (Hq+2KV)*D], o_w [L, Hq*D, H], gu_w
// [L, H, 2I], down_w [L, I, H]; input_ln/post_ln [L, H], q_norm/k_norm
// [L, D], final_norm [H], heads [G, H, V], etab [G, V, E], xs [2, E]
// (talker hidden, semantic embedding), mtp_w [E, H] and mtp_b [H] or both
// null; cos_t/sin_t [16, D/2] f32.
int q3_cp_frame(int dtype, int int8, const void* xs, const void* etab, const void* mtp_w, const void* mtp_b,
                const void* qkv_w, const void* o_w, const void* gu_w, const void* down_w, const float* qkv_s,
                const float* o_s, const float* gu_s, const float* down_s, const void* input_ln,
                const void* post_ln, const void* q_norm, const void* k_norm, const void* final_norm,
                const void* heads, const float* heads_s, const float* cos_t, const float* sin_t, int layers,
                int hidden, int n_heads, int kv_heads, int head_dim, int inter, int vocab, int embed, int groups,
                float eps, float* scratch, int* codes, void* stream) {
  const q3::CpDims d{layers, hidden, n_heads, kv_heads, head_dim, inter, vocab, embed, groups};
  if (!q3::cp_dims_ok(d, dtype, int8) || (!mtp_w && embed != hidden)) return (int)cudaErrorInvalidValue;
  if (int8 && !(qkv_s && o_s && gu_s && down_s && heads_s)) return (int)cudaErrorInvalidValue;
  if (!int8) qkv_s = o_s = gu_s = down_s = heads_s = nullptr;
  const q3::CpArgs a{xs,       etab,    mtp_w,  mtp_b,  qkv_w,      o_w,   gu_w,    down_w, qkv_s,
                     o_s,      gu_s,    down_s, input_ln, post_ln, q_norm, k_norm, final_norm, heads,
                     heads_s,  cos_t,   sin_t,  eps,    scratch,    codes};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (int8)
    e = dtype == 0 ? q3::run_frame<float, int8_t>(d, a, st) : q3::run_frame<__nv_bfloat16, int8_t>(d, a, st);
  else
    e = dtype == 0 ? q3::run_frame<float, float>(d, a, st) : q3::run_frame<__nv_bfloat16, __nv_bfloat16>(d, a, st);
  return (int)e;
}

}  // extern "C"
