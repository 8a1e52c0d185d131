// Kernel 7 of the port: one code-predictor decode step through all layers
// on int8 weights, batch 1.
//
// Replaces the TPU kernel qwen3_tts_tpu/ops/fused_layer.py:
// _streamed_step_kernel (entry streamed_decode_step): the step's input
// through every layer (kernels 5 + 6 of fused_step.cu, per layer), returning
// the last layer's output (the final norm and lm head stay outside, as in
// the JAX package). It serves the code predictors the whole-frame kernel
// does not take (more than 15 acoustic groups, or an odd vocab) whose fused
// dims are multiples of the hidden size.
//
// Its own rounding points, those of the JAX whole-step kernel, where they
// differ from kernels 5 + 6: cos/sin rounded to bf16 even when the working
// type is f32; o and down summed over H-wide K chunks in ascending order
// before the scale (the TPU kernel's [H, H] weight tiles); the attention
// output rounded to bf16 (the same value as kernel 5's round-to-T-then-bf16
// for T = f32 or bf16).
//
// What bounds it on an H100: bytes. At the 1.7B code predictor a step reads
// 5 layers x 15.73 MB of int8 weights (78.6 MB, ~23.5 us at 3.35 TB/s) and
// the live rows of the 17-row cache; in this first version, the 52
// dependent launches of a step.
//
// Design: one C entry point per step runs decode_layer.cuh's attention and
// MLP sequences for each layer on the caller's stream, on the canonical
// fused [L, K, N] int8 tree with [L, N] scales (no second copy of the stack
// in the TPU's [L, T, H, H] tile layout). The residual stream lives in the
// output buffer y (T-rounded values), updated in place layer after layer;
// row `pos` of each layer's [S, KV*D] cache plane is written in place before
// that layer's attention reads the rows <= pos.

#include "decode_layer.cuh"

namespace q3 {

struct CpStepArgs {
  const void* x;
  const int8_t *qkv_w, *o_w, *gu_w, *down_w;
  const float *qkv_s, *o_s, *gu_s, *down_s;
  const void *input_ln, *post_ln, *q_norm, *k_norm;
  const float *cos_t, *sin_t;
  void *ck, *cv;
  int pos;
  float eps;
  float* scratch;
  void* y;
};

template <typename T>
static cudaError_t run_cp_step(const LayerDims& d, int layers, const CpStepArgs& a, cudaStream_t st) {
  const int H = d.hidden, D = d.head_dim, I = d.inter, S = d.max_seq;
  const size_t nqkv = d.nqkv(), qd = d.qdim(), kvd = d.kvdim();
  const int per = H / kGemvRows;  // K splits per H-wide chunk of the o / down sums
  auto at = [](const void* p, size_t off) { return static_cast<const T*>(p) + off; };
  cudaError_t e;
  if ((e = cudaMemcpyAsync(a.y, a.x, (size_t)H * sizeof(T), cudaMemcpyDeviceToDevice, st))) return e;
  for (int l = 0; l < layers; ++l) {
    T* ckl = static_cast<T*>(a.ck) + (size_t)l * S * kvd;
    T* cvl = static_cast<T*>(a.cv) + (size_t)l * S * kvd;
    const AttnArgs attn{a.y,
                        at(a.input_ln, (size_t)l * H),
                        a.qkv_w + (size_t)l * H * nqkv,
                        a.qkv_s + (size_t)l * nqkv,
                        at(a.q_norm, (size_t)l * D),
                        at(a.k_norm, (size_t)l * D),
                        a.cos_t,
                        a.sin_t,
                        a.o_w + (size_t)l * qd * H,
                        a.o_s + (size_t)l * H,
                        ckl,
                        cvl,
                        a.pos,
                        a.eps,
                        1,
                        a.y};
    if ((e = attention_sublayer<T, __nv_bfloat16>(d, attn, per, a.scratch, st))) return e;
    const MlpArgs mlp{a.y,
                      at(a.post_ln, (size_t)l * H),
                      a.gu_w + (size_t)l * H * 2 * I,
                      a.gu_s + (size_t)l * 2 * I,
                      a.down_w + (size_t)l * I * H,
                      a.down_s + (size_t)l * H,
                      a.eps,
                      1,
                      a.y};
    if ((e = mlp_sublayer<T>(d, mlp, per, a.scratch, st))) return e;
  }
  return cudaSuccess;
}

}  // namespace q3

extern "C" {

// One code-predictor decode step: y [H] <- the last layer's output for
// input x [H], and row `pos` of every layer of ck, cv [L, S, KV*D] written
// in place. dtype 0 = f32, 1 = bf16 for x, y, the norms and the caches.
// Int8 weights (fused, stacked over layers, [in, out]) with f32 per-column
// scales: qkv_w [L, H, (Hq+2KV)*D] / qkv_s [L, (Hq+2KV)*D], o_w [L, Hq*D, H]
// / o_s [L, H], gu_w [L, H, 2I] / gu_s [L, 2I], down_w [L, I, H] / down_s
// [L, H]; input_ln/post_ln [L, H], q_norm/k_norm [L, D]; cos_t/sin_t [>=
// pos+1, D/2] f32. Scratch: q3_decode_layer_scratch_floats(dtype, H, Hq,
// KV, D, I, S) floats.
int q3_cp_step(int dtype, const void* x, const int8_t* qkv_w, const float* qkv_s, const int8_t* o_w,
               const float* o_s, const int8_t* gu_w, const float* gu_s, const int8_t* down_w, const float* down_s,
               const void* input_ln, const void* post_ln, const void* q_norm, const void* k_norm, const float* cos_t,
               const float* sin_t, void* ck, void* cv, int layers, int hidden, int heads, int kv_heads, int head_dim,
               int inter, int max_seq, int pos, float eps, float* scratch, void* y, void* stream) {
  const q3::LayerDims d{hidden, heads, kv_heads, head_dim, inter, max_seq};
  if (!(dtype == 0 || dtype == 1) || heads <= 0 || inter <= 0 || layers <= 0 || !q3::layer_dims_ok(d) || pos < 0 ||
      pos >= max_seq)
    return (int)cudaErrorInvalidValue;
  const q3::CpStepArgs a{x,        qkv_w,   o_w,    gu_w,   down_w, qkv_s, o_s, gu_s,    down_s, input_ln,
                         post_ln,  q_norm,  k_norm, cos_t,  sin_t,  ck,    cv,  pos,     eps,    scratch, y};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? q3::run_cp_step<float>(d, layers, a, st) : q3::run_cp_step<__nv_bfloat16>(d, layers, a, st);
  return (int)e;
}

}  // extern "C"
