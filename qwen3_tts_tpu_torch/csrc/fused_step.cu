// Kernels 5 and 6 of the port: one int8 attention sub-layer step and one
// int8 MLP sub-layer step of a decoder layer, batch 1.
//
// Replace the TPU kernels qwen3_tts_tpu/ops/fused_layer.py:
// _attention_step_kernel (entry fused_attention_step) and _mlp_step_kernel
// (entry fused_mlp_step): RMSNorm -> int8 qkv -> QK-norm -> RoPE -> cache
// append at row `pos` -> GQA over the rows <= pos -> int8 o -> (+x), and
// RMSNorm -> int8 gate|up -> SiLU*up -> int8 down -> (+x). residual = 0
// returns the bare o / down output: the tensor-parallel step adds the
// chips' partials before the residual.
//
// What bounds them on an H100: bytes. At the 1.7B code predictor's widths
// the attention step reads 6.29 MB of int8 weights (qkv [1024, 4096], o
// [2048, 1024]; ~1.9 us at 3.35 TB/s) and the MLP step 9.44 MB (gate|up
// [1024, 6144], down [3072, 1024]; ~2.8 us), with a few KB of activations
// and cache rows; one GEMV per projection at batch 1, so ~2 flops per
// weight byte. In this first version, the launches: 7 for the attention
// step, 3 for the MLP step, each a few microseconds.
//
// Design: a fixed sequence of simple kernels on the caller's stream
// (decode_layer.cuh), built from the split-K GEMV of the code-predictor
// frame (common.cuh): the int8 weights read one byte each in the canonical
// [K, N] layout, the per-column scale applied once to the finished column
// sum, RMSNorm and SiLU*up fused into the GEMV input staging, fixed-order
// partial sums (deterministic, no atomics). The cache is written in place
// at row `pos` (the TPU kernel rewrites the whole aliased cache, a Mosaic
// alignment artefact) and attention reads only the rows <= pos, in 64-row
// chunks with a fixed-order combine. The TPU kernel's VMEM residency of the
// weights does not carry over: each step streams them from device memory.

#include "decode_layer.cuh"

extern "C" {

// Floats of f32 scratch a decode-layer kernel needs (kernels 5 and 6):
// heads = 0 for the MLP step alone, inter = 0 for the attention step alone;
// 0 when the shapes are unsupported (int8 GEMV tiling: N a multiple of 256,
// K of 64; head_dim a multiple of 32, at most 256).
size_t q3_decode_layer_scratch_floats(int dtype, int hidden, int heads, int kv_heads, int head_dim, int inter,
                                      int max_seq) {
  const q3::LayerDims d{hidden, heads, kv_heads, head_dim, inter, max_seq};
  return (dtype == 0 || dtype == 1) && q3::layer_dims_ok(d) ? q3::layer_layout(d).total : 0;
}

// Kernel 5: y [H] <- x + o (residual) or o, and row `pos` of ck, cv [S,
// KV*D] written in place. dtype 0 = f32, 1 = bf16 for x, y, the norms and
// the caches. qkv_w [H, (Hq+2KV)*D] and o_w [Hq*D, H] int8 with f32
// per-column scales qkv_s, o_s; input_ln [H], q_norm/k_norm [D]; cos_t/sin_t
// [>= pos+1, D/2] f32.
int q3_attention_step(int dtype, const void* x, const void* input_ln, const int8_t* qkv_w, const float* qkv_s,
                      const void* q_norm, const void* k_norm, const float* cos_t, const float* sin_t,
                      const int8_t* o_w, const float* o_s, void* ck, void* cv, void* y, int hidden, int heads,
                      int kv_heads, int head_dim, int max_seq, int pos, float eps, int residual, float* scratch,
                      void* stream) {
  const q3::LayerDims d{hidden, heads, kv_heads, head_dim, 0, max_seq};
  if (!(dtype == 0 || dtype == 1) || heads <= 0 || !q3::layer_dims_ok(d) || pos < 0 || pos >= max_seq)
    return (int)cudaErrorInvalidValue;
  const q3::AttnArgs a{x, input_ln, qkv_w, qkv_s, q_norm, k_norm, cos_t, sin_t, o_w, o_s, ck, cv, pos, eps,
                       residual, y};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? q3::attention_sublayer<float>(d, a, scratch, st)
                                   : q3::attention_sublayer<__nv_bfloat16>(d, a, scratch, st);
  return (int)e;
}

// Kernel 6: y [H] <- x + down (residual) or down. gu_w [H, 2I] and down_w
// [I, H] int8 with f32 per-column scales; post_ln [H]; dtype as above.
int q3_mlp_step(int dtype, const void* x, const void* post_ln, const int8_t* gu_w, const float* gu_s,
                const int8_t* down_w, const float* down_s, int hidden, int inter, float eps, int residual,
                float* scratch, void* y, void* stream) {
  const q3::LayerDims d{hidden, 0, 0, 0, inter, 0};
  if (!(dtype == 0 || dtype == 1) || inter <= 0 || !q3::layer_dims_ok(d)) return (int)cudaErrorInvalidValue;
  const q3::MlpArgs a{x, post_ln, gu_w, gu_s, down_w, down_s, eps, residual, y};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? q3::mlp_sublayer<float>(d, a, scratch, st)
                                   : q3::mlp_sublayer<__nv_bfloat16>(d, a, scratch, st);
  return (int)e;
}

}  // extern "C"
