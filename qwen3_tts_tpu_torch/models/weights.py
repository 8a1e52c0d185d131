"""Parameter trees: random init, q|k|v and gate|up fusion, numpy import.

The trees have the JAX package's layout (``qwen3_tts_tpu/models/weights.py``):
plain dicts of tensors, linear weights stored ``[in, out]`` so the hot path is
``x @ w``, embeddings ``[vocab, dim]``, per-layer tensors stacked along a
leading layer axis. ``from_numpy_tree`` takes a JAX model's trees (converted
to numpy) so both packages compute the same thing in the tests;
``speaker_encoder_from_numpy`` and ``mimi_encoder_from_numpy`` do the same
for the two encoders, whose convolution kernels they turn into
``F.conv1d``'s layout.

Random init uses an explicit ``torch.Generator``; it does not reproduce the
JAX package's ``jax.random`` draws. The HF safetensors key maps come later.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CodePredictorConfig, TalkerConfig


def fuse_layer_params(stacked: dict) -> dict:
    """Concatenate q|k|v and gate|up projections (last axis, in that order).

    One ``[hidden, (H+2KV)*D]`` matmul replaces three per attention block and
    one ``[hidden, 2*inter]`` replaces two per MLP. The code-predictor frame
    kernel takes this fused layout.
    """
    fused = dict(stacked)
    fused["qkv_proj"] = torch.cat(
        [stacked["q_proj"], stacked["k_proj"], stacked["v_proj"]], dim=-1
    )
    fused["gateup_proj"] = torch.cat([stacked["gate_proj"], stacked["up_proj"]], dim=-1)
    for key in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
        del fused[key]
    return fused


def fuse_model_params(params: dict) -> dict:
    """Apply fuse_layer_params to a talker/code-predictor param tree."""
    out = dict(params)
    out["layers"] = fuse_layer_params(params["layers"])
    return out


def _to_tensor(leaf, device, dtype):
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16: widen exactly first
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_numpy_tree(tree, device: torch.device | str, dtype: torch.dtype | None = None):
    """A JAX parameter tree (numpy leaves) -> the same tree of tensors.

    Dicts, lists and tuples keep their structure; a ``None`` leaf (e.g.
    ``mtp_proj`` on the 0.6B code predictor) stays ``None``. Float leaves are
    cast to ``dtype`` when it is given, except inside a quantized linear
    (``{"q8", "scale"}``), whose int8 weights and f32 scales are kept.
    """
    if tree is None:
        return None
    if isinstance(tree, dict) and "q8" in tree:
        return {k: _to_tensor(v, device, None) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device, dtype) for v in tree)
    return _to_tensor(tree, device, dtype)


def _conv_from_numpy(w, device) -> torch.Tensor:
    """A JAX conv kernel [K, Cin, Cout] -> ``F.conv1d``'s [Cout, Cin, K], f32."""
    return _to_tensor(w, device, torch.float32).permute(2, 1, 0).contiguous()


def speaker_encoder_from_numpy(tree: dict, device: torch.device | str) -> dict:
    """The JAX package's ECAPA tree (``SpeakerEncoder.params`` as numpy) ->
    the port's (``models/speaker.py``): f32, every TDNN kernel in
    ``F.conv1d``'s layout, the dense 1x1 layers as they are."""

    def tdnn(p):
        return {"w": _conv_from_numpy(p["w"], device), "b": _to_tensor(p["b"], device, torch.float32)}

    out = from_numpy_tree(tree, device, torch.float32)
    out["initial"], out["mfa"] = tdnn(tree["initial"]), tdnn(tree["mfa"])
    out["asp"]["tdnn"] = tdnn(tree["asp"]["tdnn"])
    for block, src in zip(out["se_res2net"], tree["se_res2net"]):
        block["tdnn1"], block["tdnn2"] = tdnn(src["tdnn1"]), tdnn(src["tdnn2"])
        block["res2net"] = [tdnn(p) for p in src["res2net"]]
    return out


def mimi_encoder_from_numpy(tree: dict, device: torch.device | str) -> dict:
    """The JAX package's Mimi encoder tree (``init_encoder_params`` /
    ``Encoder12Hz.params`` as numpy) -> the port's (``models/codec/
    encoder.py``): f32, the SEANet and downsample kernels in ``F.conv1d``'s
    layout (strides come from the config, so the stages' ``ratio`` goes)."""
    sn = tree["seanet"]

    def bias(b):
        return None if b is None else _to_tensor(b, device, torch.float32)

    stages = [{
        "resnet": {k: (_conv_from_numpy(v, device) if k.endswith("_w") else bias(v))
                   for k, v in st["resnet"].items()},
        "down_w": _conv_from_numpy(st["down_w"], device),
        "down_b": bias(st["down_b"]),
    } for st in sn["stages"]]
    return {
        "seanet": {
            "init_w": _conv_from_numpy(sn["init_w"], device), "init_b": bias(sn["init_b"]),
            "stages": stages,
            "final_w": _conv_from_numpy(sn["final_w"], device), "final_b": bias(sn["final_b"]),
        },
        "transformer": from_numpy_tree(tree["transformer"], device, torch.float32),
        "downsample_w": _conv_from_numpy(tree["downsample_w"], device),
        **{k: _to_tensor(tree[k], device, torch.float32)
           for k in ("semantic_proj", "semantic_codebooks", "acoustic_proj", "acoustic_codebooks")},
    }


# ---------------------------------------------------------------------------
# Random init (tests / synthetic benchmarking)
# ---------------------------------------------------------------------------


def _randn(gen: torch.Generator, shape, dtype, scale=0.02) -> torch.Tensor:
    """Normal(0, scale) drawn in float32 on the generator's device, then cast."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(dtype)


def init_layer_stack(gen, num_layers, hidden, inter, heads, kv_heads, head_dim, dtype):
    qdim, kvdim = heads * head_dim, kv_heads * head_dim
    dev = gen.device
    return {
        "q_proj": _randn(gen, (num_layers, hidden, qdim), dtype),
        "k_proj": _randn(gen, (num_layers, hidden, kvdim), dtype),
        "v_proj": _randn(gen, (num_layers, hidden, kvdim), dtype),
        "o_proj": _randn(gen, (num_layers, qdim, hidden), dtype),
        "q_norm": torch.ones((num_layers, head_dim), dtype=dtype, device=dev),
        "k_norm": torch.ones((num_layers, head_dim), dtype=dtype, device=dev),
        "input_ln": torch.ones((num_layers, hidden), dtype=dtype, device=dev),
        "post_ln": torch.ones((num_layers, hidden), dtype=dtype, device=dev),
        "gate_proj": _randn(gen, (num_layers, hidden, inter), dtype),
        "up_proj": _randn(gen, (num_layers, hidden, inter), dtype),
        "down_proj": _randn(gen, (num_layers, inter, hidden), dtype),
    }


def init_talker_params(gen: torch.Generator, cfg: TalkerConfig, dtype=torch.bfloat16) -> dict:
    dev = gen.device
    return {
        "text_embedding": _randn(gen, (cfg.text_vocab_size, cfg.text_embed_dim), dtype),
        "text_projection": {
            "fc1_w": _randn(gen, (cfg.text_embed_dim, cfg.text_proj_intermediate), dtype),
            "fc1_b": torch.zeros((cfg.text_proj_intermediate,), dtype=dtype, device=dev),
            "fc2_w": _randn(gen, (cfg.text_proj_intermediate, cfg.hidden_size), dtype),
            "fc2_b": torch.zeros((cfg.hidden_size,), dtype=dtype, device=dev),
        },
        "codec_embedding": _randn(gen, (cfg.codec_vocab_size, cfg.hidden_size), dtype),
        "layers": init_layer_stack(
            gen,
            cfg.num_hidden_layers,
            cfg.hidden_size,
            cfg.intermediate_size,
            cfg.num_attention_heads,
            cfg.num_key_value_heads,
            cfg.head_dim,
            dtype,
        ),
        "norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=dev),
        "codec_head": _randn(gen, (cfg.hidden_size, cfg.codec_vocab_size), dtype),
    }


def init_code_predictor_params(
    gen: torch.Generator, cfg: CodePredictorConfig, dtype=torch.bfloat16
) -> dict:
    dev = gen.device
    n = cfg.num_acoustic
    params: dict = {
        "codec_embeddings": _randn(gen, (n, cfg.vocab_size, cfg.embed_dim), dtype),
        "layers": init_layer_stack(
            gen,
            cfg.num_hidden_layers,
            cfg.hidden_size,
            cfg.intermediate_size,
            cfg.num_attention_heads,
            cfg.num_key_value_heads,
            cfg.head_dim,
            dtype,
        ),
        "norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=dev),
        "lm_heads": _randn(gen, (n, cfg.hidden_size, cfg.vocab_size), dtype),
        "mtp_proj": None,
    }
    if cfg.needs_projection:
        params["mtp_proj"] = {
            "w": _randn(gen, (cfg.embed_dim, cfg.hidden_size), dtype),
            "b": torch.zeros((cfg.hidden_size,), dtype=dtype, device=dev),
        }
    return params
