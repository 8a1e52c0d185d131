"""Parameter trees: the safetensors reader and the HF key maps, random init,
q|k|v and gate|up fusion, numpy import.

The trees have the JAX package's layout (``qwen3_tts_tpu/models/weights.py``):
plain dicts of tensors, linear weights stored ``[in, out]`` so the hot path is
``x @ w``, embeddings ``[vocab, dim]``, per-layer tensors stacked along a
leading layer axis. ``from_numpy_tree`` takes a JAX model's trees (converted
to numpy) so both packages compute the same thing in the tests;
``speaker_encoder_from_numpy`` and ``mimi_encoder_from_numpy`` do the same
for the two encoders, whose convolution kernels they turn into
``F.conv1d``'s layout.

``load_safetensors`` reads a safetensors file with no package but torch
(numpy has no bf16), and ``load_talker_params`` /
``load_code_predictor_params`` map the HF checkpoint's names (``talker.*``,
``talker.code_predictor.*``) to those trees, as the JAX package's loaders do:
HF linear weights ``[out, in]`` become ``[in, out]``, per-layer tensors are
stacked, float tensors are cast to the compute dtype (round to nearest even,
as JAX casts).

Random init uses an explicit ``torch.Generator``; it does not reproduce the
JAX package's ``jax.random`` draws.
"""

from __future__ import annotations

import json
import math
import mmap
from pathlib import Path

import numpy as np
import torch

from ..utils.device import device_or_card
from .config import CodePredictorConfig, TalkerConfig

# safetensors dtype names -> torch dtypes: the ones a checkpoint can hold.
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "F64": torch.float64,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I16": torch.int16,
    "I32": torch.int32,
    "I64": torch.int64,
    "BOOL": torch.bool,
}


def _header_entries(path, header: dict, data_bytes: int) -> list:
    """Checked (name, dtype, shape, begin, end) of every tensor of a
    safetensors header, in file order; ``begin``/``end`` count from the end
    of the header."""
    entries = []
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if not isinstance(info, dict) or not {"dtype", "shape", "data_offsets"} <= info.keys():
            raise ValueError(f"{path}: {name}: malformed header entry {info!r}")
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name}: unsupported dtype {info['dtype']!r}")
        shape, offsets = info["shape"], info["data_offsets"]
        if not isinstance(shape, list) or not all(type(d) is int and d >= 0 for d in shape):
            raise ValueError(f"{path}: {name}: bad shape {shape!r}")
        if (not isinstance(offsets, list) or len(offsets) != 2
                or not all(type(o) is int for o in offsets) or not 0 <= offsets[0] <= offsets[1]):
            raise ValueError(f"{path}: {name}: bad data_offsets {offsets!r}")
        begin, end = offsets
        if end > data_bytes:
            raise ValueError(f"{path}: {name}: data_offsets {offsets} run past the file ({data_bytes} data bytes)")
        if end - begin != math.prod(shape) * dtype.itemsize:
            raise ValueError(f"{path}: {name}: {end - begin} bytes for shape {shape} of {info['dtype']}")
        entries.append((name, dtype, shape, begin, end))
    entries.sort(key=lambda e: (e[3], e[4]))
    for prev, cur in zip(entries, entries[1:]):
        if cur[3] < prev[4]:
            raise ValueError(f"{path}: tensors {prev[0]} and {cur[0]} overlap")
    return entries


def load_safetensors(path: str | Path, device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
    """A safetensors file -> {name: tensor} on ``device`` (default: the CUDA
    card; raises without one).

    The file is an 8-byte little-endian header length, a JSON header of
    ``{name: {dtype, shape, data_offsets}}`` (``__metadata__`` skipped), then
    the raw bytes, offsets counted from the end of the header. The file is
    mapped (copy-on-write) and each tensor viewed in place with
    ``torch.frombuffer``, so the bytes are copied once, to the device; on
    the CPU the tensors share the mapping. Raises ``ValueError`` on a dtype
    outside ``SAFETENSORS_DTYPES``, offsets that overlap or run past the
    file, or a byte count that does not match the shape.
    """
    device = device_or_card(device)
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors file")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    n = int.from_bytes(mm[:8], "little")
    if n > size - 8:
        raise ValueError(f"{path}: header length {n} runs past the file ({size} bytes)")
    try:
        header = json.loads(mm[8:8 + n])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    base = 8 + n
    out = {}
    for name, dtype, shape, begin, end in _header_entries(path, header, size - base):
        if begin == end:
            t = torch.empty(shape, dtype=dtype)
        elif (base + begin) % dtype.itemsize == 0:
            t = torch.frombuffer(mm, dtype=dtype, count=math.prod(shape), offset=base + begin).reshape(shape)
        else:  # an unaligned tensor: copy its bytes out
            t = torch.frombuffer(bytearray(mm[base + begin:base + end]), dtype=dtype).reshape(shape)
        out[name] = t.to(device)
    return out


def _t(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An HF linear weight [out, in] -> [in, out] in ``dtype``."""
    return w.to(dtype).t().contiguous()


def _stack_layer_params(weights: dict, prefix: str, num_layers: int, dtype: torch.dtype) -> dict:
    """Stack per-layer tensors: '{prefix}.{i}.self_attn.q_proj.weight' etc."""

    def stack(sub: str, transpose: bool) -> torch.Tensor:
        mats = [weights[f"{prefix}.{i}.{sub}"].to(dtype) for i in range(num_layers)]
        return torch.stack([m.t() for m in mats] if transpose else mats)

    return {
        "q_proj": stack("self_attn.q_proj.weight", True),
        "k_proj": stack("self_attn.k_proj.weight", True),
        "v_proj": stack("self_attn.v_proj.weight", True),
        "o_proj": stack("self_attn.o_proj.weight", True),
        "q_norm": stack("self_attn.q_norm.weight", False),
        "k_norm": stack("self_attn.k_norm.weight", False),
        "input_ln": stack("input_layernorm.weight", False),
        "post_ln": stack("post_attention_layernorm.weight", False),
        "gate_proj": stack("mlp.gate_proj.weight", True),
        "up_proj": stack("mlp.up_proj.weight", True),
        "down_proj": stack("mlp.down_proj.weight", True),
    }


def load_talker_params(weights: dict, cfg: TalkerConfig, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The talker's tree from an HF checkpoint's ``talker.*`` tensors."""
    return {
        "text_embedding": weights["talker.model.text_embedding.weight"].to(dtype),
        "text_projection": {
            "fc1_w": _t(weights["talker.text_projection.linear_fc1.weight"], dtype),
            "fc1_b": weights["talker.text_projection.linear_fc1.bias"].to(dtype),
            "fc2_w": _t(weights["talker.text_projection.linear_fc2.weight"], dtype),
            "fc2_b": weights["talker.text_projection.linear_fc2.bias"].to(dtype),
        },
        "codec_embedding": weights["talker.model.codec_embedding.weight"].to(dtype),
        "layers": _stack_layer_params(weights, "talker.model.layers", cfg.num_hidden_layers, dtype),
        "norm": weights["talker.model.norm.weight"].to(dtype),
        "codec_head": _t(weights["talker.codec_head.weight"], dtype),
    }


def load_code_predictor_params(weights: dict, cfg: CodePredictorConfig, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The code predictor's tree from an HF checkpoint's
    ``talker.code_predictor.*`` tensors (``mtp_proj`` None when the code
    predictor is as wide as the talker, as at 0.6B)."""
    p = "talker.code_predictor"
    n = cfg.num_acoustic
    params: dict = {
        "codec_embeddings": torch.stack(
            [weights[f"{p}.model.codec_embedding.{i}.weight"].to(dtype) for i in range(n)]),
        "layers": _stack_layer_params(weights, f"{p}.model.layers", cfg.num_hidden_layers, dtype),
        "norm": weights[f"{p}.model.norm.weight"].to(dtype),
        "lm_heads": torch.stack([weights[f"{p}.lm_head.{i}.weight"].to(dtype).t() for i in range(n)]),
        "mtp_proj": None,
    }
    if cfg.needs_projection:
        params["mtp_proj"] = {
            "w": _t(weights[f"{p}.small_to_mtp_projection.weight"], dtype),
            "b": weights[f"{p}.small_to_mtp_projection.bias"].to(dtype),
        }
    return params


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
