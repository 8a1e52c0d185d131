"""The code-predictor frame: CUDA kernel wrapper, plain version, launch count.

``cp_frame`` computes all acoustic codes of one frame. On a CUDA tensor it
launches the hand-written Hopper kernel (``csrc/cp_frame.cu``, the port of
``qwen3_tts_tpu/ops/fused_layer.py:streamed_cp_frame``); on a CPU tensor it
runs ``cp_frame_plain``, the plain PyTorch version (the JAX package's
``predict_acoustic_codes``: a 2-row prefill, then 14 single-token steps,
each with the mtp projection and a greedy argmax). Any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import nn

# 2 prefill positions + 15 decode tokens; the last is never attended, as in
# the JAX package.
CP_MAX_SEQ = 17

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _mtp_project(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The small-to-mtp projection (embed_dim -> hidden), when the model has one."""
    proj = params.get("mtp_proj")
    if proj is None:
        return x
    return x @ proj["w"] + proj["b"]


def cp_frame_plain(params: dict, cfg, talker_hidden: torch.Tensor, semantic_embed: torch.Tensor) -> torch.Tensor:
    """All ``cfg.num_acoustic`` codes of one frame, in plain PyTorch.

    talker_hidden, semantic_embed: [1, 1, embed_dim]. Returns int32 [G].
    Group g embeds code g-1 with table g-1 and predicts with head g.
    """
    stack_cfg = cfg.layer_stack()
    dev = talker_hidden.device
    cache = nn.init_kv_cache(stack_cfg, 1, CP_MAX_SEQ, talker_hidden.dtype, dev)
    heads = params["lm_heads"]

    x = _mtp_project(params, torch.cat([talker_hidden, semantic_embed], dim=1))
    h = nn.run_layer_stack(
        params["layers"], x, stack_cfg, cache, torch.arange(2, device=dev), 0,
        self_attn_prefill=True,
    )
    h = nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)
    code = torch.argmax(h[:, 1] @ heads[0], dim=-1)  # [1]
    codes = [code]
    for g in range(1, cfg.num_acoustic):
        pos = g + 1
        x = _mtp_project(params, params["codec_embeddings"][g - 1][code][None])
        h = nn.run_layer_stack(
            params["layers"], x, stack_cfg, cache, torch.full((1,), pos, device=dev), pos
        )
        h = nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)
        code = torch.argmax(h[:, 0] @ heads[g], dim=-1)
        codes.append(code)
    return torch.cat(codes).to(torch.int32)


def _check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"cp_frame: {name} must be a contiguous {dtype} tensor of shape {shape} on {device}; "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


_ROPE_TABLES: dict = {}


def _rope_tables(head_dim: int, theta: float, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [CP_MAX_SEQ - 1, head_dim/2] f32 for the frame's positions, made once per device."""
    key = (head_dim, theta, dev)
    if key not in _ROPE_TABLES:
        inv_freq = nn.rope_inv_freq(head_dim, theta, device=dev)
        cos_t, sin_t = nn.rope_cos_sin(torch.arange(CP_MAX_SEQ - 1, dtype=torch.float32, device=dev), inv_freq)
        _ROPE_TABLES[key] = (cos_t.contiguous(), sin_t.contiguous())
    return _ROPE_TABLES[key]


def _kernel_lib():
    from .. import build

    lib = build.load()
    if not getattr(lib, "_q3_cp_frame_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.q3_cp_frame_scratch_floats.restype = ctypes.c_size_t
        lib.q3_cp_frame_scratch_floats.argtypes = [i32] * 10
        lib.q3_cp_frame.restype = i32
        lib.q3_cp_frame.argtypes = (
            [i32] + [ptr] * 16 + [i32] * 9 + [ctypes.c_float, ptr, ptr, ptr]
        )
        lib._q3_cp_frame_bound = True
    return lib


def cp_frame(params: dict, cfg, talker_hidden: torch.Tensor, semantic_embed: torch.Tensor) -> torch.Tensor:
    """All acoustic codes of one frame: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor. Returns int32 [G] on the input's device.

    The kernel takes the fused stacked layer weights (``qkv_proj``,
    ``gateup_proj``; see ``models/weights.fuse_model_params``), all in the
    inputs' dtype (float32 or bfloat16).
    """
    dev = talker_hidden.device
    if dev.type == "cpu":
        return cp_frame_plain(params, cfg, talker_hidden, semantic_embed)
    if dev.type != "cuda":
        raise ValueError(f"cp_frame: no kernel for device {dev}")

    dtype = talker_hidden.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"cp_frame: unsupported dtype {dtype}")
    sc = cfg.layer_stack()
    L, H, D, I = sc.num_layers, sc.hidden_size, sc.head_dim, sc.intermediate_size
    qd, kvd = sc.num_heads * D, sc.num_kv_heads * D
    G, V, E = cfg.num_acoustic, cfg.vocab_size, cfg.embed_dim
    layers = params["layers"]
    if "qkv_proj" not in layers or "gateup_proj" not in layers:
        raise ValueError("cp_frame: the kernel needs fused qkv_proj / gateup_proj weights")
    expected = {
        "qkv_proj": (L, H, qd + 2 * kvd),
        "o_proj": (L, qd, H),
        "gateup_proj": (L, H, 2 * I),
        "down_proj": (L, I, H),
        "input_ln": (L, H),
        "post_ln": (L, H),
        "q_norm": (L, D),
        "k_norm": (L, D),
    }
    for name, shape in expected.items():
        _check(layers[name], name, shape, dtype, dev)
    _check(params["norm"], "norm", (H,), dtype, dev)
    _check(params["lm_heads"], "lm_heads", (G, H, V), dtype, dev)
    _check(params["codec_embeddings"], "codec_embeddings", (G, V, E), dtype, dev)
    mtp = params.get("mtp_proj")
    if mtp is not None:
        _check(mtp["w"], "mtp_proj.w", (E, H), dtype, dev)
        _check(mtp["b"], "mtp_proj.b", (H,), dtype, dev)
    xs = torch.cat([talker_hidden, semantic_embed], dim=1).reshape(2, E).contiguous()
    _check(xs, "talker_hidden|semantic_embed", (2, E), dtype, dev)

    lib = _kernel_lib()
    n_scratch = lib.q3_cp_frame_scratch_floats(_DTYPES[dtype], L, H, sc.num_heads, sc.num_kv_heads, D, I, V, E, G)
    if n_scratch == 0:
        raise ValueError(f"cp_frame: the kernel does not take these shapes ({cfg})")
    cos_t, sin_t = _rope_tables(D, sc.rope_theta, dev)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    codes = torch.empty(G, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.q3_cp_frame(
        _DTYPES[dtype], xs.data_ptr(), params["codec_embeddings"].data_ptr(),
        mtp["w"].data_ptr() if mtp is not None else None,
        mtp["b"].data_ptr() if mtp is not None else None,
        layers["qkv_proj"].data_ptr(), layers["o_proj"].data_ptr(),
        layers["gateup_proj"].data_ptr(), layers["down_proj"].data_ptr(),
        layers["input_ln"].data_ptr(), layers["post_ln"].data_ptr(),
        layers["q_norm"].data_ptr(), layers["k_norm"].data_ptr(),
        params["norm"].data_ptr(), params["lm_heads"].data_ptr(),
        cos_t.data_ptr(), sin_t.data_ptr(),
        L, H, sc.num_heads, sc.num_kv_heads, D, I, V, E, G, sc.rms_norm_eps,
        scratch.data_ptr(), codes.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"cp_frame kernel launch failed: CUDA error {err}")
    cp_frame.launches += 1
    return codes


cp_frame.launches = 0  # frames the kernel ran (CPU-plain calls are not counted)
