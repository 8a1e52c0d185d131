"""The whole-frame code predictor and the whole-step talker: CUDA kernel
wrappers, plain versions, launch counts.

``cp_frame`` computes all acoustic codes of one frame. On a CUDA tensor it
launches the hand-written Hopper kernel (``csrc/cp_frame.cu``, the port of
``qwen3_tts_tpu/ops/fused_layer.py:streamed_cp_frame``); on a CPU tensor it
runs ``cp_frame_plain``, the plain PyTorch version (the JAX package's
``predict_acoustic_codes``: a 2-row prefill, then 14 single-token steps,
each with the mtp projection and a greedy argmax). It takes plain (f32 or
bf16) and weight-only int8 code-predictor trees.

``talker_step`` runs one batch-1 decode step through every talker layer on
int8 weights (``csrc/talker_step.cu``, the port of
``streamed_talker_step``); its plain version is ``talker_step_plain``. Any
other device raises in both wrappers.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import nn, quant

# 2 prefill positions + 15 decode tokens; the last is never attended, as in
# the JAX package.
CP_MAX_SEQ = 17
# The JAX package's bound for the streamed talker step (fused_layer.py);
# every generation tier (2048 frames + prompt bucket + pad) fits.
TALKER_STREAM_MAX_SEQ = 2624

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PROJS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")


def _mtp_project(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The small-to-mtp projection (embed_dim -> hidden), when the model has one."""
    proj = params.get("mtp_proj")
    if proj is None:
        return x
    return x @ proj["w"] + proj["b"]


def _head(heads, g: int):
    """Head ``g`` of the stacked lm heads, plain [G, H, V] or quantized."""
    if quant.is_quantized(heads):
        return {"q8": heads["q8"][g], "scale": heads["scale"][g]}
    return heads[g]


def cp_frame_plain(params: dict, cfg, talker_hidden: torch.Tensor, semantic_embed: torch.Tensor) -> torch.Tensor:
    """All ``cfg.num_acoustic`` codes of one frame, in plain PyTorch.

    talker_hidden, semantic_embed: [1, 1, embed_dim]. Returns int32 [G].
    Group g embeds code g-1 with table g-1 and predicts with head g. Int8
    layers and heads go through ``quant.mm_plain`` on every device.
    """
    stack_cfg = cfg.layer_stack()
    dev = talker_hidden.device
    cache = nn.init_kv_cache(stack_cfg, 1, CP_MAX_SEQ, talker_hidden.dtype, dev)
    heads = params["lm_heads"]

    mm = quant.mm_plain
    x = _mtp_project(params, torch.cat([talker_hidden, semantic_embed], dim=1))
    h = nn.run_layer_stack(
        params["layers"], x, stack_cfg, cache, torch.arange(2, device=dev), 0, self_attn_prefill=True, matmul=mm
    )
    h = nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)
    code = torch.argmax(mm(h[:, 1], _head(heads, 0)), dim=-1)  # [1]
    codes = [code]
    for g in range(1, cfg.num_acoustic):
        pos = g + 1
        x = _mtp_project(params, params["codec_embeddings"][g - 1][code][None])
        h = nn.run_layer_stack(
            params["layers"], x, stack_cfg, cache, torch.full((1,), pos, device=dev), pos, matmul=mm
        )
        h = nn.rms_norm(h, params["norm"], cfg.rms_norm_eps)
        code = torch.argmax(mm(h[:, 0], _head(heads, g)), dim=-1)
        codes.append(code)
    return torch.cat(codes).to(torch.int32)


def _check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype, device: torch.device, op="cp_frame") -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{op}: {name} must be a contiguous {dtype} tensor of shape {shape} on {device}; "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _check_linear(w, name: str, shape: tuple, dtype, device, op: str) -> bool:
    """Check a plain (``dtype``) or int8 linear; returns whether it is int8."""
    if quant.is_quantized(w):
        _check(w["q8"], f"{name}.q8", shape, torch.int8, device, op)
        _check(w["scale"], f"{name}.scale", shape[:-2] + shape[-1:], torch.float32, device, op)
        return True
    _check(w, name, shape, dtype, device, op)
    return False


_ROPE_TABLES: dict = {}


def _rope_tables(head_dim: int, theta: float, rows: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [rows, head_dim/2] f32 for positions 0..rows-1, made once per device."""
    key = (head_dim, theta, rows, dev)
    if key not in _ROPE_TABLES:
        inv_freq = nn.rope_inv_freq(head_dim, theta, device=dev)
        cos_t, sin_t = nn.rope_cos_sin(torch.arange(rows, dtype=torch.float32, device=dev), inv_freq)
        _ROPE_TABLES[key] = (cos_t.contiguous(), sin_t.contiguous())
    return _ROPE_TABLES[key]


def _kernel_lib():
    from .. import build

    lib = build.load()
    if not getattr(lib, "_q3_fused_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.q3_cp_frame_scratch_floats.restype = ctypes.c_size_t
        lib.q3_cp_frame_scratch_floats.argtypes = [i32] * 11
        lib.q3_cp_frame.restype = i32
        lib.q3_cp_frame.argtypes = (
            [i32, i32] + [ptr] * 21 + [i32] * 9 + [ctypes.c_float, ptr, ptr, ptr]
        )
        lib.q3_talker_step_scratch_floats.restype = ctypes.c_size_t
        lib.q3_talker_step_scratch_floats.argtypes = [i32] * 8
        lib.q3_talker_step.restype = i32
        lib.q3_talker_step.argtypes = [i32] + [ptr] * 17 + [i32] * 8 + [ctypes.c_float, ptr, ptr, ptr]
        lib._q3_fused_bound = True
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def cp_frame(params: dict, cfg, talker_hidden: torch.Tensor, semantic_embed: torch.Tensor) -> torch.Tensor:
    """All acoustic codes of one frame: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor. Returns int32 [G] on the input's device.

    The kernel takes the fused stacked layer weights (``qkv_proj``,
    ``gateup_proj``; see ``models/weights.fuse_model_params``) in the
    inputs' dtype (float32 or bfloat16), or the int8 tree of
    ``quant.quantize_code_predictor_params`` (int8 layer projections and
    lm heads with f32 scales; everything else in the inputs' dtype).
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
    linears = {
        "qkv_proj": (L, H, qd + 2 * kvd),
        "o_proj": (L, qd, H),
        "gateup_proj": (L, H, 2 * I),
        "down_proj": (L, I, H),
    }
    int8 = {name: _check_linear(layers[name], name, shape, dtype, dev, "cp_frame") for name, shape in linears.items()}
    int8["lm_heads"] = _check_linear(params["lm_heads"], "lm_heads", (G, H, V), dtype, dev, "cp_frame")
    quantized = int8["qkv_proj"]
    if any(v != quantized for v in int8.values()):
        raise ValueError(f"cp_frame: layer projections and heads must be all int8 or all plain ({int8})")
    for name, shape in {"input_ln": (L, H), "post_ln": (L, H), "q_norm": (L, D), "k_norm": (L, D)}.items():
        _check(layers[name], name, shape, dtype, dev)
    _check(params["norm"], "norm", (H,), dtype, dev)
    _check(params["codec_embeddings"], "codec_embeddings", (G, V, E), dtype, dev)
    mtp = params.get("mtp_proj")
    if mtp is not None:
        _check(mtp["w"], "mtp_proj.w", (E, H), dtype, dev)
        _check(mtp["b"], "mtp_proj.b", (H,), dtype, dev)
    xs = torch.cat([talker_hidden, semantic_embed], dim=1).reshape(2, E).contiguous()
    _check(xs, "talker_hidden|semantic_embed", (2, E), dtype, dev)

    def w_and_s(w):
        return (w["q8"], w["scale"]) if quantized else (w, None)

    qkv_w, qkv_s = w_and_s(layers["qkv_proj"])
    o_w, o_s = w_and_s(layers["o_proj"])
    gu_w, gu_s = w_and_s(layers["gateup_proj"])
    down_w, down_s = w_and_s(layers["down_proj"])
    heads_w, heads_s = w_and_s(params["lm_heads"])

    lib = _kernel_lib()
    n_scratch = lib.q3_cp_frame_scratch_floats(
        _DTYPES[dtype], int(quantized), L, H, sc.num_heads, sc.num_kv_heads, D, I, V, E, G
    )
    if n_scratch == 0:
        raise ValueError(f"cp_frame: the kernel does not take these shapes ({cfg})")
    cos_t, sin_t = _rope_tables(D, sc.rope_theta, CP_MAX_SEQ - 1, dev)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    codes = torch.empty(G, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.q3_cp_frame(
        _DTYPES[dtype], int(quantized), xs.data_ptr(), params["codec_embeddings"].data_ptr(),
        _ptr(mtp["w"]) if mtp is not None else None,
        _ptr(mtp["b"]) if mtp is not None else None,
        qkv_w.data_ptr(), o_w.data_ptr(), gu_w.data_ptr(), down_w.data_ptr(),
        _ptr(qkv_s), _ptr(o_s), _ptr(gu_s), _ptr(down_s),
        layers["input_ln"].data_ptr(), layers["post_ln"].data_ptr(),
        layers["q_norm"].data_ptr(), layers["k_norm"].data_ptr(),
        params["norm"].data_ptr(), heads_w.data_ptr(), _ptr(heads_s),
        cos_t.data_ptr(), sin_t.data_ptr(),
        L, H, sc.num_heads, sc.num_kv_heads, D, I, V, E, G, sc.rms_norm_eps,
        scratch.data_ptr(), codes.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"cp_frame kernel launch failed: CUDA error {err}")
    cp_frame.launches += 1
    return codes


cp_frame.launches = 0  # frames the kernel ran (CPU-plain calls are not counted)


# ---------------------------------------------------------------------------
# The talker decode step on int8 weights
# ---------------------------------------------------------------------------


def stream_dims_ok(layers: dict, hidden: int) -> bool:
    """The JAX gate of ``make_stream_pack``: all four projections int8 and
    every fused dim a multiple of the hidden size."""
    if "qkv_proj" not in layers or not all(quant.is_quantized(layers.get(p)) for p in _PROJS):
        return False
    dims = (
        layers["qkv_proj"]["q8"].shape[-1],
        layers["o_proj"]["q8"].shape[-2],
        layers["gateup_proj"]["q8"].shape[-1],
        layers["down_proj"]["q8"].shape[-2],
    )
    return all(d % hidden == 0 for d in dims)


def _dequant_acc(x: torch.Tensor, w: dict, l: int, k0: int = 0, k1: int | None = None) -> torch.Tensor:
    """f32 sum of bf16(x) @ q8[l][k0:k1] (exact products), before the scale."""
    return x.to(torch.bfloat16).float() @ w["q8"][l, k0:k1].float()


def _k_chunked(x: torch.Tensor, w: dict, l: int, hidden: int) -> torch.Tensor:
    """round(sum over H-wide K chunks in ascending order * scale): o / down."""
    acc = None
    for k0 in range(0, x.shape[-1], hidden):
        part = _dequant_acc(x[:, k0 : k0 + hidden], w, l, k0, k0 + hidden)
        acc = part if acc is None else acc + part
    return acc * w["scale"][l]


def talker_step_plain(
    layers: dict, x: torch.Tensor, cfg, ck: torch.Tensor, cv: torch.Tensor, pos: int
) -> torch.Tensor:
    """One batch-1 decode step through every layer on int8 weights, plain.

    x: [1, 1, H] in the compute dtype T (f32 or bf16); ck, cv: [L, S, KV*D]
    caches in T, whose row ``pos`` of every layer is written in place.
    Returns the last layer's output [1, 1, H] (before the final norm).
    Rounding points (those of the JAX kernel): projection inputs bf16;
    qkv = round_T(acc * scale); QK-norm and RoPE in T; scores f32 with the
    softmax over rows <= pos, unnormalised weights rounded to T before the
    value sum; o and down summed over H-wide K chunks in ascending order,
    times the scale, rounded to T; gate|up rounded to T, SiLU in f32.
    One point differs at T = f32: the JAX kernel rounds q to bf16 for its
    scores, while this version (and the kernel) keep q in T, as the JAX
    package's layer scan does.
    """
    dt = x.dtype
    H, D = cfg.hidden_size, cfg.head_dim
    hq, kv = cfg.num_heads, cfg.num_kv_heads
    qd, kvd, inter = hq * D, kv * D, cfg.intermediate_size
    eps = cfg.rms_norm_eps
    inv_freq = nn.rope_inv_freq(D, cfg.rope_theta, device=x.device)
    cos, sin = nn.rope_cos_sin(torch.tensor([pos], dtype=torch.float32, device=x.device), inv_freq)
    scale = 1.0 / (D**0.5)
    h = x.reshape(1, H)
    for l in range(ck.shape[0]):
        normed = nn.rms_norm(h, layers["input_ln"][l], eps)
        w = layers["qkv_proj"]
        qkv = (_dequant_acc(normed, w, l) * w["scale"][l]).to(dt)
        q = nn.rms_norm(qkv[:, :qd].reshape(1, hq, D), layers["q_norm"][l], eps)
        k = nn.rms_norm(qkv[:, qd : qd + kvd].reshape(1, kv, D), layers["k_norm"][l], eps)
        q = nn.apply_rope(q, cos, sin)[0]  # [hq, D]
        k = nn.apply_rope(k, cos, sin)[0]
        ck[l, pos] = k.reshape(kvd)
        cv[l, pos] = qkv[0, qd + kvd :]

        keys = ck[l, : pos + 1].reshape(pos + 1, kv, D).float()
        vals = cv[l, : pos + 1].reshape(pos + 1, kv, D).float()
        qg = q.float().reshape(kv, hq // kv, D)
        s = torch.einsum("kgd,skd->kgs", qg, keys) * scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        pv = torch.einsum("kgs,skd->kgd", p.to(dt).float(), vals)
        attn = (pv / p.sum(dim=-1, keepdim=True)).reshape(1, qd)
        h = h + _k_chunked(attn, layers["o_proj"], l, H).to(dt)

        normed = nn.rms_norm(h, layers["post_ln"][l], eps)
        w = layers["gateup_proj"]
        gu = (_dequant_acc(normed, w, l) * w["scale"][l]).to(dt)
        act = F.silu(gu[:, :inter].float()).to(dt) * gu[:, inter:]
        h = h + _k_chunked(act, layers["down_proj"], l, H).to(dt)
    return h.reshape(1, 1, H)


def talker_step(layers: dict, x: torch.Tensor, cfg, ck: torch.Tensor, cv: torch.Tensor, pos: int) -> torch.Tensor:
    """One talker decode step: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor (arguments and result as ``talker_step_plain``).

    The kernel takes the canonical fused int8 tree (``[L, K, N]`` int8 with
    ``[L, N]`` f32 scales), norms and caches in x's dtype.
    """
    dev = x.device
    if dev.type == "cpu":
        return talker_step_plain(layers, x, cfg, ck, cv, pos)
    if dev.type != "cuda":
        raise ValueError(f"talker_step: no kernel for device {dev}")
    dtype = x.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"talker_step: unsupported dtype {dtype}")
    H, D, I = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    hq, kv = cfg.num_heads, cfg.num_kv_heads
    qd, kvd = hq * D, kv * D
    L, S = ck.shape[0], ck.shape[1]
    linears = {"qkv_proj": (L, H, qd + 2 * kvd), "o_proj": (L, qd, H), "gateup_proj": (L, H, 2 * I), "down_proj": (L, I, H)}
    for name, shape in linears.items():
        if not _check_linear(layers[name], name, shape, dtype, dev, "talker_step"):
            raise ValueError(f"talker_step: the kernel takes int8 weights only ({name} is plain)")
    for name, shape in {"input_ln": (L, H), "post_ln": (L, H), "q_norm": (L, D), "k_norm": (L, D)}.items():
        _check(layers[name], name, shape, dtype, dev, "talker_step")
    _check(ck, "cache k", (L, S, kvd), dtype, dev, "talker_step")
    _check(cv, "cache v", (L, S, kvd), dtype, dev, "talker_step")
    if not 0 <= pos < S:
        raise ValueError(f"talker_step: pos {pos} outside the {S}-row cache")
    xin = x.reshape(H).contiguous()
    _check(xin, "x", (H,), dtype, dev, "talker_step")

    lib = _kernel_lib()
    n_scratch = lib.q3_talker_step_scratch_floats(_DTYPES[dtype], L, H, hq, kv, D, I, S)
    if n_scratch == 0:
        raise ValueError(f"talker_step: the kernel does not take these shapes ({cfg}, S={S})")
    cos_t, sin_t = _rope_tables(D, cfg.rope_theta, S, dev)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    y = torch.empty(H, dtype=dtype, device=dev)
    err = lib.q3_talker_step(
        _DTYPES[dtype], xin.data_ptr(),
        *[t.data_ptr() for name in _PROJS for t in (layers[name]["q8"], layers[name]["scale"])],
        layers["input_ln"].data_ptr(), layers["post_ln"].data_ptr(),
        layers["q_norm"].data_ptr(), layers["k_norm"].data_ptr(),
        cos_t.data_ptr(), sin_t.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        L, H, hq, kv, D, I, S, pos, cfg.rms_norm_eps,
        scratch.data_ptr(), y.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"talker_step kernel launch failed: CUDA error {err}")
    talker_step.launches += 1
    return y.reshape(1, 1, H)


talker_step.launches = 0  # steps the kernel ran (CPU-plain calls are not counted)
