"""Seeded random weights at a configuration's published widths, drawn on the card.

A frozen copy of the scales of ``qwen3_tts_tpu_torch/models/weights.py``
(``init_talker_params``, ``init_code_predictor_params``) and
``qwen3_tts_tpu_torch/models/codec/vocoder.py`` (``init_vocoder_params``): normal
draws of standard deviation 0.02 (the codebooks 1.0), norms at 1, biases at 0,
layer scales at 0.01, SnakeBeta parameters at 0. Each leaf is one draw over all
its layers, made in float32 on the generator's device and cast to the served
type, so the same seed gives the same weights on every run. The trees are the
raw, unfused layout the program's ``Qwen3TTS`` takes and fuses itself, and the
reference reads.

A Base model's two audio encoders (``draw_encoders``) come from a generator
of their own, so the three trees of every configuration are the same with or
without them. They are flat trees named as the published checkpoints name
them (``speaker_encoder.*``, and the speech tokenizer's ``encoder.*``), in
float32: convolution and linear weights normal of standard deviation
1 / sqrt(fan-in) (so a clip's level carries through both stacks), biases 0,
norms 1, layer scales as configured, codebooks normal of standard deviation
1 / sqrt(their width) (unit-norm codewords) with every usage 1.
"""

from __future__ import annotations

import torch

from .spec import downsample_stride

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The encoders' generator is seeded with seed * ENCODER_SEED_MIX + 1 (mod 2**63).
ENCODER_SEED_MIX = 0x9E3779B97F4A7C15


def _draw(gen: torch.Generator, shape, dtype: torch.dtype, scale: float = 0.02) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(dtype)


def _ones(shape, dtype, dev) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=dev)


def _zeros(shape, dtype, dev) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=dev)


def layer_stack(gen: torch.Generator, c: dict, dtype: torch.dtype) -> dict:
    """A decoder stack's weights, stacked over its layers, ``[L, in, out]``."""
    n, h, inter = c["num_hidden_layers"], c["hidden_size"], c["intermediate_size"]
    q, kv, d, dev = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"], c["head_dim"], gen.device
    return {
        "q_proj": _draw(gen, (n, h, q), dtype),
        "k_proj": _draw(gen, (n, h, kv), dtype),
        "v_proj": _draw(gen, (n, h, kv), dtype),
        "o_proj": _draw(gen, (n, q, h), dtype),
        "q_norm": _ones((n, d), dtype, dev),
        "k_norm": _ones((n, d), dtype, dev),
        "input_ln": _ones((n, h), dtype, dev),
        "post_ln": _ones((n, h), dtype, dev),
        "gate_proj": _draw(gen, (n, h, inter), dtype),
        "up_proj": _draw(gen, (n, h, inter), dtype),
        "down_proj": _draw(gen, (n, inter, h), dtype),
    }


def talker(gen: torch.Generator, t: dict, dtype: torch.dtype) -> dict:
    dev, h, e = gen.device, t["hidden_size"], t["text_hidden_size"]
    return {
        "text_embedding": _draw(gen, (t["text_vocab_size"], e), dtype),
        "text_projection": {
            "fc1_w": _draw(gen, (e, e), dtype),
            "fc1_b": _zeros((e,), dtype, dev),
            "fc2_w": _draw(gen, (e, h), dtype),
            "fc2_b": _zeros((h,), dtype, dev),
        },
        "codec_embedding": _draw(gen, (t["vocab_size"], h), dtype),
        "layers": layer_stack(gen, t, dtype),
        "norm": _ones((h,), dtype, dev),
        "codec_head": _draw(gen, (h, t["vocab_size"]), dtype),
    }


def code_predictor(gen: torch.Generator, c: dict, embed_dim: int, dtype: torch.dtype) -> dict:
    """``embed_dim`` is the talker's hidden size: where it differs from the
    predictor's, the small-to-mtp projection bridges them."""
    dev, h, v, g = gen.device, c["hidden_size"], c["vocab_size"], c["num_code_groups"] - 1
    tree = {
        "codec_embeddings": _draw(gen, (g, v, embed_dim), dtype),
        "layers": layer_stack(gen, c, dtype),
        "norm": _ones((h,), dtype, dev),
        "lm_heads": _draw(gen, (g, h, v), dtype),
        "mtp_proj": None,
    }
    if embed_dim != h:
        tree["mtp_proj"] = {"w": _draw(gen, (embed_dim, h), dtype), "b": _zeros((h,), dtype, dev)}
    return tree


def vocoder(gen: torch.Generator, v: dict) -> dict:
    """The 12 Hz decoder's weights, float32."""
    dev, f = gen.device, torch.float32

    def conv(cin, cout, k):
        return _draw(gen, (k, cin, cout), f), _zeros((cout,), f, dev)

    def tconv(cin, cout, k):
        return _draw(gen, (k, cout, cin), f), _zeros((cout,), f, dev)

    def convnext(dim):
        return {
            "dwconv_w": _draw(gen, (7, 1, dim), f), "dwconv_b": _zeros((dim,), f, dev),
            "norm_w": _ones((dim,), f, dev), "norm_b": _zeros((dim,), f, dev),
            "pwconv1_w": _draw(gen, (dim, 4 * dim), f), "pwconv1_b": _zeros((4 * dim,), f, dev),
            "pwconv2_w": _draw(gen, (4 * dim, dim), f), "pwconv2_b": _zeros((dim,), f, dev),
            "gamma": _ones((dim,), f, dev),
        }

    def res_unit(dim):
        c1w, c1b = conv(dim, dim, 7)
        c2w, c2b = conv(dim, dim, 1)
        return {"act1_alpha": _zeros((dim,), f, dev), "act1_beta": _zeros((dim,), f, dev),
                "conv1_w": c1w, "conv1_b": c1b,
                "act2_alpha": _zeros((dim,), f, dev), "act2_beta": _zeros((dim,), f, dev),
                "conv2_w": c2w, "conv2_b": c2b}

    hs, hd, inter, nl = v["hidden_size"], v["num_heads"] * v["head_dim"], v["intermediate_size"], v["num_layers"]
    layers = {
        "input_ln": _ones((nl, hs), f, dev),
        "q_proj": _draw(gen, (nl, hs, hd), f),
        "k_proj": _draw(gen, (nl, hs, hd), f),
        "v_proj": _draw(gen, (nl, hs, hd), f),
        "o_proj": _draw(gen, (nl, hd, hs), f),
        "attn_scale": torch.full((nl, hs), 0.01, device=dev),
        "post_ln": _ones((nl, hs), f, dev),
        "gate_proj": _draw(gen, (nl, hs, inter), f),
        "up_proj": _draw(gen, (nl, hs, inter), f),
        "down_proj": _draw(gen, (nl, inter, hs), f),
        "mlp_scale": torch.full((nl, hs), 0.01, device=dev),
    }
    latent, cb = v["latent_dim"], v["codebook_dim"]
    pre_w, pre_b = conv(cb, latent, 3)
    init_w, init_b = conv(latent, v["decoder_dim"], 7)
    upsample = []
    for r in v["upsampling_ratios"]:
        uw, ub = tconv(latent, latent, 2 * r)
        upsample.append({"up_w": uw, "up_b": ub, "convnext": convnext(latent)})
    blocks, ch = [], v["decoder_dim"]
    for r in v["upsample_rates"]:
        out = ch // 2
        uw, ub = tconv(ch, out, 2 * r)
        blocks.append({"snake_alpha": _zeros((ch,), f, dev), "snake_beta": _zeros((ch,), f, dev),
                       "up_w": uw, "up_b": ub, "res1": res_unit(out), "res2": res_unit(out), "res3": res_unit(out)})
        ch = out
    fw, fb = conv(ch, 1, v["final_kernel"])
    ed = v["codebook_embed_dim"]
    return {
        "first_codebook": _draw(gen, (v["codebook_size"], ed), f, 1.0),
        "rest_codebooks": _draw(gen, (v["num_quantizers"] - 1, v["codebook_size"], ed), f, 1.0),
        "first_output_proj": _draw(gen, (ed, cb), f),
        "rest_output_proj": _draw(gen, (ed, cb), f),
        "pre_conv_w": pre_w, "pre_conv_b": pre_b,
        "input_proj_w": _draw(gen, (latent, hs), f), "input_proj_b": _zeros((hs,), f, dev),
        "layers": layers,
        "final_norm": _ones((hs,), f, dev),
        "output_proj_w": _draw(gen, (hs, latent), f), "output_proj_b": _zeros((latent,), f, dev),
        "upsample": upsample,
        "init_conv_w": init_w, "init_conv_b": init_b,
        "decoder_blocks": blocks,
        "final_snake_alpha": _zeros((ch,), f, dev), "final_snake_beta": _zeros((ch,), f, dev),
        "final_conv_w": fw, "final_conv_b": fb,
    }


def draw(dims: dict, seed: int, device) -> tuple[dict, dict, dict]:
    """(talker, code predictor, vocoder) trees of a configuration from ``seed``
    on ``device``: the talker and code predictor in the configuration's type,
    the vocoder in float32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    dtype = DTYPES[dims["dtype"]]
    t = talker(gen, dims["talker"], dtype)
    c = code_predictor(gen, dims["code_predictor"], dims["talker"]["hidden_size"], dtype)
    return t, c, vocoder(gen, dims["vocoder"])


def speaker_encoder(gen: torch.Generator, s: dict) -> dict:
    """The ECAPA-TDNN speaker encoder's tensors, ``speaker_encoder.*``."""
    dev, f, ch, ks = gen.device, torch.float32, s["enc_channels"], s["enc_kernel_sizes"]
    tree = {}

    def conv(key, cin, cout, k, conv_key=True):
        name = f"speaker_encoder.{key}.conv" if conv_key else f"speaker_encoder.{key}"
        tree[f"{name}.weight"] = _draw(gen, (cout, cin, k), f, (cin * k) ** -0.5)
        tree[f"{name}.bias"] = _zeros((cout,), f, dev)

    conv("blocks.0", s["mel_dim"], ch[0], ks[0])
    part = ch[1] // s["enc_res2net_scale"]
    for i in range(1, 4):
        conv(f"blocks.{i}.tdnn1", ch[i - 1], ch[i], 1)
        for j in range(s["enc_res2net_scale"] - 1):
            conv(f"blocks.{i}.res2net_block.blocks.{j}", part, part, ks[i])
        conv(f"blocks.{i}.tdnn2", ch[i], ch[i], 1)
        conv(f"blocks.{i}.se_block.conv1", ch[i], s["enc_se_channels"], 1, conv_key=False)
        conv(f"blocks.{i}.se_block.conv2", s["enc_se_channels"], ch[i], 1, conv_key=False)
    conv("mfa", sum(ch[1:4]), ch[4], ks[4])
    conv("asp.tdnn", 3 * ch[4], s["enc_attention_channels"], 1)
    conv("asp.conv", s["enc_attention_channels"], ch[4], 1, conv_key=False)
    conv("fc", 2 * ch[4], s["enc_dim"], 1, conv_key=False)
    return tree


def speech_encoder(gen: torch.Generator, e: dict) -> dict:
    """The 12 Hz speech encoder's tensors, ``encoder.*``: SEANet, the
    transformer, the downsampling convolution and the two residual
    quantisers."""
    dev, f = gen.device, torch.float32
    tree = {}

    def conv(key, cin, cout, k, bias=True):
        tree[f"encoder.{key}.weight"] = _draw(gen, (cout, cin, k), f, (cin * k) ** -0.5)
        if bias:
            tree[f"encoder.{key}.bias"] = _zeros((cout,), f, dev)

    ch = e["num_filters"]
    conv("encoder.layers.0.conv", 1, ch, e["kernel_size"])
    for i, ratio in enumerate(reversed(e["upsampling_ratios"])):
        conv(f"encoder.layers.{3 * i + 1}.block.1.conv", ch, ch // e["compress"], e["residual_kernel_size"])
        conv(f"encoder.layers.{3 * i + 1}.block.3.conv", ch // e["compress"], ch, 1)
        conv(f"encoder.layers.{3 * i + 3}.conv", ch, 2 * ch, 2 * ratio)
        ch *= 2
    h, hd, inter = e["hidden_size"], e["num_attention_heads"] * e["head_dim"], e["intermediate_size"]
    conv(f"encoder.layers.{3 * len(e['upsampling_ratios']) + 2}.conv", ch, h, e["last_kernel_size"])
    for i in range(e["num_hidden_layers"]):
        p = f"encoder.encoder_transformer.layers.{i}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            tree[f"{p}.{norm}.weight"], tree[f"{p}.{norm}.bias"] = _ones((h,), f, dev), _zeros((h,), f, dev)
        for name, (cin, cout) in (("q_proj", (h, hd)), ("k_proj", (h, hd)), ("v_proj", (h, hd)), ("o_proj", (hd, h))):
            tree[f"{p}.self_attn.{name}.weight"] = _draw(gen, (cout, cin), f, cin ** -0.5)
        tree[f"{p}.mlp.fc1.weight"] = _draw(gen, (inter, h), f, h ** -0.5)
        tree[f"{p}.mlp.fc2.weight"] = _draw(gen, (h, inter), f, inter ** -0.5)
        for scale in ("self_attn_layer_scale", "mlp_layer_scale"):
            tree[f"{p}.{scale}.scale"] = torch.full((h,), e["layer_scale_initial_scale"], device=dev)
    conv("downsample.conv", h, h, 2 * downsample_stride(e), bias=False)
    dim, size = e["codebook_dim"], e["codebook_size"]
    for name, n in (("semantic", e["num_semantic_quantizers"]),
                    ("acoustic", e["num_quantizers"] - e["num_semantic_quantizers"])):
        p = f"encoder.quantizer.{name}_residual_vector_quantizer"
        tree[f"{p}.input_proj.weight"] = _draw(gen, (dim, h, 1), f, h ** -0.5)
        for j in range(n):
            tree[f"{p}.layers.{j}.codebook.embed_sum"] = _draw(gen, (size, dim), f, dim ** -0.5)
            tree[f"{p}.layers.{j}.codebook.cluster_usage"] = _ones((size,), f, dev)
    return tree


def draw_encoders(dims: dict, seed: int, device) -> dict:
    """The audio encoders that the configuration declares, from ``seed`` on
    ``device``, by a generator of their own: {"speaker_encoder": tree,
    "speech_encoder": tree}, either absent; {} for a model with none."""
    if not (dims.get("speaker_encoder") or dims.get("speech_encoder")):
        return {}
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * ENCODER_SEED_MIX + 1) % 2**63)
    out = {}
    if dims.get("speaker_encoder"):
        out["speaker_encoder"] = speaker_encoder(gen, dims["speaker_encoder"])
    if dims.get("speech_encoder"):
        out["speech_encoder"] = speech_encoder(gen, dims["speech_encoder"])
    return out
