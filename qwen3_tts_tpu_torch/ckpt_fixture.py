"""Seeded Qwen3-TTS checkpoints in the HF layout, for the loading path.

No published checkpoint is in the repository, so the loaders (the
safetensors reader, the key maps, the tokenizer, ``Qwen3TTS.from_pretrained``)
are held to the JAX package's on checkpoints written here:

* ``config_json(cfg)``: the HF ``config.json`` dict that
  ``models.config.parse_config_json`` reads back to ``cfg``;
* ``model_specs`` / ``speech_specs``: every tensor of ``model.safetensors``
  (talker, code predictor) and of the speech tokenizer's decoder, with its
  HF name, HF shape (linear ``[out, in]``, conv ``[Cout, Cin, K]``,
  transposed conv ``[Cin, Cout, K]``) and how it is drawn: uniform weights
  of standard deviation 0.02 in the talker and code predictor (the
  packages' random-init scale) and 1 / sqrt(fan-in) in the vocoder (so its
  activations keep their scale and the audio is not clipped), norms of
  1 +- 0.1, small nonzero biases, snake parameters, layer scales and
  codebook usages drawn around their init;
* ``seeded_weights(specs, seed)``: the tensors from numpy's
  ``default_rng(seed)``, one at a time, cast to the file's dtype;
  ``generated_weights(specs, gen)``: the same specs from a
  ``torch.Generator`` on its device (fast at full size on the card);
* ``write_safetensors(path, tensors)``: a safetensors file from torch
  tensors (so that it can hold bf16);
* ``write_checkpoint(dir, cfg, model, speech)``: the directory
  ``from_pretrained`` reads: both files, ``config.json``, a byte-level
  ``vocab.json`` + ``merges.txt`` (``MERGES``) with the three Qwen2
  special tokens in ``tokenizer_config.json``, and the vocoder sidecar when
  its config is not the default.

The text embedding has the published 151936 rows, because the prompt's
control tokens (``<|im_start|>`` 151644, ``tts_pad`` / ``tts_bos`` /
``tts_eos`` 151671-151673, ``assistant`` 77091) index rows that high; only
``TEXT_ROWS`` of them are drawn, and row r holds drawn row r mod
``TEXT_ROWS``, so a checkpoint's size is set by its depth and widths.

The 1.7B-width utterance (``utterance_config``; the JAX package's frames
and audio are the committed ``UTTERANCE_FIXTURE``): the 1.7B CustomVoice
widths (talker 2048 / 6144, 16 q / 8 KV heads of 128; code predictor 5
layers at 1024 / 3072; codec vocab 3072; the default full-width vocoder),
cut in two ways: talker depth 28 -> ``UTTERANCE_LAYERS`` (2), and
``TEXT_ROWS`` (4096) drawn text-embedding rows. Its weights are drawn from
``UTTERANCE_SEED``, stored bf16 (the vocoder f32).

    JAX_PLATFORMS=cpu python tests/test_torch_utterance_1p7b.py   # rewrites the utterance fixture

The batch on the same checkpoint (``BATCH_TEXTS``, ``BATCH_FRAMES`` forced,
the JAX package's ``synthesize_batch``): the committed ``BATCH_FIXTURE``.

    JAX_PLATFORMS=cpu python tests/test_torch_batch_1p7b.py   # rewrites the batch fixture
"""

from __future__ import annotations

import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from .models.codec.vocoder import VocoderConfig
from .models.config import ModelConfig, config_for_variant
from .models.weights import SAFETENSORS_DTYPES
from .tokenizer import bytes_to_unicode

TEXT_ROWS = 4096
UTTERANCE_SEED = 2026
UTTERANCE_LAYERS = 2
UTTERANCE_FRAMES = 24
UTTERANCE_TEXT = "The quick brown fox jumps over the lazy dog."
UTTERANCE_FIXTURE = Path(__file__).resolve().parent / "testdata" / "utterance_1p7b.npz"
# The batch on the same checkpoint: three texts of different lengths.
BATCH_TEXTS = ("The quick brown fox.", "A lazy dog sleeps near the river bank.", "Hello there.")
BATCH_FRAMES = 16
BATCH_FIXTURE = Path(__file__).resolve().parent / "testdata" / "batch_1p7b.npz"

# A few byte-level merges, so that the checkpoint's tokenizer runs BPE and
# not only the byte map ("Ġ" is the byte map's space).
MERGES = (("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("e", "r"), ("a", "n"), ("o", "u"), ("Ġ", "a"),
          ("r", "e"), ("o", "n"), ("Ġ", "s"), ("Ġ", "w"))
SPECIAL_TOKENS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")

# How a tensor is drawn: ("w", std) uniform of that standard deviation;
# ("near", centre, std) the same around a centre; ("rows", n, std) n drawn
# rows, repeated down the tensor.
_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}


def utterance_config() -> ModelConfig:
    """The 1.7B CustomVoice config with the talker cut to ``UTTERANCE_LAYERS``."""
    cfg = config_for_variant("1.7B", "custom_voice")
    return replace(cfg, talker=replace(cfg.talker, num_hidden_layers=UTTERANCE_LAYERS))


def config_json(cfg: ModelConfig) -> dict:
    """The HF ``config.json`` of ``cfg`` (``parse_config_json`` reads it back
    to ``cfg``; the text projection's width is the text embedding's, as in
    every published config)."""
    t, cp = cfg.talker, cfg.code_predictor
    if t.text_proj_intermediate != t.text_embed_dim:
        raise ValueError("config.json has one text width: text_proj_intermediate must equal text_embed_dim")
    out = {
        "tts_model_type": cfg.model_type.value,
        "tts_model_size": cfg.model_size,
        "talker_config": {
            "text_vocab_size": t.text_vocab_size,
            "text_hidden_size": t.text_embed_dim,
            "hidden_size": t.hidden_size,
            "intermediate_size": t.intermediate_size,
            "num_hidden_layers": t.num_hidden_layers,
            "num_attention_heads": t.num_attention_heads,
            "num_key_value_heads": t.num_key_value_heads,
            "head_dim": t.head_dim,
            "rms_norm_eps": t.rms_norm_eps,
            "rope_theta": t.rope_theta,
            "max_position_embeddings": t.max_position_embeddings,
            "vocab_size": t.codec_vocab_size,
            "code_predictor_config": {
                "hidden_size": cp.hidden_size,
                "intermediate_size": cp.intermediate_size,
                "num_hidden_layers": cp.num_hidden_layers,
                "num_attention_heads": cp.num_attention_heads,
                "num_key_value_heads": cp.num_key_value_heads,
                "head_dim": cp.head_dim,
                "rms_norm_eps": cp.rms_norm_eps,
                "rope_theta": cp.rope_theta,
                "vocab_size": cp.vocab_size,
                "num_code_groups": cp.num_code_groups,
            },
        },
    }
    if t.mrope_section is not None:
        out["talker_config"]["rope_scaling"] = {"mrope_section": list(t.mrope_section)}
    if cfg.speaker_encoder is not None:
        out["speaker_encoder_config"] = {"enc_dim": cfg.speaker_encoder.enc_dim,
                                         "sample_rate": cfg.speaker_encoder.sample_rate}
    return out


def _layer_specs(prefix: str, n: int, hidden: int, inter: int, heads: int, kv: int, d: int) -> list:
    w, norm = ("w", 0.02), ("near", 1.0, 0.1)
    out = []
    for i in range(n):
        p = f"{prefix}.{i}"
        out += [
            (f"{p}.self_attn.q_proj.weight", (heads * d, hidden), w),
            (f"{p}.self_attn.k_proj.weight", (kv * d, hidden), w),
            (f"{p}.self_attn.v_proj.weight", (kv * d, hidden), w),
            (f"{p}.self_attn.o_proj.weight", (hidden, heads * d), w),
            (f"{p}.self_attn.q_norm.weight", (d,), norm),
            (f"{p}.self_attn.k_norm.weight", (d,), norm),
            (f"{p}.input_layernorm.weight", (hidden,), norm),
            (f"{p}.post_attention_layernorm.weight", (hidden,), norm),
            (f"{p}.mlp.gate_proj.weight", (inter, hidden), w),
            (f"{p}.mlp.up_proj.weight", (inter, hidden), w),
            (f"{p}.mlp.down_proj.weight", (hidden, inter), w),
        ]
    return out


def model_specs(cfg: ModelConfig) -> list:
    """(name, HF shape, draw) of every tensor of ``model.safetensors``: the
    talker and the code predictor."""
    t, cp = cfg.talker, cfg.code_predictor
    w, bias, norm = ("w", 0.02), ("near", 0.0, 0.02), ("near", 1.0, 0.1)
    specs = [
        ("talker.model.text_embedding.weight", (t.text_vocab_size, t.text_embed_dim), ("rows", TEXT_ROWS, 0.02)),
        ("talker.text_projection.linear_fc1.weight", (t.text_proj_intermediate, t.text_embed_dim), w),
        ("talker.text_projection.linear_fc1.bias", (t.text_proj_intermediate,), bias),
        ("talker.text_projection.linear_fc2.weight", (t.hidden_size, t.text_proj_intermediate), w),
        ("talker.text_projection.linear_fc2.bias", (t.hidden_size,), bias),
        ("talker.model.codec_embedding.weight", (t.codec_vocab_size, t.hidden_size), w),
        ("talker.model.norm.weight", (t.hidden_size,), norm),
        ("talker.codec_head.weight", (t.codec_vocab_size, t.hidden_size), w),
    ]
    specs += _layer_specs("talker.model.layers", t.num_hidden_layers, t.hidden_size, t.intermediate_size,
                          t.num_attention_heads, t.num_key_value_heads, t.head_dim)
    p = "talker.code_predictor"
    for i in range(cp.num_acoustic):
        specs.append((f"{p}.model.codec_embedding.{i}.weight", (cp.vocab_size, cp.embed_dim), w))
    specs += _layer_specs(f"{p}.model.layers", cp.num_hidden_layers, cp.hidden_size, cp.intermediate_size,
                          cp.num_attention_heads, cp.num_key_value_heads, cp.head_dim)
    specs.append((f"{p}.model.norm.weight", (cp.hidden_size,), norm))
    for i in range(cp.num_acoustic):
        specs.append((f"{p}.lm_head.{i}.weight", (cp.vocab_size, cp.hidden_size), w))
    if cp.needs_projection:
        specs += [(f"{p}.small_to_mtp_projection.weight", (cp.hidden_size, cp.embed_dim), w),
                  (f"{p}.small_to_mtp_projection.bias", (cp.hidden_size,), bias)]
    return specs


def speech_specs(cfg: VocoderConfig = VocoderConfig()) -> list:
    """(name, HF shape, draw) of every tensor of the speech tokenizer's
    decoder (the vocoder), as ``vocoder.load_vocoder_params`` reads them."""

    def w(fan_in, gain=1.0):
        return ("w", gain / fan_in**0.5)

    bias, one = ("near", 0.0, 0.02), ("near", 1.0, 0.1)
    specs = []

    def conv(key, cin, cout, k, gain=1.0):
        specs.extend([(f"{key}.weight", (cout, cin, k), w(k * cin, gain)), (f"{key}.bias", (cout,), bias)])

    def tconv(key, cin, cout, k, stride):
        specs.extend([(f"{key}.weight", (cin, cout, k), w(cin * k // stride)), (f"{key}.bias", (cout,), bias)])

    ed, nq, q = cfg.codebook_embed_dim, cfg.num_quantizers, "decoder.quantizer"
    specs += [(f"{q}.rvq_first.vq.layers.0._codebook.embedding_sum", (cfg.codebook_size, ed), ("w", 1.0)),
              (f"{q}.rvq_first.vq.layers.0._codebook.cluster_usage", (cfg.codebook_size,), ("near", 1.0, 0.1))]
    for i in range(nq - 1):
        specs += [(f"{q}.rvq_rest.vq.layers.{i}._codebook.embedding_sum", (cfg.codebook_size, ed), ("w", 1.0)),
                  (f"{q}.rvq_rest.vq.layers.{i}._codebook.cluster_usage", (cfg.codebook_size,), ("near", 1.0, 0.1))]
    specs += [(f"{q}.rvq_first.output_proj.weight", (cfg.codebook_dim, ed, 1), w(ed)),
              (f"{q}.rvq_rest.output_proj.weight", (cfg.codebook_dim, ed, 1), w(ed * (nq - 1)))]
    conv("decoder.pre_conv.conv", cfg.codebook_dim, cfg.latent_dim, 3)
    hs, hd, inter, pt = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.intermediate_size, "decoder.pre_transformer"
    specs += [(f"{pt}.input_proj.weight", (hs, cfg.latent_dim), w(cfg.latent_dim)),
              (f"{pt}.input_proj.bias", (hs,), bias),
              (f"{pt}.output_proj.weight", (cfg.latent_dim, hs), w(hs)),
              (f"{pt}.output_proj.bias", (cfg.latent_dim,), bias),
              (f"{pt}.norm.weight", (hs,), one)]
    for i in range(cfg.num_layers):
        p = f"{pt}.layers.{i}"
        specs += [(f"{p}.input_layernorm.weight", (hs,), one),
                  (f"{p}.self_attn.q_proj.weight", (hd, hs), w(hs)),
                  (f"{p}.self_attn.k_proj.weight", (hd, hs), w(hs)),
                  (f"{p}.self_attn.v_proj.weight", (hd, hs), w(hs)),
                  (f"{p}.self_attn.o_proj.weight", (hs, hd), w(hd)),
                  (f"{p}.self_attn_layer_scale.scale", (hs,), ("near", 0.1, 0.02)),
                  (f"{p}.post_attention_layernorm.weight", (hs,), one),
                  (f"{p}.mlp.gate_proj.weight", (inter, hs), w(hs)),
                  (f"{p}.mlp.up_proj.weight", (inter, hs), w(hs)),
                  (f"{p}.mlp.down_proj.weight", (hs, inter), w(inter)),
                  (f"{p}.mlp_layer_scale.scale", (hs,), ("near", 0.1, 0.02))]
    lat = cfg.latent_dim
    for i, r in enumerate(cfg.upsampling_ratios):
        p = f"decoder.upsample.{i}"
        tconv(f"{p}.0.conv", lat, lat, 2 * r, r)
        specs += [(f"{p}.1.dwconv.conv.weight", (lat, 1, 7), w(7)), (f"{p}.1.dwconv.conv.bias", (lat,), bias),
                  (f"{p}.1.norm.weight", (lat,), one), (f"{p}.1.norm.bias", (lat,), bias),
                  (f"{p}.1.pwconv1.weight", (4 * lat, lat), w(lat)), (f"{p}.1.pwconv1.bias", (4 * lat,), bias),
                  (f"{p}.1.pwconv2.weight", (lat, 4 * lat), w(4 * lat)), (f"{p}.1.pwconv2.bias", (lat,), bias),
                  (f"{p}.1.gamma", (lat,), ("near", 0.1, 0.02))]
    conv("decoder.decoder.0.conv", lat, cfg.decoder_dim, 7)
    ch, snake = cfg.decoder_dim, ("near", 0.0, 0.1)
    for i, r in enumerate(cfg.upsample_rates):
        bp, out = f"decoder.decoder.{i + 1}.block", ch // 2
        specs += [(f"{bp}.0.alpha", (ch,), snake), (f"{bp}.0.beta", (ch,), snake)]
        tconv(f"{bp}.1.conv", ch, out, 2 * r, r)
        for u in (2, 3, 4):
            up = f"{bp}.{u}"
            specs += [(f"{up}.act1.alpha", (out,), snake), (f"{up}.act1.beta", (out,), snake)]
            conv(f"{up}.conv1.conv", out, out, 7, 0.5)
            specs += [(f"{up}.act2.alpha", (out,), snake), (f"{up}.act2.beta", (out,), snake)]
            conv(f"{up}.conv2.conv", out, out, 1, 0.5)
        ch = out
    specs += [("decoder.decoder.5.alpha", (ch,), snake), ("decoder.decoder.5.beta", (ch,), snake)]
    conv("decoder.decoder.6.conv", ch, 1, cfg.final_kernel, 0.05)
    return specs


def _scale(u, kind):
    """Uniform draws ``u`` in [0, 1) -> the values of ``kind``."""
    centre, std = (0.0, kind[1]) if kind[0] == "w" else (kind[1], kind[2])
    return (u * 2 - 1) * (std * 3**0.5) + centre


def seeded_weights(specs: list, seed: int, dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """The tensors of ``specs`` from numpy's ``default_rng(seed)`` (f32
    draws, one tensor at a time), cast to ``dtype`` on the CPU."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, kind in specs:
        if kind[0] == "rows":
            table = _scale(rng.random((kind[1],) + tuple(shape[1:]), dtype=np.float32), ("w", kind[2]))
            out[name] = torch.from_numpy(table).to(dtype)[torch.arange(shape[0]) % kind[1]]
        else:
            out[name] = torch.from_numpy(_scale(rng.random(shape, dtype=np.float32), kind)).to(dtype)
    return out


def generated_weights(specs: list, gen: torch.Generator,
                      dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """The tensors of ``specs`` from ``gen`` on its device (f32 draws, cast
    to ``dtype``): the same distributions as ``seeded_weights``, not the
    same values."""
    dev, out = gen.device, {}
    for name, shape, kind in specs:
        if kind[0] == "rows":
            u = torch.rand((kind[1],) + tuple(shape[1:]), generator=gen, device=dev)
            out[name] = _scale(u, ("w", kind[2])).to(dtype)[torch.arange(shape[0], device=dev) % kind[1]]
        else:
            out[name] = _scale(torch.rand(shape, generator=gen, device=dev), kind).to(dtype)
    return out


def write_safetensors(path: str | Path, tensors: dict[str, torch.Tensor]) -> int:
    """Write ``tensors`` (any device) as a safetensors file, in their order;
    returns the bytes written. The header is padded with spaces to 8 bytes."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(blob) + offset


def byte_level_vocab(merges=MERGES) -> dict[str, int]:
    """The 256 byte tokens (in byte order), then one token per merge."""
    vocab = {c: i for i, c in enumerate(bytes_to_unicode()[b] for b in range(256))}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    return vocab


def write_tokenizer(out: Path, merges=MERGES) -> None:
    """``vocab.json``, ``merges.txt`` and ``tokenizer_config.json`` (the
    three Qwen2 special tokens, ids past the vocabulary)."""
    vocab = byte_level_vocab(merges)
    (out / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False), encoding="utf-8")
    (out / "merges.txt").write_text("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges), encoding="utf-8")
    added = {str(len(vocab) + i): {"content": tok, "lstrip": False, "normalized": False, "rstrip": False,
                                   "single_word": False, "special": True} for i, tok in enumerate(SPECIAL_TOKENS)}
    (out / "tokenizer_config.json").write_text(json.dumps({"added_tokens_decoder": added}), encoding="utf-8")


def write_checkpoint(out: str | Path, cfg: ModelConfig, model: dict, speech: dict,
                     vocoder_config: VocoderConfig = VocoderConfig()) -> int:
    """The directory ``Qwen3TTS.from_pretrained`` reads: ``model.safetensors``
    (``model``: HF name -> tensor), ``speech_tokenizer/model.safetensors``
    (``speech``), ``config.json`` (``config_json(cfg)``), the tokenizer
    files, and ``vocoder_config.json`` when ``vocoder_config`` is not the
    default. Returns the bytes of the two weight files."""
    out = Path(out)
    (out / "speech_tokenizer").mkdir(parents=True, exist_ok=True)
    n = write_safetensors(out / "model.safetensors", model)
    n += write_safetensors(out / "speech_tokenizer" / "model.safetensors", speech)
    (out / "config.json").write_text(json.dumps(config_json(cfg), indent=2))
    write_tokenizer(out)
    if vocoder_config != VocoderConfig():
        fields = {k: list(v) if isinstance(v, tuple) else v for k, v in vars(vocoder_config).items()}
        (out / "vocoder_config.json").write_text(json.dumps(fields, indent=2))
    return n


def write_utterance_checkpoint(out: str | Path) -> ModelConfig:
    """The 1.7B-width utterance's checkpoint (bf16 model, f32 vocoder) in
    ``out``; returns its config."""
    cfg = utterance_config()
    write_checkpoint(out, cfg, seeded_weights(model_specs(cfg), UTTERANCE_SEED),
                     seeded_weights(speech_specs(), UTTERANCE_SEED + 1, torch.float32))
    return cfg


def load_utterance() -> dict:
    """The committed fixture: ``frames_greedy`` / ``frames_pcg`` [24, 16]
    int32 and ``audio_greedy`` / ``audio_pcg`` f32 (the JAX package's
    ``synthesize_with_timing``), and the least top-2 margins of the
    talker's and the code predictor's argmaxes in the greedy run
    (``talker_margin``, ``cp_margin``)."""
    with np.load(UTTERANCE_FIXTURE) as z:
        return {k: z[k] for k in z.files}


def load_batch() -> dict:
    """The committed batch fixture: ``frames_greedy`` / ``frames_pcg`` [B,
    BATCH_FRAMES, 16] int32 and ``audio_greedy`` / ``audio_pcg`` [B,
    BATCH_FRAMES * 1920] f32 (the JAX package's ``synthesize_batch`` of
    ``BATCH_TEXTS``, seeds 42, 43, 44), and the least top-2 margins of the
    talker's and the code predictor's argmaxes in the greedy run
    (``talker_margin``, ``cp_margin``)."""
    with np.load(BATCH_FIXTURE) as z:
        return {k: z[k] for k in z.files}
