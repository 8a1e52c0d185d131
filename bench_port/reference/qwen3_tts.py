"""Plain float32 reference of a Qwen3-TTS model (CustomVoice, Base or VoiceDesign), for the benchmark's check.

The talker (28-layer Qwen3 decoder with per-head QK-norm, RoPE and grouped KV
heads, a SiLU text projection and a codec head), the code predictor (5 layers,
an optional 2048 -> 1024 projection, 15 codebook tables and 15 heads) and the
12 Hz vocoder (residual-VQ de-embedding, a causal pre-transformer, two
ConvNeXt upsamplers and four BigVGAN blocks), written from their equations in
plain PyTorch: every matmul and convolution in float32 with TF32 off, no cache,
no fused weights, no kernels. It imports nothing of the program under test.
A Base model's two audio encoders are in ``encoders.py`` beside it.

The inputs are the benchmark's raw weight trees (the layout the benchmark draws
them in: linear weights ``[in, out]`` stacked over layers, conv kernels
``[K, Cin/groups, Cout]``, transposed-conv kernels ``[K, Cout, Cin]``), the
request's prompt and the codes the program served. The four prompt layouts:
a preset speaker's (``custom_voice_prompt``), an x-vector clone's
(``xvector_prompt``), an in-context clone's (``icl_prompt``: the reference
clip's codes and transcript, overlaid on the text or after it) and a voice
description's (``design_prompt``). Every function is teacher-forced: it runs
once over the prompt and the served codes and returns the logits at every
position, so that a served code can be judged by how far its logit lies below
the reference's best, after the repetition penalty the request ran under
(``served_penalty``).

Departures from the published model, shared with the program under test: the
vocoder's pre-transformer attends causally over every earlier frame (the
published decoder limits it to a window); the three MRoPE streams of the
talker are equal for speech, so its RoPE is the standard one; an in-context
clone's layouts are the program's (its overlay puts the text over the
reference's codec rows from the first, its sequential form puts all the text
first), and a clone's reference codes are decoded ahead of its frames and
their samples cut.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Token ids of the Qwen3-TTS prompt (the published tokenizer's specials).
IM_START, ASSISTANT, NEWLINE = 151644, 77091, 198
TTS_PAD, TTS_BOS, TTS_EOS = 151671, 151672, 151673
CODEC_PAD, CODEC_BOS, CODEC_EOS = 2148, 2149, 2150
CODEC_THINK, CODEC_THINK_BOS, CODEC_THINK_EOS = 2154, 2156, 2157
# The codec head's last 1024 ids are control tokens that are never sampled,
# except EOS.
CONTROL_IDS = 1024
SAMPLES_PER_FRAME = 1920  # 24 kHz, 12.5 frames a second
# An in-context clone's repetition penalty is at least this, greedy or not.
ICL_MIN_REPETITION_PENALTY = 1.5


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def strict_f32() -> None:
    """Float32 products at full precision (TF32 off for matmuls and cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * f32(w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding of x [..., S, heads, D] at positions 0..S-1."""
    s, d = x.shape[-3], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, S, KV, D] (H a multiple of KV) -> [B, S, H * D]."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    weights = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, h * d)


def decoder_stack(layers: dict, x: torch.Tensor, dims: dict) -> torch.Tensor:
    """Pre-norm Qwen3 decoder layers over x [B, S, hidden] (causal, positions
    0..S-1); each layer's weights are widened to float32 as it runs."""
    heads, kv, d, eps = dims["num_attention_heads"], dims["num_key_value_heads"], dims["head_dim"], dims["rms_norm_eps"]
    b, s = x.shape[:2]
    for i in range(layers["q_proj"].shape[0]):
        w = {name: f32(t[i]) for name, t in layers.items()}
        h = rms_norm(x, w["input_ln"], eps)
        q = rms_norm((h @ w["q_proj"]).reshape(b, s, heads, d), w["q_norm"], eps)
        k = rms_norm((h @ w["k_proj"]).reshape(b, s, kv, d), w["k_norm"], eps)
        v = (h @ w["v_proj"]).reshape(b, s, kv, d)
        q, k = rope(q, dims["rope_theta"]), rope(k, dims["rope_theta"])
        x = x + causal_attention(q, k, v) @ w["o_proj"]
        h = rms_norm(x, w["post_ln"], eps)
        x = x + (F.silu(h @ w["gate_proj"]) * (h @ w["up_proj"])) @ w["down_proj"]
    return x


# ---------------------------------------------------------------------------
# Talker
# ---------------------------------------------------------------------------


def embed_text(talker: dict, ids: torch.Tensor) -> torch.Tensor:
    """Text ids -> projected embeddings [.., hidden]: fc1 -> SiLU -> fc2."""
    p = talker["text_projection"]
    e = f32(talker["text_embedding"][ids])
    return F.silu(e @ f32(p["fc1_w"]) + f32(p["fc1_b"])) @ f32(p["fc2_w"]) + f32(p["fc2_b"])


def embed_codec(talker: dict, ids: torch.Tensor) -> torch.Tensor:
    return f32(talker["codec_embedding"][ids])


def _ids(talker: dict, values) -> torch.Tensor:
    return torch.tensor(list(values), dtype=torch.long, device=talker["codec_embedding"].device)


def _role(talker: dict) -> torch.Tensor:
    """The assistant role's three rows."""
    return embed_text(talker, _ids(talker, [IM_START, ASSISTANT, NEWLINE]))


def _first_row(talker: dict, text_ids: list[int]) -> torch.Tensor:
    """The first text token over CODEC_BOS."""
    return embed_text(talker, _ids(talker, text_ids[:1])) + embed_codec(talker, _ids(talker, [CODEC_BOS]))


def custom_voice_prompt(talker: dict, text_ids: list[int], speaker_id: int, lang_id: int) -> torch.Tensor:
    """The 10 prompt rows of a CustomVoice request: the assistant role; six
    rows of text pads (then TTS_BOS) over the think, language and speaker
    codec tokens; the first text token over CODEC_BOS."""
    overlay = embed_text(talker, _ids(talker, [TTS_PAD] * 5 + [TTS_BOS])) + embed_codec(
        talker, _ids(talker, [CODEC_THINK, CODEC_THINK_BOS, lang_id, CODEC_THINK_EOS, speaker_id, CODEC_PAD]))
    return torch.cat([_role(talker), overlay, _first_row(talker, text_ids)])


def _xvector_rows(talker: dict, xvector: torch.Tensor, lang_id: int) -> torch.Tensor:
    """A clone's role and overlay rows [9, hidden]: as a preset speaker's,
    with the x-vector in the speaker token's place."""
    codec = torch.cat([embed_codec(talker, _ids(talker, [CODEC_THINK, CODEC_THINK_BOS, lang_id, CODEC_THINK_EOS])),
                       f32(xvector)[None], embed_codec(talker, _ids(talker, [CODEC_PAD]))])
    return torch.cat([_role(talker), embed_text(talker, _ids(talker, [TTS_PAD] * 5 + [TTS_BOS])) + codec])


def xvector_prompt(talker: dict, text_ids: list[int], xvector: torch.Tensor, lang_id: int) -> torch.Tensor:
    """The 10 prompt rows of an x-vector clone: the clone's 9 rows, then the
    first text token over CODEC_BOS."""
    return torch.cat([_xvector_rows(talker, xvector, lang_id), _first_row(talker, text_ids)])


def frame_embeddings(talker: dict, cp: dict, codes: torch.Tensor) -> torch.Tensor:
    """Frames [n, 16] -> [n, hidden]: the semantic code's codec embedding and
    the 15 acoustic codes' group embeddings, summed."""
    groups = torch.arange(codes.shape[1] - 1, device=codes.device)
    acoustic = f32(cp["codec_embeddings"][groups[None, :], codes[:, 1:]]).sum(dim=1)
    return embed_codec(talker, codes[:, 0]) + acoustic


def icl_prompt(talker: dict, cp: dict, text_ids: list[int], ref_text_ids: list[int], xvector: torch.Tensor,
               ref_codes: torch.Tensor, lang_id: int, sequential: bool) -> tuple[torch.Tensor, list[int]]:
    """An in-context clone's prompt rows and the text ids left for its
    frames. The text is the transcript, the target text and TTS_EOS; the
    codec rows are CODEC_BOS and the reference frames. After the clone's 9
    rows: overlaid, codec row i plus text token i (TTS_PAD past the text),
    and the text past the codec rows is left for the frames; sequential, the
    text rows over CODEC_PAD, then the codec rows over TTS_PAD, and nothing
    is left."""
    text = list(ref_text_ids) + list(text_ids) + [TTS_EOS]
    codec = torch.cat([embed_codec(talker, _ids(talker, [CODEC_BOS])), frame_embeddings(talker, cp, ref_codes.long())])
    n = codec.shape[0]
    if sequential:
        rows = torch.cat([embed_text(talker, _ids(talker, text)) + embed_codec(talker, _ids(talker, [CODEC_PAD])),
                          codec + embed_text(talker, _ids(talker, [TTS_PAD]))])
        left = []
    else:
        rows = codec + embed_text(talker, _ids(talker, (text + [TTS_PAD] * n)[:n]))
        left = text[n:]
    return torch.cat([_xvector_rows(talker, xvector, lang_id), rows]), left


def design_prompt(talker: dict, text_ids: list[int], instruct_ids: list[int], lang_id: int) -> torch.Tensor:
    """A voice description's prompt rows: the description's text rows (its
    ChatML user turn), the assistant role, five rows of text pads (then
    TTS_BOS) over the think, language and pad codec tokens, and the first
    text token over CODEC_BOS."""
    overlay = embed_text(talker, _ids(talker, [TTS_PAD] * 4 + [TTS_BOS])) + embed_codec(
        talker, _ids(talker, [CODEC_THINK, CODEC_THINK_BOS, lang_id, CODEC_THINK_EOS, CODEC_PAD]))
    return torch.cat([embed_text(talker, _ids(talker, instruct_ids)), _role(talker), overlay,
                      _first_row(talker, text_ids)])


def served_penalty(requested: float, icl: bool) -> float:
    """The repetition penalty a request runs under: an in-context clone's is
    at least ``ICL_MIN_REPETITION_PENALTY``."""
    return max(requested, ICL_MIN_REPETITION_PENALTY) if icl else requested


def trailing_text(text_ids: list[int]) -> list[int]:
    """The text ids left for the frames of a prompt that holds only the first
    text token: the rest, then TTS_EOS."""
    return list(text_ids[1:]) + [TTS_EOS]


def text_additions(talker: dict, trailing: list[int], frames: int) -> torch.Tensor:
    """The text row added to frame i's step input [frames, hidden]: the
    trailing text id i while there is one, then TTS_PAD."""
    seq = (list(trailing) + [TTS_PAD] * frames)[:frames]
    return embed_text(talker, torch.tensor(seq, dtype=torch.long, device=talker["codec_embedding"].device))


def step_inputs(talker: dict, cp: dict, trailing: list[int], codes: torch.Tensor) -> torch.Tensor:
    """Frame i's talker input [n, hidden]: its semantic code's embedding, the
    15 acoustic codes' group embeddings and its text row."""
    return frame_embeddings(talker, cp, codes) + text_additions(talker, trailing, codes.shape[0])


def penalised(logits: torch.Tensor, semantic: torch.Tensor, penalty: float) -> torch.Tensor:
    """The logits [n, vocab] that predict semantic codes 0..n-1 under the
    repetition penalty: at row i, each code served in frames 0..i-1 has a
    positive logit divided by ``penalty`` and another multiplied by it."""
    if penalty == 1.0:
        return logits
    seen = F.one_hot(semantic, logits.shape[-1]).cumsum(0) > 0
    seen = torch.cat([torch.zeros_like(seen[:1]), seen[:-1]])
    return torch.where(seen, torch.where(logits > 0, logits / penalty, logits * penalty), logits)


def talker_logits(talker: dict, dims: dict, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The talker over the rows [S, hidden]: (final-normed hidden [S, hidden],
    codec logits [S, vocab])."""
    h = rms_norm(decoder_stack(talker["layers"], rows[None], dims)[0], talker["norm"], dims["rms_norm_eps"])
    return h, h @ f32(talker["codec_head"])


# ---------------------------------------------------------------------------
# Code predictor
# ---------------------------------------------------------------------------


def code_predictor_logits(cp: dict, dims: dict, talker_hidden: torch.Tensor, semantic: torch.Tensor,
                          codes: torch.Tensor, block: int = 256) -> torch.Tensor:
    """The 15 acoustic codes' logits of n frames given the served ones
    [n, 15, vocab]: each frame's 16 rows are [talker hidden, semantic code's
    embedding, acoustic codes 1..14 embedded by their groups' tables],
    projected into the predictor's width where the model has a projection;
    row g + 1's final-normed hidden through head g predicts acoustic code g.
    Frames run ``block`` at a time."""
    n, g = codes.shape[0], codes.shape[1]
    groups = torch.arange(g - 1, device=codes.device)
    acoustic = f32(cp["codec_embeddings"][groups[None, :], codes[:, : g - 1]])  # [n, 14, dim]
    rows = torch.cat([f32(talker_hidden)[:, None], f32(semantic)[:, None], acoustic], dim=1)  # [n, 16, dim]
    if cp.get("mtp_proj") is not None:
        rows = rows @ f32(cp["mtp_proj"]["w"]) + f32(cp["mtp_proj"]["b"])
    out = torch.cat([decoder_stack(cp["layers"], rows[i: i + block], dims) for i in range(0, n, block)])
    h = rms_norm(out, cp["norm"], dims["rms_norm_eps"])[:, 1:]  # [n, 15, hidden]
    return torch.einsum("ngh,ghv->ngv", h, f32(cp["lm_heads"]))


# ---------------------------------------------------------------------------
# Vocoder
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None, dilation: int = 1,
                groups: int = 1) -> torch.Tensor:
    """Left-padded causal conv of x [C, T] with a kernel [K, Cin/groups, Cout]."""
    k = kernel.shape[0]
    w = f32(kernel).permute(2, 1, 0)  # [Cout, Cin/groups, K]
    b = None if bias is None else f32(bias)
    return F.conv1d(F.pad(x, (dilation * (k - 1), 0))[None], w, b, dilation=dilation, groups=groups)[0]


def causal_trans_conv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, stride: int) -> torch.Tensor:
    """Transposed conv of x [Cin, T] with a kernel [K, Cout, Cin], the first
    T * stride outputs kept (causal)."""
    t = x.shape[-1]
    y = F.conv_transpose1d(x[None], f32(kernel).permute(2, 1, 0), f32(bias), stride=stride)[0]
    return y[:, : t * stride]


def snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """SnakeBeta on x [C, T]: x + sin^2(e^alpha x) / (e^beta + 1e-9)."""
    a, b = torch.exp(f32(alpha))[:, None], torch.exp(f32(beta))[:, None]
    return x + torch.sin(a * x) ** 2 / (b + 1e-9)


def convnext(x: torch.Tensor, p: dict) -> torch.Tensor:
    h = causal_conv(x, p["dwconv_w"], p["dwconv_b"], groups=x.shape[0]).T  # [T, C]
    h = F.layer_norm(h, (h.shape[-1],), f32(p["norm_w"]), f32(p["norm_b"]), eps=1e-6)
    h = F.gelu(h @ f32(p["pwconv1_w"]) + f32(p["pwconv1_b"])) @ f32(p["pwconv2_w"]) + f32(p["pwconv2_b"])
    return x + (h * f32(p["gamma"])).T


def residual_unit(x: torch.Tensor, p: dict, dilation: int) -> torch.Tensor:
    h = causal_conv(snake(x, p["act1_alpha"], p["act1_beta"]), p["conv1_w"], p["conv1_b"], dilation)
    return x + causal_conv(snake(h, p["act2_alpha"], p["act2_beta"]), p["conv2_w"], p["conv2_b"])


def pre_transformer(layers: dict, x: torch.Tensor, dims: dict) -> torch.Tensor:
    """The vocoder's causal pre-transformer over x [T, hidden]: layer-scaled
    attention (no QK-norm) and SwiGLU."""
    heads, d, eps, theta = dims["num_heads"], dims["head_dim"], dims["rms_norm_eps"], dims["rope_theta"]
    t = x.shape[0]
    for i in range(layers["q_proj"].shape[0]):
        w = {name: f32(v[i]) for name, v in layers.items()}
        h = rms_norm(x, w["input_ln"], eps)
        q = rope((h @ w["q_proj"]).reshape(1, t, heads, d), theta)
        k = rope((h @ w["k_proj"]).reshape(1, t, heads, d), theta)
        v = (h @ w["v_proj"]).reshape(1, t, heads, d)
        x = x + (causal_attention(q, k, v)[0] @ w["o_proj"]) * w["attn_scale"]
        h = rms_norm(x, w["post_ln"], eps)
        x = x + ((F.silu(h @ w["gate_proj"]) * (h @ w["up_proj"])) @ w["down_proj"]) * w["mlp_scale"]
    return x


def vocoder_decode(voc: dict, dims: dict, codes: torch.Tensor) -> torch.Tensor:
    """Codes [n, 16] -> the waveform [n * 1920], clamped to [-1, 1]."""
    size = dims["codebook_size"]
    first = f32(voc["first_codebook"][codes[:, 0] % size]) @ f32(voc["first_output_proj"])
    groups = torch.arange(codes.shape[1] - 1, device=codes.device)
    rest = f32(voc["rest_codebooks"][groups[None, :], codes[:, 1:]]).sum(dim=1) @ f32(voc["rest_output_proj"])
    x = (first + rest).T  # [512, n]
    x = causal_conv(x, voc["pre_conv_w"], voc["pre_conv_b"]).T
    x = x @ f32(voc["input_proj_w"]) + f32(voc["input_proj_b"])
    x = rms_norm(pre_transformer(voc["layers"], x, dims), voc["final_norm"], dims["rms_norm_eps"])
    x = (x @ f32(voc["output_proj_w"]) + f32(voc["output_proj_b"])).T  # [1024, n]
    for stage, ratio in zip(voc["upsample"], dims["upsampling_ratios"]):
        x = convnext(causal_trans_conv(x, stage["up_w"], stage["up_b"], ratio), stage["convnext"])
    x = causal_conv(x, voc["init_conv_w"], voc["init_conv_b"])
    for block, rate in zip(voc["decoder_blocks"], dims["upsample_rates"]):
        x = causal_trans_conv(snake(x, block["snake_alpha"], block["snake_beta"]), block["up_w"], block["up_b"], rate)
        for key, dilation in (("res1", 1), ("res2", 3), ("res3", 9)):
            x = residual_unit(x, block[key], dilation)
    x = causal_conv(snake(x, voc["final_snake_alpha"], voc["final_snake_beta"]), voc["final_conv_w"],
                    voc["final_conv_b"])
    return torch.clamp(x[0], -1.0, 1.0)


# ---------------------------------------------------------------------------
# One served request, judged
# ---------------------------------------------------------------------------


def judge_request(talker: dict, cp: dict, voc: dict, dims: dict, prompt: torch.Tensor, trailing: list[int],
                  codes: torch.Tensor, audio: torch.Tensor | None = None, penalty: float = 1.0,
                  prefix: torch.Tensor | None = None) -> dict:
    """The reference's verdict on one greedy request's served codes [n, 16]
    (and, when given, its served audio [n * 1920]), after its prompt rows
    [P, hidden] and with ``trailing`` the text ids left for its frames.

    ``talker_gaps`` [n]: by how much each served semantic code's logit lies
    below the reference's best over the codes the sampler may pick (the codec
    ids below the control range; EOS is blocked while frames are forced),
    both after the repetition ``penalty`` (``penalised``), and
    ``penalty_moved`` [n], where the penalty moved the best; ``cp_gaps`` [n, 15]:
    the same for the acoustic codes (argmax over the whole codebook);
    ``audio_err``: the largest difference of the served samples from the
    reference's decode of the served codes, over the reference's largest
    sample; behind an in-context clone's reference codes ``prefix`` [m, 16],
    of the decode of [prefix || codes] with the prefix's m * 1920 samples
    cut."""
    t, c, v = dims["talker"], dims["code_predictor"], dims["vocoder"]
    codes = codes.long()
    n = codes.shape[0]
    rows = torch.cat([prompt, step_inputs(talker, cp, trailing, codes[: n - 1])])
    hidden, logits = talker_logits(talker, t, rows)
    at = prompt.shape[0] - 1
    # Position at + i predicts frame i's semantic code, and its hidden state
    # feeds frame i's code predictor.
    raw = logits[at: at + n, : t["vocab_size"] - CONTROL_IDS]
    sem = penalised(logits[at: at + n], codes[:, 0], penalty)[:, : t["vocab_size"] - CONTROL_IDS]
    talker_gaps = sem.max(dim=-1).values - sem.gather(1, codes[:, :1])[:, 0]
    cp_logits = code_predictor_logits(cp, c, hidden[at: at + n], embed_codec(talker, codes[:, 0]), codes[:, 1:])
    cp_gaps = cp_logits.max(dim=-1).values - cp_logits.gather(2, codes[:, 1:, None])[..., 0]
    out = {"talker_gaps": talker_gaps, "cp_gaps": cp_gaps, "penalty_moved": sem.argmax(-1) != raw.argmax(-1)}
    if audio is not None:
        if prefix is None:
            want = vocoder_decode(voc, v, codes)
        else:
            want = vocoder_decode(voc, v, torch.cat([prefix.long(), codes]))[prefix.shape[0] * SAMPLES_PER_FRAME:]
        out["audio_err"] = float((f32(audio) - want).abs().max() / want.abs().max().clamp(min=1e-30))
    return out
