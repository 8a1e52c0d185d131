"""int8 quality guardrails: per-layer quantization SNR + talker-logit drift
(the JAX package's ``scripts/quant_report.py``).

When real weights land, run

    python -m qwen3_tts_tpu_torch.validation quant-report --model-dir CKPT [--out report.json]

(also part of ``parity``). Without a checkpoint it runs on synthetic
weights (``--variant``, ``tiny`` for a CI-sized config), so the machinery
itself is exercised.

Reported metrics
----------------
* per-projection weight SNR (dB), worst layer and median, for every
  quantized linear in the talker and code predictor;
* talker-logit divergence over a set of decode steps: KL(plain || int8)
  after softmax, plus the argmax flip rate;
* code-predictor code flip rate (acoustic codes are argmax-decoded, so
  flips here change audio directly);
* the same drift with w8a8 (``quant.w8a8_scope``): the int8 model on the
  layer paths of the batched loop (the only one that serves w8a8), where
  every int8 product quantizes its activations per row.

On the card the plain bf16 model takes kernels 1 and 3 on plain weights,
the int8 model kernels 1 and 3 in int8 and kernel 4 (its prefill and codec
head), w8a8 ``quant.w8a8_matmul`` for every product; each drift section
records the int8 run's kernel launches, and the report names the device
that produced it (the card's name and power limit).

Promote/demote criterion (applied by the report):
  PROMOTE int8 to default when   worst-layer SNR >= 30 dB
                             AND mean logit KL <= 5e-3
                             AND talker argmax flip rate <= 1%
                             AND CP code flip rate <= 1%.
  Otherwise int8 stays opt-in. Real-checkpoint logits are peaked (far from
  the near-uniform synthetic ones), so synthetic flip rates OVERSTATE
  drift; the criterion is meant for real weights.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from . import card_name, launch_counts, launches_since, tiny_config


def _snr_db(w: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> float:
    deq = q8.float() * scale.float()
    err = w.float() - deq
    p_sig = float((w.float() ** 2).mean())
    p_err = float((err**2).mean()) + 1e-30
    return 10.0 * np.log10(p_sig / p_err)


def weight_snr_report(plain_layers: dict, quant_layers: dict) -> dict:
    """Per-projection SNR stats across the layer stack."""
    from ..ops import quant as Q

    out = {}
    for key, qw in quant_layers.items():
        if not Q.is_quantized(qw):
            continue
        w, q8, scale = plain_layers[key], qw["q8"], qw["scale"]  # [L, K, N], [L, K, N], [L, N]
        if w.ndim == 2:
            w, q8, scale = w[None], q8[None], scale[None]
        snrs = [_snr_db(w[i], q8[i], scale[i]) for i in range(w.shape[0])]
        out[key] = {
            "min_db": round(min(snrs), 2),
            "median_db": round(float(np.median(snrs)), 2),
            "layers": len(snrs),
        }
    return out


def _routes(model, cache, layers: bool):
    """(decode step, code predictor) of ``model`` on ``cache``: as its
    batch-1 frame loop takes them (kernel 3 through the model's pack where
    the tree takes the whole-step path, the code predictor's route), or,
    with ``layers``, the layer paths the batched loop takes, where every
    product goes through ``quant.mm``."""
    from ..models import code_predictor as cp
    from ..models import talker
    from ..ops import fused_layer, quant

    tparams, tcfg = model.talker_params, model.config.talker
    cpparams, cpcfg = model.cp_params, model.config.code_predictor
    if layers:
        def step(x, pos):
            h = talker.forward(tparams, tcfg, x, cache, torch.full((1,), pos, device=x.device), pos)
            return h, talker.codec_logits(tparams, h)[:, 0, :]

        def predict(h, s):
            return fused_layer.cp_frame_layers(cpparams, cpcfg, h, s, quant.mm)

        return step, predict

    def predict(h, s):
        return cp.predict_acoustic_codes(cpparams, cpcfg, h, s, model.cp_frame_pack, model.cp_step_pack)

    if talker.stream_plane_mode(tparams, tcfg, cache):
        ck, cv = talker.plane_views(cache)

        def step(x, pos):
            return talker.decode_step_planes(tparams, tcfg, x, pos, ck, cv, model.talker_step_pack)
    else:
        def step(x, pos):
            return talker.decode_step(tparams, tcfg, x, pos, cache)
    return step, predict


@torch.no_grad()
def logit_drift_report(model_plain, model_int8, n_steps: int = 16, seed: int = 0, w8a8: bool = False) -> dict:
    """Drive both models through identical decode steps and compare logits.

    The int8 model consumes the PLAIN model's sampled token stream, so both
    see identical inputs at every step and the comparison isolates
    quantization error (no compounding divergence). Each model runs its
    batch-1 routes; with ``w8a8`` the int8 model runs the batched loop's
    layer paths under ``quant.w8a8_scope``, so that every int8 product
    quantizes its activations, as w8a8 serving does.
    """
    from ..models import code_predictor as cp
    from ..models import talker
    from ..models import tokens as T
    from ..ops import nn, quant, rng, sampling

    cfg = model_plain.config
    scfg = sampling.SamplingConfig()
    max_seq = 10 + n_steps + 8

    def run(model, token_stream=None, layers=False):
        tparams, cpparams, dev = model.talker_params, model.cp_params, model.device
        cache = nn.init_kv_cache(cfg.talker.layer_stack(), 1, max_seq, model.compute_dtype, dev)
        prompt = talker.build_custom_voice_prompt(
            tparams, torch.tensor(5, device=dev), T.SPEAKERS["ryan"].token_id, T.LANGUAGES["english"])
        last, logits = talker.prefill(tparams, cfg.talker, prompt, prompt.shape[1], cache)
        step, predict = _routes(model, cache, layers)
        uniforms = torch.from_numpy(rng.pcg_uniform_sequence(42 + seed, n_steps + 1)).to(dev)

        def next_token(i, logits):
            if token_stream is None:
                return sampling.sample(logits, scfg, uniforms[i])[0]
            return torch.tensor(token_stream[min(i, len(token_stream) - 1)], device=dev)

        logits_seq, codes_seq, tokens = [], [], []
        token = next_token(0, logits)
        pos = prompt.shape[1]
        for i in range(n_steps):
            tokens.append(int(token))
            semantic = talker.embed_codec(tparams, token.reshape(1))[None]
            codes = predict(last, semantic)
            codes_seq.append(codes.cpu().numpy())
            acoustic = cp.acoustic_embedding_sum(cpparams, codes).to(semantic.dtype)
            last, logits = step(semantic + acoustic, pos)
            logits_seq.append(logits[0].float().cpu().numpy())
            token = next_token(i + 1, logits)
            pos += 1
        return tokens, np.stack(logits_seq), np.stack(codes_seq)

    tokens, logits_ref, codes_ref = run(model_plain)
    before = launch_counts()
    with quant.w8a8_scope(w8a8):
        _, logits_q, codes_q = run(model_int8, token_stream=tokens, layers=w8a8)
    launches = launches_since(before)

    def softmax(x):
        x = x - x.max(-1, keepdims=True)
        e = np.exp(x)
        return e / e.sum(-1, keepdims=True)

    p = softmax(logits_ref)
    q = softmax(logits_q)
    kl = float((p * (np.log(p + 1e-12) - np.log(q + 1e-12))).sum(-1).mean())
    talker_flips = float((logits_ref.argmax(-1) != logits_q.argmax(-1)).mean())
    cp_flips = float((codes_ref != codes_q).mean())
    return {
        "steps": n_steps,
        "mean_logit_kl": kl,
        "talker_argmax_flip_rate": talker_flips,
        "cp_code_flip_rate": cp_flips,
        "launches": launches,
    }


PROMOTE_CRITERION = {
    "min_weight_snr_db": 30.0,
    "max_mean_logit_kl": 5e-3,
    "max_talker_flip_rate": 0.01,
    "max_cp_flip_rate": 0.01,
}


def report(model_plain, model_int8, steps: int, source: str) -> dict:
    """The whole report of a plain model and its int8 counterpart (the same
    weights, ``quantize_int8=True``), with the promote decision."""
    from ..models import weights as W

    def fused(params):
        return params if "qkv_proj" in params["layers"] else W.fuse_model_params(params)

    out = {
        "source": source,
        "device": {"platform": "gpu" if model_plain.device.type == "cuda" else "cpu",
                   "card": card_name(model_plain.device)},
        "talker_weight_snr": weight_snr_report(
            fused(model_plain.talker_params)["layers"], model_int8.talker_params["layers"]
        ),
        "cp_weight_snr": weight_snr_report(
            fused(model_plain.cp_params)["layers"], model_int8.cp_params["layers"]
        ),
        "logit_drift": logit_drift_report(model_plain, model_int8, steps),
        # w8a8 (batched throughput mode, Qwen3TTS int8_activations=True)
        # adds per-token activation rounding on top of weight quantization;
        # the same promote criterion applies before enabling it in serving.
        "logit_drift_w8a8": logit_drift_report(model_plain, model_int8, steps, w8a8=True),
        "promote_criterion": PROMOTE_CRITERION,
    }
    snrs = [
        v["min_db"]
        for sec in ("talker_weight_snr", "cp_weight_snr")
        for v in out[sec].values()
    ]
    drift = out["logit_drift"]
    out["promote_int8"] = bool(
        snrs
        and min(snrs) >= PROMOTE_CRITERION["min_weight_snr_db"]
        and drift["mean_logit_kl"] <= PROMOTE_CRITERION["max_mean_logit_kl"]
        and drift["talker_argmax_flip_rate"] <= PROMOTE_CRITERION["max_talker_flip_rate"]
        and drift["cp_code_flip_rate"] <= PROMOTE_CRITERION["max_cp_flip_rate"]
    )
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="validation quant-report", description="int8 quality guardrails")
    ap.add_argument("--model-dir", default=None, help="real checkpoint (else synthetic)")
    ap.add_argument("--variant", default="0.6B")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu (default: cuda; no CPU fallback)")
    return ap


def main(argv: list[str] | None = None) -> int:
    from ..models.config import config_for_variant
    from ..pipeline import Qwen3TTS
    from ..utils.device import parse_device

    args = build_parser().parse_args(argv)
    device = parse_device(args.device)
    if args.model_dir:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        model_plain = Qwen3TTS.from_pretrained(args.model_dir, dtype=dtype, device=device)
        model_int8 = Qwen3TTS.from_pretrained(args.model_dir, dtype=dtype, device=device, quantize_int8=True)
        source = args.model_dir
    else:
        cfg = tiny_config() if args.variant == "tiny" else config_for_variant(args.variant, "custom_voice")
        model_plain = Qwen3TTS.from_random(cfg, seed=0, device=device)
        model_int8 = Qwen3TTS.from_random(cfg, seed=0, device=device, quantize_int8=True)
        source = f"synthetic:{args.variant}"

    text = json.dumps(report(model_plain, model_int8, args.steps, source), indent=2)
    print(text)
    if args.out:
        Path(args.out).write_text(text)
    return 0
