"""Variant x seed synthesis matrix with an HTML report (the JAX package's
``scripts/test_variants.py``).

With checkpoints: pass --ckpt per variant directory. Without: runs every
variant with synthetic weights (structural/throughput validation only).
Writes WAVs + an HTML summary with per-run RTF and quality-gate results;
each RTF is printed beside the device's name and power limit.

    python -m qwen3_tts_tpu_torch.validation variants [--ckpt DIR ...] [--out-dir variant_report]
"""

from __future__ import annotations

import argparse
import gc
import html
import time
from pathlib import Path

import torch

from ..models.config import config_for_variant
from . import card_name
from .quality import check_wav

VARIANTS = [
    ("0.6B", "custom_voice"),
    ("0.6B", "base"),
    ("1.7B", "custom_voice"),
    ("1.7B", "base"),
    ("1.7B", "voice_design"),
]

TEXT = "The stars wheeled slowly overhead as the expedition made camp."


class Tok:
    """A word-hash tokenizer for synthetic models (no tokenizer files)."""

    def encode(self, text):
        return [37 + (hash(w) % 15000) for w in text.split()]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="validation variants", description="Variant x seed synthesis matrix")
    ap.add_argument("--out-dir", default="variant_report")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 7])
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--ckpt", action="append", default=[],
                    help="checkpoint dir (repeatable); variant auto-detected")
    ap.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu (default: cuda; no CPU fallback)")
    return ap


def main(argv: list[str] | None = None) -> int:
    from ..models.config import ModelType
    from ..pipeline import Qwen3TTS, SynthesisOptions
    from ..utils.device import parse_device

    args = build_parser().parse_args(argv)
    device = parse_device(args.device)
    card = card_name(device)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    # Lazy model construction: one model in device memory at a time.
    def model_specs():
        if args.ckpt:
            for c in args.ckpt:
                m = Qwen3TTS.from_pretrained(c, device=device)
                yield m.config.label, m, False
        else:
            for size, variant in VARIANTS:
                m = Qwen3TTS.from_random(config_for_variant(size, variant), device=device)
                m.tokenizer = Tok()
                yield m.config.label, m, True

    rows = []
    for label, model, synthetic in model_specs():
        for seed in args.seeds:
            opts = SynthesisOptions(
                max_length=args.frames,
                min_new_tokens=args.frames if synthetic else 2,
                seed=seed,
            )
            t0 = time.perf_counter()
            if model.config.model_type == ModelType.VOICE_DESIGN:
                audio = model.synthesize_voice_design(TEXT, "a clear narrator voice", "english", opts)
            else:
                audio = model.synthesize_with_voice(TEXT, "ryan", "english", opts)
            wall = time.perf_counter() - t0
            fname = f"{label.replace(' ', '_')}_seed{seed}.wav"
            audio.save(out / fname)
            if synthetic:
                # Random weights produce noise; the gate only means something
                # with real checkpoints.
                quality = "n/a (synthetic)"
            else:
                q = check_wav(out / fname)
                quality = "PASS" if q["pass"] else "FAIL " + "; ".join(q["failures"])
            rtf = wall / audio.duration if audio.duration else float("inf")
            rows.append((label, seed, audio.duration, rtf, quality, fname))
            print(f"{label} seed={seed}: {audio.duration:.2f}s RTF {rtf:.3f} ({card}) "
                  f"quality={quality}", flush=True)
        # Release this variant's device buffers before building the next.
        del model
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    body = "".join(
        f"<tr><td>{html.escape(l)}</td><td>{s}</td><td>{d:.2f}s</td>"
        f"<td>{r:.3f}</td><td>{html.escape(str(p))}</td>"
        f"<td><audio controls src='{f}'></audio></td></tr>"
        for l, s, d, r, p, f in rows
    )
    (out / "report.html").write_text(
        "<html><head><title>Variant report</title></head><body>"
        f"<h1>qwen3-tts-tpu variant matrix (PyTorch port)</h1><p>text: {html.escape(TEXT)}</p>"
        f"<p>device: {html.escape(card)}</p>"
        "<table border=1 cellpadding=4><tr><th>variant</th><th>seed</th>"
        "<th>duration</th><th>RTF</th><th>quality</th><th>audio</th></tr>"
        f"{body}</table></body></html>"
    )
    print(f"report: {out / 'report.html'}")
    return 0
