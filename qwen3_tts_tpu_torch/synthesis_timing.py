"""End-to-end synthesis times on the card, for comparing two checkouts.

    python3 qwen3_tts_tpu_torch/synthesis_timing.py [--root DIR] [--tag NAME] [--repeats R] [--cells C,...]

Builds the 1.7B CustomVoice model of the checkout at ``--root`` (default:
the one that holds this file) from random weights (seed 0) in bf16, then
the int8 model quantized from the same trees, as ``chip_smoke.py`` builds
them, and times each one's ``synthesize_with_voice`` and
``synthesize_with_timing`` on ``chip_smoke.py``'s utterance (a fixed
13-token prompt, 125 frames forced, seed 42): one warm call of each, then
``--repeats`` rounds of one call of each. Prints one JSON object a timed
call: its wall time (the call, audio on the host), RTF and, for the staged
call, its stages (ms a frame of generation). Run it on two checkouts in one
machine session (parent, change, change, parent) to compare them on one
card. ``--cells`` picks the models (default ``bf16,int8``); the cell
``int8-cp-i2816`` is the same 1.7B int8 model with a code predictor of
intermediate 2816 (not a multiple of its hidden 1024, so the JAX gates send
it to the "layer_steps" route: kernels 5 + 6, 70 calls each a frame), whose
staged calls also give the route's per-step calls' time by CUDA events
(``step_ms_per_frame``: every ``run_fused_decode_step`` of the call, summed,
over the frames). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

FRAMES = 125
TEXT = "The quick brown fox jumps over the lazy dog near the river bank today."


class BenchTokenizer:
    """Fixed 13-token prompt (``chip_smoke.py``'s)."""

    def encode(self, text):
        return [200 + (i * 37) % 1000 for i in range(13)]


class StepSpans:
    """CUDA events around every ``fused_layer.run_fused_decode_step`` call
    while it is entered (the code predictor calls it through the module)."""

    def __init__(self):
        from qwen3_tts_tpu_torch.ops import fused_layer

        self.module, self.spans = fused_layer, []
        self.routed = fused_layer.run_fused_decode_step

    def __enter__(self):
        def timed(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y = self.routed(*args, **kwargs)
            end.record()
            self.spans.append((start, end))
            return y

        self.module.run_fused_decode_step = timed
        return self

    def __exit__(self, *exc):
        self.module.run_fused_decode_step = self.routed

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in self.spans)


def timed_calls(model, form: str, tag: str, repeats: int, calls_of: tuple = ("synthesize_with_voice",
                                                                              "synthesize_with_timing")):
    """One JSON line a timed call of ``model``."""
    from qwen3_tts_tpu_torch.models.tokens import OUTPUT_SAMPLE_RATE
    from qwen3_tts_tpu_torch.pipeline import SynthesisOptions

    opts = SynthesisOptions(max_length=FRAMES, min_new_tokens=FRAMES, seed=42, temperature=0.9)
    calls = {
        "synthesize_with_voice": lambda: (model.synthesize_with_voice(TEXT, "ryan", "english", opts), None),
        "synthesize_with_timing": lambda: model.synthesize_with_timing(TEXT, "ryan", "english", opts),
    }
    calls = {name: calls[name] for name in calls_of}
    for call in calls.values():
        call()
    for i in range(repeats):
        for name, call in calls.items():
            torch.cuda.synchronize()
            with StepSpans() as steps:
                t0 = time.perf_counter()
                audio, timing = call()
                wall = time.perf_counter() - t0
            line = {"tag": tag, "form": form, "call": name, "round": i, "wall_ms": wall * 1e3,
                    "rtf": wall / (len(audio.samples) / OUTPUT_SAMPLE_RATE)}
            if timing is not None:
                line.update(prefill_ms=timing.prefill_ms, ms_per_frame=timing.generation_ms / timing.generation_frames,
                            decode_ms=timing.decode_ms)
                if steps.spans:
                    line.update(step_calls=len(steps.spans), step_ms_per_frame=steps.ms() / timing.generation_frames)
            yield line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent,
                    help="checkout whose qwen3_tts_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="name printed on every line (default: --root)")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--cells", default="bf16,int8", help="comma-separated: bf16, int8, int8-cp-i2816")
    args = ap.parse_args()
    cells = args.cells.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("synthesis_timing: no CUDA device")
    sys.path[0] = str(args.root.resolve())  # in place of this file's directory
    from dataclasses import replace

    from qwen3_tts_tpu_torch import build
    from qwen3_tts_tpu_torch.models.config import config_for_variant
    from qwen3_tts_tpu_torch.pipeline import Qwen3TTS

    tag = args.tag or str(args.root)
    build.build()
    dev = torch.device("cuda", 0)
    base = config_for_variant("1.7B", "custom_voice")
    if "bf16" in cells or "int8" in cells:
        model = Qwen3TTS.from_random(base, seed=0, device=dev)
        model.tokenizer = BenchTokenizer()
        if "bf16" in cells:
            for line in timed_calls(model, "bf16", tag, args.repeats):
                print(json.dumps(line), flush=True)
        m8 = Qwen3TTS(model.config, model.talker_params, model.cp_params, model.vocoder_params, model.tokenizer,
                      quantize_int8=True)
        del model
        torch.cuda.empty_cache()
        if "int8" in cells:
            for line in timed_calls(m8, "int8", tag, args.repeats):
                print(json.dumps(line), flush=True)
        del m8
        torch.cuda.empty_cache()
    if "int8-cp-i2816" in cells:
        cfg = replace(base, code_predictor=replace(base.code_predictor, intermediate_size=2816))
        model = Qwen3TTS.from_random(cfg, seed=0, device=dev, quantize_int8=True)
        model.tokenizer = BenchTokenizer()
        for line in timed_calls(model, "int8-cp-i2816", tag, args.repeats, ("synthesize_with_timing",)):
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
