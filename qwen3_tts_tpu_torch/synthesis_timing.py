"""End-to-end synthesis times on the card, for comparing two checkouts.

    python3 qwen3_tts_tpu_torch/synthesis_timing.py [--root DIR] [--tag NAME] [--repeats R]

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
card. Needs a CUDA device.
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


def timed_calls(model, form: str, tag: str, repeats: int):
    """One JSON line a timed call of ``model``."""
    from qwen3_tts_tpu_torch.models.tokens import OUTPUT_SAMPLE_RATE
    from qwen3_tts_tpu_torch.pipeline import SynthesisOptions

    opts = SynthesisOptions(max_length=FRAMES, min_new_tokens=FRAMES, seed=42, temperature=0.9)
    calls = {
        "synthesize_with_voice": lambda: (model.synthesize_with_voice(TEXT, "ryan", "english", opts), None),
        "synthesize_with_timing": lambda: model.synthesize_with_timing(TEXT, "ryan", "english", opts),
    }
    for call in calls.values():
        call()
    for i in range(repeats):
        for name, call in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio, timing = call()
            wall = time.perf_counter() - t0
            line = {"tag": tag, "form": form, "call": name, "round": i, "wall_ms": wall * 1e3,
                    "rtf": wall / (len(audio.samples) / OUTPUT_SAMPLE_RATE)}
            if timing is not None:
                line.update(prefill_ms=timing.prefill_ms, ms_per_frame=timing.generation_ms / timing.generation_frames,
                            decode_ms=timing.decode_ms)
            yield line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent,
                    help="checkout whose qwen3_tts_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="name printed on every line (default: --root)")
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("synthesis_timing: no CUDA device")
    sys.path[0] = str(args.root.resolve())  # in place of this file's directory
    from qwen3_tts_tpu_torch import build
    from qwen3_tts_tpu_torch.models.config import config_for_variant
    from qwen3_tts_tpu_torch.pipeline import Qwen3TTS

    tag = args.tag or str(args.root)
    build.build()
    dev = torch.device("cuda", 0)
    model = Qwen3TTS.from_random(config_for_variant("1.7B", "custom_voice"), seed=0, device=dev)
    model.tokenizer = BenchTokenizer()
    for line in timed_calls(model, "bf16", tag, args.repeats):
        print(json.dumps(line), flush=True)
    m8 = Qwen3TTS(model.config, model.talker_params, model.cp_params, model.vocoder_params, model.tokenizer,
                  quantize_int8=True)
    del model
    torch.cuda.empty_cache()
    for line in timed_calls(m8, "int8", tag, args.repeats):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
