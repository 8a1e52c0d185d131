"""Smoke run of the PyTorch/CUDA port on one card: build, check, time, run.

Usage (from the repository root, on a machine with an NVIDIA Hopper card and
the CUDA toolkit):

    python3 chip_smoke.py

Phases, each printing a line (any failure exits nonzero before the last):
  1. card: name and power limit (nvidia-smi);
  2. build: both CUDA kernels from qwen3_tts_tpu_torch/csrc (into
     qwen3_tts_tpu_torch/_build/);
  3. kernel 1 (code-predictor frame) against its plain version at the 1.7B
     code-predictor shapes on 32 random frames: f32 codes identical; bf16
     (the main path's dtype) first codes equal in >= 28 of 32 frames and
     >= 50% of all codes equal; both timed;
  4. kernel 2 (vocoder residual unit) against its plain version at C =
     384/192/96 and dilations 1/3/9 over the time lengths of a 128-frame
     decode: within atol = 1e-5 * max|x|, a prefix bit-identical, both timed;
  5. end to end: a small f32 model on the card against the same weights on
     the CPU (identical frames, close audio), then the 1.7B CustomVoice main
     path (``Qwen3TTS.from_random(config_for_variant("1.7B",
     "custom_voice"))``, the fixed 13-token prompt, 125 frames, seed 42,
     temperature 0.9): one warm run, then one timed run with the kernels'
     launch counts reset just before it; the timed run's audio must equal
     the warm run's bit for bit (same seed, deterministic kernels);
  6. a JSON line of the kernels, then the JSON result as the last line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
    sys.exit(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))

import qwen3_tts_tpu_torch  # noqa: E402,F401  (sets the TF32 switches)
from qwen3_tts_tpu_torch import build  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as W  # noqa: E402
from qwen3_tts_tpu_torch.models.codec import fused_blocks  # noqa: E402
from qwen3_tts_tpu_torch.models.codec import vocoder  # noqa: E402
from qwen3_tts_tpu_torch.models.config import (  # noqa: E402
    CodePredictorConfig,
    ModelConfig,
    ModelType,
    TalkerConfig,
    config_for_variant,
)
from qwen3_tts_tpu_torch.models.tokens import OUTPUT_SAMPLE_RATE, SAMPLES_PER_FRAME  # noqa: E402
from qwen3_tts_tpu_torch.ops import fused_layer  # noqa: E402
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS, SynthesisOptions  # noqa: E402

DEV = torch.device("cuda", 0)
FRAMES = 125
CP_FRAMES = 32
BF16_MIN_FIRST_EQUAL = 28  # of CP_FRAMES
BF16_MIN_SHARE_EQUAL = 0.5
KERNEL_ROWS = []


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def print_card() -> None:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(out[0].strip(), flush=True)


def cp_params(cfg: CodePredictorConfig, dtype: torch.dtype, seed: int) -> dict:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    return W.fuse_model_params(W.init_code_predictor_params(gen, cfg, dtype))


def kernel1() -> None:
    cfg = config_for_variant("1.7B", "custom_voice").code_predictor
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    e = cfg.embed_dim
    inputs = [
        (torch.randn((1, 1, e), generator=gen, device=DEV),
         torch.randn((1, 1, e), generator=gen, device=DEV) * 0.02)
        for _ in range(CP_FRAMES)
    ]
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        params = cp_params(cfg, dtype, seed=2)
        xs = [(h.to(dtype), s.to(dtype)) for h, s in inputs]
        got = torch.stack([fused_layer.cp_frame(params, cfg, h, s) for h, s in xs])
        want = torch.stack([fused_layer.cp_frame_plain(params, cfg, h, s) for h, s in xs])
        torch.cuda.synchronize()
        equal = (got == want).float().mean().item()
        first_equal = int((got[:, 0] == want[:, 0]).sum().item())
        err = (got.long() - want.long()).abs().max().item()
        h0, s0 = xs[0]
        ms = time_ms(lambda: fused_layer.cp_frame(params, cfg, h0, s0), iters=20)
        plain_ms = time_ms(lambda: fused_layer.cp_frame_plain(params, cfg, h0, s0), iters=5)
        name = str(dtype).replace("torch.", "")
        phase("kernel1", f"{name}: {CP_FRAMES} frames x {cfg.num_acoustic} codes, share equal "
              f"{equal:.4f}, first codes equal {first_equal}/{CP_FRAMES}, max |code diff| {err}, "
              f"kernel {ms:.4f} ms/frame, plain {plain_ms:.4f} ms/frame")
        result[name] = {"equal": equal, "first_equal": first_equal, "err": err, "ms": ms, "plain_ms": plain_ms}
    check(result["float32"]["equal"] == 1.0,
          f"kernel 1 f32 codes differ from the plain version ({result['float32']['equal']:.4f} equal)")
    # bf16 results depend on summation order: once one code differs, the rest
    # of the frame follows another path. A right kernel agrees on the first
    # code of nearly every frame and on most codes; a wrong one on about none.
    bf16 = result["bfloat16"]
    check(bf16["first_equal"] >= BF16_MIN_FIRST_EQUAL,
          f"kernel 1 bf16: first codes equal in {bf16['first_equal']}/{CP_FRAMES} frames "
          f"(< {BF16_MIN_FIRST_EQUAL})")
    check(bf16["equal"] >= BF16_MIN_SHARE_EQUAL,
          f"kernel 1 bf16: share of equal codes {bf16['equal']:.4f} < {BF16_MIN_SHARE_EQUAL}")
    KERNEL_ROWS.append({
        "name": "cp_frame", "route": "cuda",
        "source": "qwen3_tts_tpu_torch/csrc/cp_frame.cu",
        "replaces": "qwen3_tts_tpu/ops/fused_layer.py:670",
        "launches": 0, "dtype": "bfloat16",
        "max_abs_err": float(bf16["err"]), "share_equal": bf16["equal"],
        "first_codes_equal": f"{bf16['first_equal']}/{CP_FRAMES}",
        "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
        "f32_max_abs_err": float(result["float32"]["err"]),
    })


def unit_params(gen: torch.Generator, c: int) -> dict:
    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device=DEV) * scale

    return {
        "act1_alpha": rnd((c,), 0.1), "act1_beta": rnd((c,), 0.1),
        "conv1_w": rnd((7, c, c), 0.05), "conv1_b": rnd((c,), 0.1),
        "act2_alpha": rnd((c,), 0.1), "act2_beta": rnd((c,), 0.1),
        "conv2_w": rnd((1, c, c), 0.05), "conv2_b": rnd((c,), 0.1),
    }


def kernel2() -> None:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    # Residual-unit time lengths of a 128-frame decode bucket (4x upsample,
    # then the decoder blocks' rates 8, 5, 4, 3): C=384 at 20480 rows, etc.
    shapes = [(384, 128 * 4 * 8 * 5), (192, 128 * 4 * 8 * 5 * 4), (96, 128 * 4 * 8 * 5 * 4 * 3)]
    total_ms = total_plain = worst = 0.0
    for c, t in shapes:
        for dil in (1, 3, 9):
            p = unit_params(gen, c)
            x = torch.randn((1, t, c), generator=gen, device=DEV)
            got = fused_blocks.residual_unit(x, p, dil)
            want = fused_blocks.residual_unit_plain(x, p, dil)
            t_short = t - 1000 - 17  # not a multiple of the kernel's tile
            short = fused_blocks.residual_unit(x[:, :t_short].contiguous(), p, dil)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 1e-5 * x.abs().max().item()
            prefix_equal = torch.equal(short, got[:, :t_short])
            ms = time_ms(lambda: fused_blocks.residual_unit(x, p, dil), iters=5)
            plain_ms = time_ms(lambda: fused_blocks.residual_unit_plain(x, p, dil), iters=5)
            phase("kernel2", f"C={c} T={t} dilation={dil}: max|err| {err:.3e} (atol {tol:.3e}), "
                  f"prefix bit-exact {prefix_equal}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            check(err <= tol, f"kernel 2 C={c} dilation={dil}: max|err| {err:.3e} > {tol:.3e}")
            check(prefix_equal, f"kernel 2 C={c} dilation={dil}: prefix run differs from the long run")
            total_ms += ms
            total_plain += plain_ms
            worst = max(worst, err)
    phase("kernel2", f"all 9 units of a 128-frame decode: kernel {total_ms:.4f} ms, plain {total_plain:.4f} ms")
    KERNEL_ROWS.append({
        "name": "residual_unit", "route": "cuda",
        "source": "qwen3_tts_tpu_torch/csrc/residual_unit.cu",
        "replaces": "qwen3_tts_tpu/models/codec/fused_blocks.py:69",
        "launches": 0, "max_abs_err": worst, "ms": total_ms, "plain_ms": total_plain,
    })


class BenchTokenizer:
    """Fixed 13-token prompt (bench.py's short-corpus length class)."""

    def encode(self, text):
        return [200 + (i * 37) % 1000 for i in range(13)]


def small_model_agrees() -> None:
    """A small f32 model whose shapes the kernels take: the card's run must
    give the CPU plain run's frames exactly and its audio within 1e-4."""
    talker = TalkerConfig(
        text_embed_dim=128, hidden_size=128, text_proj_intermediate=128,
        intermediate_size=256, num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        head_dim=64,
    )
    cpc = CodePredictorConfig(
        hidden_size=128, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=1, head_dim=64, vocab_size=256,
    )
    voc = vocoder.VocoderConfig(
        codebook_dim=32, latent_dim=48, hidden_size=32, num_layers=2, num_heads=2, head_dim=16,
        intermediate_size=64, codebook_embed_dim=16, decoder_dim=64,
    )
    cfg = ModelConfig(model_type=ModelType.CUSTOM_VOICE, model_size="small", talker=talker, code_predictor=cpc)
    gen = torch.Generator()
    gen.manual_seed(5)
    trees = (
        W.init_talker_params(gen, talker, torch.float32),
        W.init_code_predictor_params(gen, cpc, torch.float32),
        vocoder.init_vocoder_params(gen, voc),
    )

    def on(tree, dev):
        if tree is None or isinstance(tree, torch.Tensor):
            return None if tree is None else tree.to(dev)
        if isinstance(tree, dict):
            return {k: on(v, dev) for k, v in tree.items()}
        return type(tree)(on(v, dev) for v in tree)

    opts = SynthesisOptions(max_length=24, min_new_tokens=24, seed=42, temperature=0.9)
    runs = {}
    for dev in ("cpu", DEV):
        model = Qwen3TTS(cfg, *on(trees, dev), BenchTokenizer(), vocoder_config=voc)
        started, uniforms = model._prefill_custom_voice("x", "ryan", "english", opts)
        frames = model._generate(started, uniforms, opts)
        runs[str(dev)] = (frames, model.decode_codes(frames).samples)
    (f_cpu, a_cpu), (f_gpu, a_gpu) = runs["cpu"], runs[str(DEV)]
    same = f_cpu.shape == f_gpu.shape and bool((f_cpu == f_gpu).all())
    err = float(abs(a_cpu - a_gpu).max()) if a_cpu.shape == a_gpu.shape else math.inf
    phase("e2e-small", f"{len(f_gpu)} frames identical to the CPU plain run: {same}; "
          f"audio max|err| {err:.3e} (peak {float(abs(a_cpu).max()):.3e})")
    check(same, "small model: frames on the card differ from the CPU plain run")
    check(err <= 1e-4, f"small model: audio differs from the CPU plain run by {err:.3e}")


def main_path() -> dict:
    t0 = time.perf_counter()
    model = Qwen3TTS.from_random(config_for_variant("1.7B", "custom_voice"), seed=0, device=DEV)
    model.tokenizer = BenchTokenizer()
    torch.cuda.synchronize()
    phase("e2e", f"1.7B CustomVoice synthetic weights built in {time.perf_counter() - t0:.1f} s")
    opts = SynthesisOptions(max_length=FRAMES, min_new_tokens=FRAMES, seed=42, temperature=0.9)
    text = "The quick brown fox jumps over the lazy dog near the river bank today."

    warm, _ = model.synthesize_with_timing(text, "ryan", "english", opts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_layer.cp_frame.launches = 0
    fused_blocks.residual_unit.launches = 0
    t0 = time.perf_counter()
    audio, timing = model.synthesize_with_timing(text, "ryan", "english", opts)
    wall = time.perf_counter() - t0
    launches = {"cp_frame": fused_layer.cp_frame.launches, "residual_unit": fused_blocks.residual_unit.launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    samples = audio.samples
    check(timing.generation_frames == FRAMES, f"expected {FRAMES} frames, got {timing.generation_frames}")
    check(samples.shape == (FRAMES * SAMPLES_PER_FRAME,), f"audio shape {samples.shape}")
    check(bool(torch.isfinite(torch.from_numpy(samples)).all()), "audio has non-finite samples")
    check(all(n > 0 for n in launches.values()), f"a kernel of the path never launched: {launches}")
    repeatable = bool((warm.samples == samples).all())
    check(repeatable, "the timed run's audio differs from the warm run's (same seed)")
    rtf = wall / (len(samples) / OUTPUT_SAMPLE_RATE)
    phase("e2e", f"timed run: prefill {timing.prefill_ms:.2f} ms, "
          f"{timing.generation_ms / timing.generation_frames:.3f} ms/frame over {timing.generation_frames} frames "
          f"(generation {timing.generation_ms:.1f} ms), decode {timing.decode_ms:.1f} ms, "
          f"wall {wall * 1e3:.1f} ms, RTF {rtf:.4f}, peak allocated {peak_mb:.0f} MiB, "
          f"launches {launches}, audio peak {float(abs(samples).max()):.3e}, "
          f"audio equal to the warm run's {repeatable}")
    return launches


def main() -> None:
    phase("card", "name, power limit:")
    kind = torch.cuda.get_device_name(0)
    print_card()
    t0 = time.perf_counter()
    path = build.build()
    phase("build", f"{path.name} in {time.perf_counter() - t0:.1f} s")
    kernel1()
    kernel2()
    small_model_agrees()
    launches = main_path()
    for row in KERNEL_ROWS:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": KERNEL_ROWS}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
