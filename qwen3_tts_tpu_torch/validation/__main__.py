"""One entry point for the validation chain of the PyTorch/CUDA port.

    python -m qwen3_tts_tpu_torch.validation <command> [options]

Commands (each ``--help`` lists its options; every one that builds a model
runs on the CUDA card unless given ``--device cpu``, with no fallback):

  quality        the audio quality gate of WAVs (``quality.py``)
  trace-report   per-kernel device time of a ``--profile`` trace (``trace_report.py``)
  audit          the frame loops' host reads, static and counted (``audit.py``)
  quant-report   int8 / w8a8 weight SNR, logit drift, promote decision (``quant_report.py``)
  parity-matrix  {solo, mesh} x {bf16, int8, w8a8} through from_pretrained (``parity_matrix.py``)
  variants       the variant x seed matrix with an HTML report (``variants.py``)
  parity         a checkpoint's chain (the JAX package's ``make parity`` without
                 its JAX-only steps): with ``--golden DIR`` (dumps of
                 ``scripts/dump_reference_values.py``) the port's stages held
                 to them, then a CLI synthesis (``python -m qwen3_tts_tpu_torch``),
                 the quality gate on its WAV, variants and the quant report
  drill          ``parity`` with lenient audio gates on a seeded tiny
                 checkpoint (``ckpt_fixture.write_checkpoint``), then
                 ``parity-matrix`` on it

A command exits non-zero when any of its checks fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from . import audit, parity_matrix, quality, quant_report, trace_report, variants

PACKAGE_ROOT = Path(__file__).resolve().parent.parent.parent
COMMANDS = {
    "quality": quality.main,
    "trace-report": trace_report.main,
    "audit": audit.main,
    "quant-report": quant_report.main,
    "parity-matrix": parity_matrix.main,
    "variants": variants.main,
}
# tests/test_reference_golden.py's tolerances (max |port - dump| a stage) on
# a published checkpoint's dumps.
GOLDEN_TOL = {"text_embedding": 1e-2, "text_projection": 5e-2, "talker_forward": 0.15, "vocoder_waveform": 1e-3}


def golden_stages(model, golden_dir: str | Path) -> dict:
    """The port's stages against the dumps in ``golden_dir`` (its
    ``metadata.json`` and ``.bin`` files): max |port - dump| of each dumped
    stage, and of the generated code matrix (the dump's text, voice, seed
    and sampling) the share of codes equal (``codes_share``, 1.0 when
    token-exact)."""
    from ..models import talker
    from ..ops import nn
    from ..pipeline import SynthesisOptions

    golden_dir = Path(golden_dir)
    meta = json.loads((golden_dir / "metadata.json").read_text())

    def stage(name):
        s = meta["stages"][name]
        return np.fromfile(golden_dir / s["file"], dtype=np.dtype(s.get("dtype", "float32"))).reshape(s["shape"])

    def mad(got, want) -> float:
        got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
        return float(np.abs(got - np.asarray(want, np.float32)).max())

    params, tcfg, dev = model.talker_params, model.config.talker, model.device
    ids = torch.tensor(meta["input_ids"], dtype=torch.long, device=dev)
    out = {}
    with torch.no_grad():
        if "text_embedding" in meta["stages"]:
            out["text_embedding"] = mad(params["text_embedding"][ids], stage("text_embedding"))
        if "text_projection" in meta["stages"]:
            out["text_projection"] = mad(talker.embed_text(params, ids), stage("text_projection"))
        if "talker_forward" in meta["stages"]:
            x = talker.embed_text(params, ids)[None]
            cache = nn.init_kv_cache(tcfg.layer_stack(), 1, x.shape[1], x.dtype, dev)
            h = talker.forward(params, tcfg, x, cache, torch.arange(x.shape[1], device=dev), 0)
            out["talker_forward"] = mad(talker.codec_logits(params, h)[0], stage("talker_forward"))
        if "codes" in meta["stages"]:
            codes = stage("codes")
            opts = SynthesisOptions(max_length=len(codes), seed=meta["seed"], **meta.get("sampling", {}))
            frames = model.synthesize_streaming(meta["text"], meta["speaker"], meta["language"],
                                                opts).run_to_completion()
            out["codes_share"] = float((frames == codes).mean()) if frames.shape == codes.shape else 0.0
            if "vocoder_waveform" in meta["stages"]:
                want = stage("vocoder_waveform")
                out["vocoder_waveform"] = mad(model.decode_codes(codes.astype(np.int32)).samples[: len(want)], want)
    return out


def _golden(model_dir: str, golden: str, device: torch.device) -> int:
    from ..pipeline import Qwen3TTS

    if not (Path(golden) / "metadata.json").exists():
        print(f"golden: no {Path(golden) / 'metadata.json'}; stage checks skipped")
        return 0
    diffs = golden_stages(Qwen3TTS.from_pretrained(model_dir, device=device), golden)
    failed = [k for k, tol in GOLDEN_TOL.items() if k in diffs and not diffs[k] < tol]
    for k, d in diffs.items():
        bar = f" (tolerance {GOLDEN_TOL[k]})" if k in GOLDEN_TOL else " (reported)"
        print(f"golden {k}: {d:.4e}{bar}")
    print(f"golden: {'FAIL ' + ', '.join(failed) if failed else 'PASS'}")
    return 1 if failed else 0


def parity(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="validation parity", description="A checkpoint's validation chain")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--golden", default=None, help="dumps of scripts/dump_reference_values.py")
    ap.add_argument("--out", default="parity_out", help="the WAVs and reports go here")
    ap.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu (default: cuda; no CPU fallback)")
    ap.add_argument("--frames", type=int, default=None, help="the CLI synthesis' --frames")
    ap.add_argument("--min-new-tokens", type=int, default=None, help="the CLI synthesis' --min-new-tokens")
    # The quality gate's flags and defaults.
    ap.add_argument("--min-rms", type=float, default=0.005)
    ap.add_argument("--max-clipping", type=float, default=0.01)
    ap.add_argument("--min-duration", type=float, default=0.3)
    ap.add_argument("--max-leading-silence", type=float, default=2.0)
    ap.add_argument("--max-dc", type=float, default=0.02)
    args = ap.parse_args(argv)

    from ..utils.device import parse_device

    device = parse_device(args.device)
    model_dir = str(Path(args.model_dir).resolve())
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    if args.golden and _golden(model_dir, args.golden, device):
        return 1

    wav = out / "parity_check.wav"
    cli = [sys.executable, "-m", "qwen3_tts_tpu_torch", "--model-dir", model_dir, "--text", "parity check run",
           "--seed", "42", "--output", str(wav), "--device", args.device]
    for flag in ("frames", "min_new_tokens"):
        if getattr(args, flag) is not None:
            cli += [f"--{flag.replace('_', '-')}", str(getattr(args, flag))]
    print("parity: " + " ".join(cli[1:]), flush=True)
    if subprocess.run(cli, cwd=PACKAGE_ROOT).returncode:
        print("parity: the CLI synthesis failed")
        return 1

    qc = [str(wav)] + [x for k in ("min_rms", "max_clipping", "min_duration", "max_leading_silence", "max_dc")
                       for x in (f"--{k.replace('_', '-')}", str(getattr(args, k)))]
    if quality.main(qc):
        print("parity: the quality gate failed")
        return 1
    variants.main(["--ckpt", model_dir, "--out-dir", str(out / "variants"), "--device", args.device])
    return quant_report.main(["--model-dir", model_dir, "--out", str(out / "quant_report.json"),
                              "--device", args.device])


def drill_checkpoint(out: Path) -> Path:
    """The drill's seeded checkpoint of ``validation.tiny_config`` (and the
    tiny vocoder) in ``out``."""
    from .. import ckpt_fixture
    from . import tiny_config, tiny_vocoder

    cfg, voc = tiny_config(), tiny_vocoder()
    ckpt_fixture.write_checkpoint(out, cfg, ckpt_fixture.seeded_weights(ckpt_fixture.model_specs(cfg), 5),
                                  ckpt_fixture.seeded_weights(ckpt_fixture.speech_specs(voc), 6, torch.float32), voc)
    return out


def drill(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="validation drill", description="parity and parity-matrix on a seeded checkpoint")
    ap.add_argument("--out", default="parity_drill")
    ap.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    out = Path(args.out).resolve()
    ckpt = drill_checkpoint(out / "ckpt")
    print(f"drill: seeded checkpoint written to {ckpt}", flush=True)
    # Lenient audio gates: random weights cannot meet the production ones.
    rc = parity(["--model-dir", str(ckpt), "--out", str(out / "parity"), "--device", args.device,
                 "--min-new-tokens", "12", "--frames", "24",
                 "--min-rms", "0", "--max-clipping", "1", "--max-leading-silence", "99", "--max-dc", "1"])
    if rc:
        return rc
    return parity_matrix.main(["--model-dir", str(ckpt), "--device", args.device])


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    chains = {"parity": parity, "drill": drill}
    if not argv or argv[0] not in {**COMMANDS, **chains}:
        print(__doc__, file=sys.stderr)
        return 2
    command, rest = argv[0], argv[1:]
    return (chains.get(command) or COMMANDS[command])(rest)


if __name__ == "__main__":
    sys.exit(main())
