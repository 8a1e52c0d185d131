"""Audio quality gate (the JAX package's ``scripts/quality_check.py``).

Checks a WAV (or a directory of WAVs) for duration bounds, RMS level,
leading/trailing silence, clipping fraction and DC offset; exits non-zero
on failure. ``check_wav`` also takes an optional ``transcribe`` callable
(path -> text, e.g. a Whisper model's; none is bundled) and the text the
audio should say, and then reports the word error rate; with ``max_wer``
it is gated too.

    python -m qwen3_tts_tpu_torch.validation quality out.wav [--json]
"""

from __future__ import annotations

import argparse
import json
from collections.abc import Callable
from pathlib import Path

import numpy as np

from ..audio.io import load_wav


def word_error_rate(reference: str, hypothesis: str) -> float:
    """Word-level Levenshtein distance over the reference's word count."""
    ref, hyp = reference.lower().split(), hypothesis.lower().split()
    row = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        prev, row[0] = row[0], i
        for j, h in enumerate(hyp, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1, prev + (r != h))
    return row[-1] / max(len(ref), 1)


def check_wav(
    path: Path,
    min_duration: float = 0.3,
    max_duration: float = 170.0,
    min_rms: float = 0.005,
    max_clipping: float = 0.01,
    max_leading_silence: float = 2.0,
    max_dc: float = 0.02,
    transcribe: Callable[[Path], str] | None = None,
    text: str | None = None,
    max_wer: float | None = None,
) -> dict:
    buf = load_wav(path)
    x = buf.samples
    sr = buf.sample_rate
    duration = len(x) / sr
    rms = float(np.sqrt(np.mean(x**2))) if len(x) else 0.0
    clipping = float((np.abs(x) >= 0.999).mean()) if len(x) else 0.0
    dc = float(np.mean(x)) if len(x) else 0.0

    # leading silence: first sample above 5% of peak
    peak = float(np.abs(x).max()) if len(x) else 0.0
    if peak > 0:
        above = np.nonzero(np.abs(x) > 0.05 * peak)[0]
        lead = float(above[0] / sr) if len(above) else duration
        trail = float((len(x) - 1 - above[-1]) / sr) if len(above) else duration
    else:
        lead = trail = duration

    failures = []
    if duration < min_duration:
        failures.append(f"too short: {duration:.2f}s < {min_duration}s")
    if duration > max_duration:
        failures.append(f"too long: {duration:.2f}s > {max_duration}s")
    if rms < min_rms:
        failures.append(f"too quiet: rms {rms:.4f} < {min_rms}")
    if clipping > max_clipping:
        failures.append(f"clipping: {clipping:.2%} of samples")
    if lead > max_leading_silence:
        failures.append(f"leading silence {lead:.2f}s")
    if abs(dc) > max_dc:
        failures.append(f"dc offset {dc:.3f}")

    report = {
        "file": str(path),
        "sample_rate": sr,
        "duration_s": round(duration, 3),
        "rms": round(rms, 5),
        "clipping_frac": round(clipping, 5),
        "leading_silence_s": round(lead, 3),
        "trailing_silence_s": round(trail, 3),
        "dc_offset": round(dc, 5),
    }
    if transcribe is not None and text is not None:
        report["transcript"] = transcribe(Path(path))
        report["wer"] = round(word_error_rate(text, report["transcript"]), 4)
        if max_wer is not None and report["wer"] > max_wer:
            failures.append(f"wer {report['wer']:.2%} > {max_wer:.2%}")
    report["pass"] = not failures
    report["failures"] = failures
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="validation quality", description="Audio quality gate of WAV files")
    ap.add_argument("paths", nargs="+", help="WAV files or directories")
    ap.add_argument("--min-rms", type=float, default=0.005)
    ap.add_argument("--max-clipping", type=float, default=0.01)
    ap.add_argument("--min-duration", type=float, default=0.3)
    ap.add_argument("--max-leading-silence", type=float, default=2.0)
    ap.add_argument("--max-dc", type=float, default=0.02)
    ap.add_argument("--json", action="store_true")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    files: list[Path] = []
    for p in map(Path, args.paths):
        files.extend(sorted(p.glob("**/*.wav")) if p.is_dir() else [p])
    if not files:
        raise SystemExit("no WAV files found")

    reports = [
        check_wav(
            f,
            min_duration=args.min_duration,
            min_rms=args.min_rms,
            max_clipping=args.max_clipping,
            max_leading_silence=args.max_leading_silence,
            max_dc=args.max_dc,
        )
        for f in files
    ]
    if args.json:
        print(json.dumps(reports, indent=2))
    else:
        for r in reports:
            status = "PASS" if r["pass"] else "FAIL " + "; ".join(r["failures"])
            print(f"{r['file']}: {r['duration_s']}s rms={r['rms']} -> {status}")
    return 0 if all(r["pass"] for r in reports) else 1
