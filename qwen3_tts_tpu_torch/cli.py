"""Command-line synthesis tool of the PyTorch/CUDA port.

Every flag, mode and message of ``qwen3_tts_tpu/cli.py``, in the same
order: preset-speaker, VoiceDesign (--instruct) and voice-cloning
(--ref-audio [--ref-text | --x-vector-only]) paths, duration/frames caps,
deterministic seeding, --dump-codes / --compare / --debug-frames forensics,
a JSON metadata dump, streaming with per-chunk timing, --int8 and a
``torch.profiler`` trace (--profile). One addition: --device (default
``cuda``; ``cpu`` runs on the CPU), in place of the JAX package's
``JAX_PLATFORMS``.

Usage:
    python -m qwen3_tts_tpu_torch --model-dir /path/to/ckpt --text "Hello" \
        --speaker ryan --language english --output out.wav
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qwen3-tts-torch",
        description="Qwen3-TTS synthesis on an NVIDIA GPU (PyTorch/CUDA)",
    )
    p.add_argument("-t", "--text", default="Hello")
    p.add_argument("-s", "--seed", type=int, default=42)
    p.add_argument("-f", "--frames", type=int, default=2048,
                   help="Max frames to generate (~80 ms each); EOS stops early")
    p.add_argument("-d", "--duration", type=float, default=None,
                   help="Max duration in seconds (overrides --frames)")
    p.add_argument("--temperature", type=float, default=0.9)
    p.add_argument("--top-k", type=int, default=50)
    p.add_argument("--top-p", type=float, default=0.9)
    p.add_argument("--repetition-penalty", type=float, default=1.05)
    p.add_argument("--min-new-tokens", type=int, default=2)
    p.add_argument("-m", "--model-dir", required=True)
    p.add_argument("--tokenizer-dir", default=None)
    p.add_argument("-o", "--output-dir", default="generated_audio")
    p.add_argument("--output", default=None, help="Output WAV path (overrides --output-dir naming)")
    p.add_argument("--speaker", default="ryan")
    p.add_argument("--language", default="english")
    p.add_argument("--instruct", default=None,
                   help="Voice description for VoiceDesign models")
    p.add_argument("--ref-audio", default=None,
                   help="Reference WAV for voice cloning (Base models)")
    p.add_argument("--ref-text", default=None,
                   help="Transcript of --ref-audio for ICL voice cloning")
    p.add_argument("--x-vector-only", action="store_true",
                   help="Voice cloning with speaker embedding only (no ICL)")
    p.add_argument("--icl-sequential", action="store_true",
                   help="Sequential [text || codec] ICL prompt layout (mlx-audio variant)")
    p.add_argument("--dump-codes", action="store_true",
                   help="Write the raw [T,16] int32 code matrix next to the WAV")
    p.add_argument("--debug-frames", type=int, nargs="?", const=-1, default=None,
                   metavar="N",
                   help="Per-frame forensics: print semantic token, top-5 "
                        "post-penalty logits, and the 15 CP codes for the "
                        "first N frames (omit N for all). Token stream is "
                        "identical to the production loop.")
    p.add_argument("--compare", default=None, metavar="DIR",
                   help="Compare codes/audio against reference dumps in DIR "
                        "(codes_seed{seed}.bin int32 [T,16], audio_seed{seed}.bin "
                        "f32); reports the FIRST divergent frame and stage")
    p.add_argument("--streaming", action="store_true",
                   help="Stream chunks; prints TTFA and per-chunk timing")
    p.add_argument("--chunk-frames", type=int, default=10)
    p.add_argument("--first-chunk-frames", type=int, default=4,
                   help="Frames in the FIRST streamed chunk (lower = lower "
                        "TTFA; 0 disables and uses --chunk-frames)")
    p.add_argument("--no-exact-streaming", action="store_true",
                   help="Legacy chunk-local vocoder context (reference "
                        "behavior) instead of the sample-exact carried-state "
                        "streaming decode")
    p.add_argument("--metadata", action="store_true",
                   help="Write a JSON metadata file next to the WAV")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Capture a torch.profiler trace into DIR")
    p.add_argument("--int8", action="store_true",
                   help="Weight-only int8 (the W8A16 matmul and the int8 "
                        "whole-step kernels; near-lossless in general but "
                        "validate audio quality per checkpoint)")
    p.add_argument("--device", default="cuda",
                   help="auto | cuda | cuda:N | cpu (default: cuda; no CPU fallback)")
    return p


def validate_args(args) -> None:
    """Cross-validation of mutually exclusive modes (generate_audio.rs:162-211)."""
    if args.instruct and args.ref_audio:
        raise SystemExit(
            "--instruct and --ref-audio are mutually exclusive: --instruct is for "
            "VoiceDesign models, --ref-audio for Base-model voice cloning."
        )
    if args.ref_text and not args.ref_audio:
        raise SystemExit("--ref-text requires --ref-audio (ICL transcript)")
    if args.x_vector_only and not args.ref_audio:
        raise SystemExit("--x-vector-only requires --ref-audio")
    if args.x_vector_only and args.ref_text:
        raise SystemExit(
            "--x-vector-only and --ref-text are mutually exclusive "
            "(x_vector_only disables ICL)"
        )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    validate_args(args)

    from .audio.io import AudioBuffer, save_wav
    from .models import tokens as T
    from .models.config import ModelType
    from .pipeline import Qwen3TTS, SynthesisOptions
    from .utils.device import parse_device

    device = parse_device(args.device)

    max_frames = int(args.duration * 12.5) if args.duration else args.frames
    options = SynthesisOptions(
        max_length=max_frames,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        repetition_penalty=args.repetition_penalty,
        min_new_tokens=args.min_new_tokens,
        chunk_frames=args.chunk_frames,
        first_chunk_frames=args.first_chunk_frames or None,
        streaming_exact=not args.no_exact_streaming,
        seed=args.seed,
        icl_sequential=args.icl_sequential,
    )

    print(f"Loading model from {args.model_dir} ...", file=sys.stderr)
    model = Qwen3TTS.from_pretrained(
        args.model_dir, args.tokenizer_dir, quantize_int8=args.int8, device=device
    )
    print(f"Variant: {model.config.label}"
          + (" (int8)" if args.int8 else ""), file=sys.stderr)

    # Variant-vs-flag warnings (generate_audio.rs:432-479).
    if args.ref_audio and not model.supports_voice_cloning():
        raise SystemExit(
            f"{model.config.label} has no speaker encoder; voice cloning needs a Base model."
        )
    if args.instruct and model.config.model_type != ModelType.VOICE_DESIGN:
        print(
            f"warning: --instruct on a {model.config.label} model; output may be unpredictable",
            file=sys.stderr,
        )
    if not args.instruct and not args.ref_audio and model.config.model_type == ModelType.BASE:
        print(
            "warning: preset speaker on a Base model; Base models are trained for "
            "voice cloning — output voice will be unpredictable",
            file=sys.stderr,
        )

    profile_ctx = None
    if args.profile:
        from .profiling import trace

        profile_ctx = trace(args.profile)
        profile_ctx.__enter__()

    frames = None  # raw [T,16] codes, captured when a path exposes them
    t0 = time.perf_counter()
    if args.ref_audio:
        ref = AudioBuffer.load(args.ref_audio)
        ref_text = None if args.x_vector_only else args.ref_text
        prompt = model.create_voice_clone_prompt(ref, ref_text)
        mode = "icl" if ref_text else "x_vector_only"
        print(f"Voice cloning mode: {mode}", file=sys.stderr)
        audio, frames = model.synthesize_voice_clone_debug(
            args.text, prompt, args.language, options
        )
        n_frames = frames.shape[0]
    elif args.instruct:
        audio = model.synthesize_voice_design(args.text, args.instruct, args.language, options)
        n_frames = len(audio) // T.SAMPLES_PER_FRAME
    elif args.streaming:
        session = model.synthesize_streaming(args.text, args.speaker, args.language, options)
        chunks = []
        first = None
        for chunk in session:
            if first is None:
                first = time.perf_counter() - t0
                print(f"TTFA: {first * 1e3:.0f} ms", file=sys.stderr)
            chunks.append(chunk.samples)
            print(
                f"chunk {len(chunks)}: {len(chunk) / chunk.sample_rate * 1e3:.0f} ms audio",
                file=sys.stderr,
            )
        import numpy as np

        audio = AudioBuffer(np.concatenate(chunks) if chunks else np.zeros(0), 24000)
        n_frames = session.frames_generated
    elif args.debug_frames is not None:
        from .generation.debug import debug_generate

        session = model.synthesize_streaming(args.text, args.speaker, args.language, options)
        trace = debug_generate(model, session)
        limit = len(trace.frames) if args.debug_frames < 0 else args.debug_frames
        for f in trace.frames[:limit]:
            tops = " ".join(
                f"{int(i)}:{v:.3f}" for i, v in zip(f.top_ids, f.top_logits)
            )
            print(
                f"frame {f.frame:4d} | semantic {f.semantic_token:4d} | "
                f"top5 [{tops}] | cp {' '.join(str(int(c)) for c in f.codes)}",
                file=sys.stderr,
            )
        frames = trace.code_matrix()
        audio = model.decode_codes(frames)
        n_frames = frames.shape[0]
    elif args.dump_codes or args.compare:
        session = model.synthesize_streaming(args.text, args.speaker, args.language, options)
        frames = session.run_to_completion()
        audio = model.decode_codes(frames)
        n_frames = frames.shape[0]
    else:
        audio, timing = model.synthesize_with_timing(
            args.text, args.speaker, args.language, options
        )
        n_frames = timing.generation_frames
        print(
            f"prefill {timing.prefill_ms:.0f} ms | generation {timing.generation_ms:.0f} ms "
            f"({timing.generation_frames} frames) | decode {timing.decode_ms:.0f} ms",
            file=sys.stderr,
        )

    wall = time.perf_counter() - t0
    if profile_ctx:
        profile_ctx.__exit__(None, None, None)
        print(f"profiler trace written to {args.profile}", file=sys.stderr)

    out_path = (
        Path(args.output)
        if args.output
        else Path(args.output_dir) / f"audio_seed{args.seed}_frames{max_frames}.wav"
    )
    out_path.parent.mkdir(parents=True, exist_ok=True)
    save_wav(out_path, audio.samples, audio.sample_rate)

    if (args.dump_codes or args.compare or args.debug_frames is not None) and frames is not None:
        import numpy as np

        codes_path = out_path.with_suffix(".codes.bin")
        frames.astype("int32").tofile(codes_path)
        print(f"Wrote {codes_path} ({frames.shape})", file=sys.stderr)

        if args.compare:
            from .generation.debug import first_divergence

            ref_dir = Path(args.compare)
            ref_codes_path = ref_dir / f"codes_seed{args.seed}.bin"
            ref_audio_path = ref_dir / f"audio_seed{args.seed}.bin"
            if ref_codes_path.exists():
                ref_codes = np.fromfile(ref_codes_path, dtype=np.int32).reshape(-1, 16)
                n = min(len(ref_codes), len(frames))
                mismatch = (ref_codes[:n] != frames[:n]).mean()
                print(
                    f"compare codes: {len(frames)} vs {len(ref_codes)} frames, "
                    f"mismatch fraction {mismatch:.4f} over first {n}",
                    file=sys.stderr,
                )
                div = first_divergence(frames, ref_codes)
                if div is None:
                    print("compare codes: IDENTICAL", file=sys.stderr)
                else:
                    print(
                        f"compare codes: first divergence at frame {div['frame']} "
                        f"in {div['stage']}\n"
                        f"  ours: {div['ours']}\n  ref:  {div['ref']}",
                        file=sys.stderr,
                    )
            if ref_audio_path.exists():
                ref_audio = np.fromfile(ref_audio_path, dtype=np.float32)
                n = min(len(ref_audio), len(audio.samples))
                diff = float(np.abs(ref_audio[:n] - audio.samples[:n]).max())
                print(f"compare audio: max|Δ| {diff:.2e} over first {n} samples",
                      file=sys.stderr)

    dur = len(audio) / audio.sample_rate
    rtf = wall / dur if dur > 0 else float("inf")
    print(
        f"Wrote {out_path} ({dur:.2f}s, {n_frames} frames) in {wall:.2f}s (RTF {rtf:.3f})",
        file=sys.stderr,
    )

    if args.metadata:
        meta = {
            "text": args.text,
            "seed": args.seed,
            "num_frames": n_frames,
            "temperature": args.temperature,
            "top_k": args.top_k,
            "top_p": args.top_p,
            "repetition_penalty": args.repetition_penalty,
            "audio_samples": len(audio),
            "sample_rate": audio.sample_rate,
            "rtf": rtf,
        }
        meta_path = out_path.with_suffix(".json")
        meta_path.write_text(json.dumps(meta, indent=2))
        print(f"Wrote {meta_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
