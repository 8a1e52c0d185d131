"""The readings the check's limits are set from, on the card, in one process.

    python3 bench_port/control.py --workload <cell> --seeds 11,12,... --control-seeds 11,12,13 --seconds 15

For each of ``--seeds``: the program as the configuration states it (bfloat16
talker and code predictor, float32 vocoder) through a window of ``--seconds``
at the cell's own load, and every number the check reads
(``harness/check.judge``): the lower readings. For each of
``--control-seeds`` the controls, each in the program's place:

* the program's own int8 path (``Qwen3TTS(quantize_int8=True)``), the
  nearest precision below bfloat16 that the program has: its codes judged as
  the program's are;
* the reference vocoder in TF32, the nearest precision below the vocoder's
  float32: its decode of the bfloat16 run's served codes judged against the
  float32 reference's, as the served audio is;
* in a clone's cell, the reference encoders in TF32, the nearest precision
  below the float32 encoders: their x-vector and reference codes of each
  judged request's clip in place of the served prompt, judged as it is
  (``xvector_err``, ``speech_code_gap_*``).

One JSON line a reading; a control that crashes prints its error and counts
as failed. ``bench_port/tests/test_bench_port_control.py`` runs the controls
on the card and asserts that each fails the cell's limits.
"""

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def tf32_audio_err(dims: dict, seed: int, device, cases: list) -> float:
    """The reference vocoder in TF32 against itself in float32, on the cases'
    served codes: the worst ``audio_err`` over them."""
    import torch

    from bench_port.harness import weights
    from bench_port.reference import qwen3_tts as ref

    _, _, voc = weights.draw(dims, seed, device)
    worst = 0.0
    with torch.no_grad():
        for case in cases:
            codes = torch.from_numpy(case["codes"]).to(device).long()
            ref.strict_f32()
            want = ref.vocoder_decode(voc, dims["vocoder"], codes)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            got = ref.vocoder_decode(voc, dims["vocoder"], codes)
            ref.strict_f32()
            worst = max(worst, float((got - want).abs().max() / want.abs().max().clamp(min=1e-30)))
    return worst


def tf32_encoder_readings(dims: dict, seed: int, device, cases: list) -> dict:
    """The reference encoders in TF32 in the program's place: the clone
    prompts' readings (``check.encoder_readings``) of their x-vectors and
    codes of the cases' clips; {} where no case is a clone."""
    import torch

    from bench_port.harness import check, weights
    from bench_port.reference import encoders as ref_enc
    from bench_port.reference import qwen3_tts as ref

    enc = weights.draw_encoders(dims, seed, device)
    swapped = []
    with torch.no_grad():
        for case in cases:
            if "clip" not in case:
                continue
            clip = torch.from_numpy(case["clip"]).to(device)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                xvector = ref_enc.speaker_xvector(enc["speaker_encoder"], dims["speaker_encoder"], clip)
                codes = None
                if case["ref_codes"] is not None:
                    codes = ref_enc.speech_codes(enc["speech_encoder"], dims["speech_encoder"], clip).cpu().numpy()
            finally:
                ref.strict_f32()
            swapped.append(dict(case, xvector=xvector.cpu().numpy(), ref_codes=codes))
        return check.encoder_readings(dims, enc, device, swapped)[1]


def readings(spec, seed: int, seconds: float, device, int8: bool) -> tuple[dict, list]:
    from bench_port.harness import cell, check

    record, cases, _ = cell.measure(spec, seed, seconds, False, device, time.perf_counter(), quantize_int8=int8)
    got = check.judge(record.dims, seed, device, cases) if cases else {}
    got.update(requests=len(record.done), judged=len(cases), frames=sum(len(c["codes"]) for c in cases))
    return got, cases


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port.harness import spec

    if not torch.cuda.is_available():
        print("the controls run on a CUDA card", file=sys.stderr)
        return 2
    s = spec.load(args.workload, ROOT)
    dev = torch.device("cuda:0")

    def seeds(text):
        return [int(x) for x in text.split(",") if x]

    controls = set(seeds(args.control_seeds))
    for seed in sorted(set(seeds(args.seeds)) | controls, key=lambda x: (x not in controls, x)):
        got, cases = readings(s, seed, args.seconds, dev, False)
        print(json.dumps({"cell": args.workload, "seed": seed, "run": "program", **got}), flush=True)
        if seed not in controls:
            continue
        try:
            out = {"audio_err": tf32_audio_err(s.dims, seed, dev, cases)}
        except Exception:  # a control that crashes has failed
            out = {"error": traceback.format_exc()}
        print(json.dumps({"cell": args.workload, "seed": seed, "run": "control_vocoder_tf32", **out}), flush=True)
        if any("clip" in case for case in cases):
            try:
                out = tf32_encoder_readings(s.dims, seed, dev, cases)
            except Exception:
                out = {"error": traceback.format_exc()}
            print(json.dumps({"cell": args.workload, "seed": seed, "run": "control_encoders_tf32", **out}), flush=True)
        try:
            out, _ = readings(s, seed, args.seconds, dev, True)
        except Exception:
            out = {"error": traceback.format_exc()}
        print(json.dumps({"cell": args.workload, "seed": seed, "run": "control_int8", **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
