"""How ``correct`` is decided: the served codes and audio of a sample of greedy requests against the plain reference.

Once the window has closed and the program is freed, a sample of the greedy
requests it finished (the longest of them, and others drawn from the seed)
goes to ``bench_port/reference``: the weights drawn again from the seed, the
reference runs once over each request's prompt and served codes in float32,
and these numbers are read, the worst over the sample:

* ``talker_gap_mean``: the mean over every frame judged of how far the served
  semantic code's logit lies below the reference's best, both after the
  repetition penalty the request ran under (the prefill and every decode
  step: kernel 3 and the layer path);
* ``cp_gap_mean``: the same over the 15 acoustic codes of every frame
  (kernel 1, which reads the talker's hidden state);
* ``code_gap_mean``: the same over all 16 codes of every frame;
* ``audio_err``: the served audio's largest difference from the reference's
  decode of the served codes (behind a clone's reference codes, whose
  samples are cut), over its largest sample (the vocoder: kernel 2 and the
  plain units);
* for a clone, its prompt: ``xvector_err``, the largest difference of the
  served x-vector from the reference speaker encoder's on the same clip,
  over the reference's largest value; and for an in-context clone
  ``speech_code_gap_mean`` (``_max``, ``_miss``): at each stage of the
  speech encoder's residual quantisers, how much farther the served code's
  codeword lies from the reference's residual than the nearest codeword
  does, over that residual's norm, the earlier stages teacher-forced with
  the served codes (``reference/encoders.py``); where a penalty was in
  force, ``penalty_moved_share``, the share of semantic positions at which
  it moved the reference's best (printed, never a limit's: it says whether
  the penalty's rule was exercised).

The prompt a clone's codes are judged after is built from the reference's
own x-vector and the served reference codes: its encoders are judged by
their own numbers, and a code that flips at a near-tie in the speech
encoder would otherwise move every row after it.

The numbers that ``bench_port/limits/<cell>.json`` names are held to its
limits; the widest gaps and the shares of codes that are not the
reference's best are printed beside them. A mean over every position, not
the widest gap: the program's widest gaps come within 2x of the control's,
where the means stand 3.3-5.4x apart (``PERF.md``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import encoders as ref_enc
from ..reference import qwen3_tts as ref
from . import traffic, weights


def sample(done: list, seed: int, count: int) -> list:
    """The greedy (request, served) pairs to judge: the longest (the first of
    equals) and ``count`` - 1 others drawn from the seed."""
    greedy = [(r, s) for r, s in done if s.codes is not None and s.error is None]
    if not greedy:
        return []
    longest = max(range(len(greedy)), key=lambda i: (greedy[i][1].frames, -i))
    rest = [i for i in range(len(greedy)) if i != longest]
    rng = np.random.default_rng(seed)
    picked = [longest] + [rest[i] for i in rng.permutation(len(rest))[: max(count - 1, 0)]]
    return [greedy[i] for i in picked]


def take(picked: list, voices: list | None = None, mix: dict | None = None) -> list:
    """The picked requests' inputs and served output, moved to the host so
    that the program's memory can go: with a clone's, its voice's clip and
    transcript (``voices``, the mix's) and the prompt it served."""
    mix = mix or {}
    cases = []
    for r, s in picked:
        case = {"prompt": r.prompt, "text_ids": r.text_ids, "lang_id": r.lang_id,
                "codes": s.codes[: s.frames].cpu().numpy(),
                "audio": np.concatenate(s.audio) if s.audio else np.zeros(0, np.float32)}
        if r.prompt == "preset":
            case["speaker_id"] = r.speaker_id
        elif r.prompt == "design":
            case["instruct_ids"] = traffic.instruct_ids(r.instruct)
        else:
            voice = voices[r.voice]
            case.update(voice=r.voice, clip=voice.samples, ref_text_ids=voice.ref_text_ids, xvector=s.xvector,
                        ref_codes=s.ref_codes, sequential=bool(mix.get("icl_sequential")))
        cases.append(case)
    return cases


def _clone_prompt(case: dict, talker: dict, cp: dict, xvector: torch.Tensor, device) -> tuple:
    """(prompt rows, trailing text ids, reference codes or None) of a clone,
    from the reference's x-vector and the served reference codes."""
    if case["prompt"] == "xvector":
        return ref.xvector_prompt(talker, case["text_ids"], xvector, case["lang_id"]), \
            ref.trailing_text(case["text_ids"]), None
    prefix = torch.from_numpy(np.asarray(case["ref_codes"], np.int64)).to(device)
    rows, trailing = ref.icl_prompt(talker, cp, case["text_ids"], case["ref_text_ids"], xvector, prefix,
                                    case["lang_id"], case["sequential"])
    return rows, trailing, prefix


def encoder_readings(dims: dict, enc: dict, device, cases: list) -> tuple[dict, dict]:
    """The clones' prompts judged: ({voice: the reference's x-vector},
    {``xvector_err``, ``speech_code_gap_*``})."""
    xvectors, xerr, gaps = {}, 0.0, []
    for case in cases:
        if "clip" not in case:
            continue
        clip = torch.from_numpy(case["clip"]).to(device)
        if case["voice"] not in xvectors:
            xvectors[case["voice"]] = ref_enc.speaker_xvector(enc["speaker_encoder"], dims["speaker_encoder"], clip)
        want = xvectors[case["voice"]]
        got = torch.from_numpy(np.asarray(case["xvector"], np.float32)).to(device)
        xerr = max(xerr, float((got - want).abs().max() / want.abs().max().clamp(min=1e-30)))
        if case["ref_codes"] is not None:
            found = ref_enc.speech_code_gaps(enc["speech_encoder"], dims["speech_encoder"], clip,
                                             torch.from_numpy(np.asarray(case["ref_codes"], np.int64)).to(device))
            gaps.append(found.flatten() if found is not None else torch.full((1,), float("inf"), device=device))
    if not xvectors:
        return {}, {}
    out = {"xvector_err": xerr}
    if gaps:
        g = torch.cat(gaps)
        out.update(speech_code_gap_mean=float(g.mean()), speech_code_gap_max=float(g.max()),
                   speech_code_gap_miss=float((g > 0).float().mean()))
    return xvectors, out


@torch.no_grad()
def judge(dims: dict, seed: int, device, cases: list) -> dict:
    """The reference's readings over ``cases``: for the talker's and the code
    predictor's codes the mean and the widest gap over every position judged,
    and the share of positions whose served code is not the reference's best;
    the worst ``audio_err``; for clones, their prompts' readings."""
    ref.strict_f32()
    talker, cp, voc = weights.draw(dims, seed, device)
    xvectors, out = encoder_readings(dims, weights.draw_encoders(dims, seed, device), device, cases)
    rdims = {"talker": dims["talker"], "code_predictor": dims["code_predictor"], "vocoder": dims["vocoder"]}
    gaps = {"talker": [], "cp": []}
    moved = []  # where a penalty was in force: did it move the reference's best?
    audio_err = 0.0
    for case in cases:
        codes = torch.from_numpy(case["codes"]).to(device)
        audio = torch.from_numpy(case["audio"]).to(device)
        prefix, penalty = None, 1.0
        if case["prompt"] == "preset":
            prompt = ref.custom_voice_prompt(talker, case["text_ids"], case["speaker_id"], case["lang_id"])
            trailing = ref.trailing_text(case["text_ids"])
        elif case["prompt"] == "design":
            prompt = ref.design_prompt(talker, case["text_ids"], case["instruct_ids"], case["lang_id"])
            trailing = ref.trailing_text(case["text_ids"])
        else:
            prompt, trailing, prefix = _clone_prompt(case, talker, cp, xvectors[case["voice"]], device)
            penalty = ref.served_penalty(1.0, case["prompt"] == "icl")
        got = ref.judge_request(talker, cp, voc, rdims, prompt, trailing, codes, audio, penalty, prefix)
        if penalty != 1.0:
            moved.append(got["penalty_moved"])
        gaps["talker"].append(got["talker_gaps"].flatten())
        gaps["cp"].append(got["cp_gaps"].flatten())
        audio_err = max(audio_err, got["audio_err"])
    out["audio_err"] = audio_err
    for part, found in gaps.items():
        g = torch.cat(found)
        out.update({f"{part}_gap_mean": float(g.mean()), f"{part}_gap_max": float(g.max()),
                    f"{part}_miss": float((g > 0).float().mean())})
    if moved:
        out["penalty_moved_share"] = float(torch.cat(moved).float().mean())
    # All 16 codes of every frame: one semantic and 15 acoustic positions.
    frames = sum(len(t) for t in gaps["talker"])
    out["code_gap_mean"] = (out["talker_gap_mean"] + 15 * out["cp_gap_mean"]) / 16 if frames else 0.0
    return out


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every number the cell's limits name within its limit, {name: {"value",
    "limit"}}). A cell with no limits, or a number with no reading, fails."""
    compared = {k: {"value": readings.get(k), "limit": v["limit"]} for k, v in limits.items()}
    ok = bool(compared) and all(c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
