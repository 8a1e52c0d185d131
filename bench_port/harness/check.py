"""How ``correct`` is decided: the served codes and audio of a sample of greedy requests against the plain reference.

Once the window has closed and the program is freed, a sample of the greedy
requests it finished (the longest of them, and others drawn from the seed)
goes to ``bench_port/reference``: the weights drawn again from the seed, the
reference runs once over each request's prompt and served codes in float32,
and three numbers are read, the worst over the sample:

* ``talker_gap_mean``: the mean over every frame judged of how far the served
  semantic code's logit lies below the reference's best (the prefill and
  every decode step: kernel 3 and the layer path);
* ``cp_gap_mean``: the same over the 15 acoustic codes of every frame
  (kernel 1, which reads the talker's hidden state);
* ``code_gap_mean``: the same over all 16 codes of every frame;
* ``audio_err``: the served audio's largest difference from the reference's
  decode of the served codes, over its largest sample (the vocoder: kernel 2
  and the plain units).

The numbers that ``bench_port/limits/<cell>.json`` names are held to its
limits; the widest gaps and the shares of codes that are not the
reference's best are printed beside them. A mean over every position, not
the widest gap: the program's widest gaps come within 2x of the control's,
where the means stand 3.3-5.4x apart (``PERF.md``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import qwen3_tts as ref
from . import weights



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


def take(picked: list) -> list:
    """The picked requests' inputs and served output, moved to the host so
    that the program's memory can go."""
    return [{"text_ids": r.text_ids, "speaker_id": r.speaker_id, "lang_id": r.lang_id,
             "codes": s.codes[: s.frames].cpu().numpy(),
             "audio": np.concatenate(s.audio) if s.audio else np.zeros(0, np.float32)} for r, s in picked]


@torch.no_grad()
def judge(dims: dict, seed: int, device, cases: list) -> dict:
    """The reference's readings over ``cases``: for the talker's and the code
    predictor's codes the mean and the widest gap over every position judged,
    and the share of positions whose served code is not the reference's best;
    the worst ``audio_err``."""
    ref.strict_f32()
    talker, cp, voc = weights.draw(dims, seed, device)
    rdims = {"talker": dims["talker"], "code_predictor": dims["code_predictor"], "vocoder": dims["vocoder"]}
    gaps = {"talker": [], "cp": []}
    audio_err = 0.0
    for case in cases:
        codes = torch.from_numpy(case["codes"]).to(device)
        audio = torch.from_numpy(case["audio"]).to(device)
        got = ref.judge_request(talker, cp, voc, rdims, case["text_ids"], case["speaker_id"], case["lang_id"],
                                codes, audio)
        gaps["talker"].append(got["talker_gaps"].flatten())
        gaps["cp"].append(got["cp_gaps"].flatten())
        audio_err = max(audio_err, got["audio_err"])
    out = {"audio_err": audio_err}
    for part, found in gaps.items():
        g = torch.cat(found)
        out.update({f"{part}_gap_mean": float(g.mean()), f"{part}_gap_max": float(g.max()),
                    f"{part}_miss": float((g > 0).float().mean())})
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
