"""Per-frame debug generation: the forensic view for cross-implementation diffs.

The port's counterpart of ``qwen3_tts_tpu/generation/debug.py``. The JAX
version replays the frame body with the plain ops outside its while loop;
here ``debug_generate`` drives the session's own loop
(``core.generate_frames``, with the model's kernel packs on the card)
through its ``on_frame`` callback, so the token stream is the production
loop's by construction: on the card the kernels' bf16 codes are not those
of a plain-op replay. Each frame records the semantic token, the 15
acoustic codes and the top post-penalty logits.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FrameDebug:
    frame: int
    semantic_token: int
    codes: np.ndarray  # [15] int32
    top_ids: np.ndarray  # [top] int32, post-penalty logits descending
    top_logits: np.ndarray  # [top] float32


@dataclass
class DebugTrace:
    frames: list[FrameDebug] = field(default_factory=list)

    def code_matrix(self) -> np.ndarray:
        """[T, 16] int32, the production frames buffer's layout."""
        if not self.frames:
            return np.zeros((0, 16), np.int32)
        return np.stack([np.concatenate([[f.semantic_token], f.codes]) for f in self.frames]).astype(np.int32)


def debug_generate(model, session, top: int = 5) -> DebugTrace:
    """Run a fresh ``StreamingSession`` to its end (``run_to_completion``),
    recording every frame. ``session`` must be unadvanced
    (``frames_emitted == 0``); it is exhausted afterwards. ``model`` is the
    session's (kept for the JAX package's signature)."""
    if session.frames_emitted:
        raise ValueError("debug_generate needs an unadvanced session")
    trace = DebugTrace()

    def record(idx, token, codes, logits):
        logits_np = logits[0].float().cpu().numpy()
        order = np.argsort(-logits_np)[:top]
        trace.frames.append(FrameDebug(
            frame=idx,
            semantic_token=int(token),
            codes=codes.to("cpu").numpy().astype(np.int32),
            top_ids=order.astype(np.int32),
            top_logits=logits_np[order],
        ))

    session.on_frame = record
    try:
        session.run_to_completion()
    finally:
        session.on_frame = None
    return trace


def first_divergence(ours: np.ndarray, ref: np.ndarray) -> dict | None:
    """Locate the first divergent frame between two [T, 16] code matrices.

    Returns None when the overlapping frames agree and the lengths match,
    else a dict naming the frame, the stage (semantic = talker sampling;
    acoustic group g = code predictor head g), and both rows.
    """
    n = min(len(ours), len(ref))
    for i in range(n):
        if not np.array_equal(ours[i], ref[i]):
            groups = np.nonzero(ours[i] != ref[i])[0]
            stage = ("semantic (talker sampling)" if groups[0] == 0
                     else f"acoustic group {int(groups[0])} (code predictor)")
            return {
                "frame": i,
                "stage": stage,
                "divergent_groups": groups.tolist(),
                "ours": ours[i].tolist(),
                "ref": ref[i].tolist(),
            }
    if len(ours) != len(ref):
        return {
            "frame": n,
            "stage": f"length (ours {len(ours)} vs ref {len(ref)} frames)",
            "divergent_groups": [],
            "ours": [],
            "ref": [],
        }
    return None
