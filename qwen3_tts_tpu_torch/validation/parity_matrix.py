"""Serving-config parity matrix over a loaded checkpoint (the JAX package's
``scripts/parity_matrix.py``).

Drills every serving configuration the server can run -- {solo, mesh} x
{bf16, int8, int8+w8a8} -- through ``Qwen3TTS.from_pretrained`` on one
checkpoint: the checkpoint-loading path (weight maps, sidecar configs,
quantized trees, the tp packs) for each.

Two tiers per column:

  * PRODUCTION tier (bf16, temperature 0.9): every cell must produce valid
    audio (finite, non-empty) -- the serving configuration users run.
  * CROSS-PLACEMENT tier (dtype f32, greedy temperature 0.001): mesh
    frames == solo frames exactly and audio |delta| <= 1e-5, and the w8a8
    batch on the mesh within 1e-5 of solo. Row-parallel products add the
    ranks' partial sums, so logits carry reduction-order noise; f32 and
    greedy is the placement-stable regime. On a real checkpoint greedy gaps
    are wide; compare bf16 placements with the quant report's logit drift,
    not bit equality.

The mesh is dp = 2 x tp = 2 (``parallel.sharding.make_mesh``): four
distinct cards where the machine has them, else four ranks sharing the
first card (``--device cpu``: four CPU ranks); the report says which. A
mesh that cannot be built raises. Each cell's kernel launches are
recorded (an int8 talker at tp = 2 takes kernels 5 and 6 through
``tp_decode_step``), and every failed check is named; the command exits
non-zero when any fails. Part of ``drill``.

    python -m qwen3_tts_tpu_torch.validation parity-matrix --model-dir CKPT [--frames 12]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import card_name, launch_counts, launches_since

DP, TP = 2, 2


def mesh_devices(device: torch.device) -> tuple[list, str]:
    """The mesh's ranks and how they are placed: four distinct cards where
    there are four, else every rank on ``device`` (shared)."""
    if device.type == "cuda" and torch.cuda.device_count() >= DP * TP:
        return [torch.device("cuda", i) for i in range(DP * TP)], "distinct cards"
    return [device] * (DP * TP), f"ranks sharing {device}"


def run(model_dir: str, frames: int = 12, text: str = "parity matrix drill", device: torch.device | str = "cuda",
        log=print) -> dict:
    """The matrix: each cell's launches and, for the cross-placement cells,
    frames equal, their share of codes equal, the first frame that differs
    and the largest audio delta; every check that fails is named in
    ``failures``."""
    from ..parallel import sharding as S
    from ..pipeline import Qwen3TTS, SynthesisOptions

    device = torch.device(device)
    ranks, placement = mesh_devices(device)
    mesh = S.make_mesh(ranks, tp=TP, dp=DP)
    # Production sampling config: per-cell validity.
    opts = SynthesisOptions(max_length=frames, min_new_tokens=frames, seed=42)
    # Greedy: the placement-stable decode for cross-placement equality.
    greedy = SynthesisOptions(max_length=frames, min_new_tokens=frames, seed=42, temperature=0.001)
    texts = [text, text + " second stream"]
    t_start = time.monotonic()
    out = {"device": card_name(device), "mesh": f"dp={DP} x tp={TP} on {placement}: {[str(d) for d in ranks]}",
           "cells": {}, "failures": []}
    log(f"parity matrix: {{solo, mesh}} x {{bf16, int8, w8a8}} on {out['device']}; mesh {out['mesh']}")

    def record(name: str, ok: bool, **cell) -> None:
        out["cells"][name] = {"pass": ok, **cell}
        if not ok:
            out["failures"].append(name)
        log(f"  [{'ok' if ok else 'FAIL'}] {name} {cell} (elapsed {time.monotonic() - t_start:.0f}s)")

    def load(mesh_arg=None, int8=False, w8a8=False, dtype=torch.bfloat16):
        # One model in device memory at a time; each load exercises the full
        # checkpoint path for that serving config.
        return Qwen3TTS.from_pretrained(model_dir, mesh=mesh_arg, quantize_int8=int8, int8_activations=w8a8,
                                        dtype=dtype, device=None if mesh_arg is not None else device)

    def valid(audios) -> bool:
        return all(np.isfinite(a.samples).all() and len(a) > 0 for a in audios)

    def cell(int8: bool, mesh_arg=None):
        """Production-tier validity + f32-greedy frames/audio for the config."""
        m = load(mesh_arg=mesh_arg, int8=int8)
        before = launch_counts()
        ok = valid([m.synthesize_with_voice(texts[0], "ryan", "english", opts)])
        launches = {"production": launches_since(before)}
        del m
        m = load(mesh_arg=mesh_arg, int8=int8, dtype=torch.float32)
        before = launch_counts()
        f = np.asarray(m._custom_voice_session(texts[0], "ryan", "english", greedy).run_to_completion())
        audio = np.asarray(m.decode_codes(f).samples)
        launches["f32_greedy"] = launches_since(before)
        del m
        _free(device)
        return ok, f, audio, launches

    def placed(name: str, solo, meshed, launches) -> None:
        (f_solo, a_solo), (f_mesh, a_mesh) = solo, meshed
        same_shape = f_mesh.shape == f_solo.shape
        differ = np.nonzero((f_mesh != f_solo).any(axis=1))[0] if same_shape else [0]
        delta = float(np.abs(a_mesh - a_solo).max()) if a_mesh.shape == a_solo.shape else float("inf")
        record(name, same_shape and not len(differ) and delta <= 1e-5,
               frames_equal=same_shape and not len(differ),
               share=float((f_mesh == f_solo).mean()) if same_shape else 0.0,
               first_differing_frame=int(differ[0]) if len(differ) else None, audio_delta=delta, launches=launches)

    for form, int8 in (("bf16", False), ("int8", True)):
        ok, f_solo, a_solo, n = cell(int8=int8)
        record(f"{form} solo", ok, launches=n)
        ok, f_mesh, a_mesh, n = cell(int8=int8, mesh_arg=mesh)
        if not ok:
            record(f"{form} mesh production", ok)
        placed(f"{form} mesh == solo (f32 greedy frames; audio atol 1e-5)", (f_solo, a_solo), (f_mesh, a_mesh), n)

    # w8a8 engages in batched programs only (solo decode stays weight-only).
    def w8a8_cell(mesh_arg=None):
        m = load(mesh_arg=mesh_arg, int8=True, w8a8=True)
        before = launch_counts()
        ok = valid(m.synthesize_batch(texts, "ryan", "english", opts))
        launches = {"production": launches_since(before)}
        del m
        m = load(mesh_arg=mesh_arg, int8=True, w8a8=True, dtype=torch.float32)
        before = launch_counts()
        got = [a.samples for a in m.synthesize_batch(texts, "ryan", "english", greedy)]
        launches["f32_greedy"] = launches_since(before)
        del m
        _free(device)
        return ok, got, launches

    ok, b_solo, n = w8a8_cell()
    record("w8a8 batch solo", ok, launches=n)
    ok, b_mesh, n = w8a8_cell(mesh_arg=mesh)
    if not ok:
        record("w8a8 batch mesh production", ok)
    deltas = [float(np.abs(g - w).max()) if g.shape == w.shape else float("inf") for g, w in zip(b_mesh, b_solo)]
    record("w8a8 batch mesh == solo (f32 greedy, atol 1e-5)", max(deltas) <= 1e-5, audio_delta=max(deltas),
           launches=n)

    cells = len(out["cells"])
    log(f"parity matrix {'FAILED: ' + ', '.join(out['failures']) if out['failures'] else 'OK'}: "
        f"{cells - len(out['failures'])}/{cells} cells green in {time.monotonic() - t_start:.0f}s")
    return out


def _free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="validation parity-matrix",
                                 description="{solo, mesh} x {bf16, int8, w8a8} through from_pretrained")
    ap.add_argument("--model-dir", required=True)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--text", default="parity matrix drill")
    ap.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu (default: cuda; no CPU fallback)")
    return ap


def main(argv: list[str] | None = None) -> int:
    from ..utils.device import parse_device

    args = build_parser().parse_args(argv)
    return 1 if run(args.model_dir, args.frames, args.text, parse_device(args.device))["failures"] else 0
