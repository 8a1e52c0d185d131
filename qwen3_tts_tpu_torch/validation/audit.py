"""Host-read audit of the frame loops (the JAX package's
``scripts/audit_host_syncs.py``).

Two checks:

1. Static: list the device -> host read sites in the modules a frame runs
   through (``.item()``, ``.tolist()``, ``.numpy()``, ``.cpu()``, and
   ``bool`` / ``int`` / ``float`` of the loop's state or of a reduction),
   each with the function it is in. The loop contract (``generation/core.py``)
   allows the sites of ``ALLOWED``; any other fails the audit.
2. Dynamic: run a short generation of a tiny model, weight-only int8 and
   not, under ``profiling.count_host_transfers``: one loop call of
   ``frames`` frames makes at most ``loop_read_bound(frames)`` host reads.

    python -m qwen3_tts_tpu_torch.validation audit [--device cpu] [--frames 8]
"""

from __future__ import annotations

import argparse
import ast
import math
import re
from pathlib import Path

import torch

from ..generation import core

PACKAGE = Path(__file__).resolve().parent.parent
LOOP_MODULES = (
    "generation/core.py",
    "models/talker.py",
    "models/code_predictor.py",
    "ops/sampling.py",
    "ops/rows.py",
    "ops/nn.py",
    "ops/quant.py",
    "ops/fused_layer.py",
    "parallel/collectives.py",
)
PATTERNS = [
    (re.compile(r"\.item\("), "value read .item()"),
    (re.compile(r"\.tolist\("), "value read .tolist()"),
    (re.compile(r"\.numpy\("), "value read .numpy()"),
    (re.compile(r"\.cpu\("), "copy to the host .cpu()"),
    (re.compile(r"(?<![\w.])(?:int|float|bool)\(\s*(?:self\.)?(?:run\.)?state\."), "scalar read of the loop state"),
    (re.compile(r"(?<![\w.])(?:int|float|bool)\([^()]*\.(?:any|all|sum|max|min)\(\)\)"),
     "scalar read of a reduction"),
]
# The read sites the loop contract allows, by (module, function).
ALLOWED = {
    ("generation/core.py", "_FlagReader.read"):
        "the look at the stop flags: on entry and every DONE_READ_EVERY frames, one read for the group",
    ("generation/core.py", "generate_frames"):
        "the debug path (on_frame given) reads done before every frame",
    ("models/code_predictor.py", "predict_acoustic_codes_jacobi_batch"):
        "Jacobi: one read a pass (its pass count depends on the data)",
    ("ops/fused_layer.py", "_phase_sums"): "a traced kernel's stamps (trace=True), read after the launch",
}


def loop_read_bound(frames: int) -> int:
    """The contract's most host reads a loop call of ``frames`` frames: a look
    on entry, one every ``core.DONE_READ_EVERY`` frames, and one more."""
    return math.ceil(frames / core.DONE_READ_EVERY) + 2


def _functions(tree: ast.AST) -> list[tuple[int, int, str]]:
    """(first line, last line, qualified name) of every function in a module."""
    out = []

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                name = f"{prefix}{child.name}"
                if not isinstance(child, ast.ClassDef):
                    out.append((child.lineno, child.end_lineno, name))
                walk(child, name + ".")
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


def read_sites(modules=LOOP_MODULES) -> list[dict]:
    """Every read site in ``modules``: module, line, function (the innermost
    one around it), label and source line."""
    sites = []
    for rel in modules:
        source = (PACKAGE / rel).read_text()
        functions = _functions(ast.parse(source))
        for lineno, line in enumerate(source.splitlines(), 1):
            code = line.split("#", 1)[0]
            for pat, label in PATTERNS:
                if pat.search(code):
                    inside = [f for f in functions if f[0] <= lineno <= f[1]]
                    fn = max(inside, key=lambda f: f[0])[2] if inside else "<module>"
                    sites.append({"module": rel, "line": lineno, "function": fn, "label": label,
                                  "source": line.strip()})
    return sites


def static_audit() -> list[dict]:
    """Print every read site with the reason the contract allows it; returns
    the sites it does not allow."""
    sites = read_sites()
    for s in sites:
        why = ALLOWED.get((s["module"], s["function"]), "NOT ALLOWED by the loop contract")
        print(f"{s['module']}:{s['line']} ({s['function']}): [{s['label']}] {s['source']}  <- {why}")
    bad = [s for s in sites if (s["module"], s["function"]) not in ALLOWED]
    print(f"\n{len(sites)} read sites in {len(LOOP_MODULES)} frame-loop modules, {len(bad)} outside the contract")
    return bad


class _WordIds:
    def encode(self, text: str) -> list[int]:
        return [5 + len(w) % 7 for w in text.split()] or [5]


def tiny_model(device: torch.device, quantize_int8: bool = False):
    """The tiny CustomVoice model (``validation.tiny_config``) from the port's
    seeded init, with the tiny vocoder."""
    from ..models import weights as W
    from ..models.codec import vocoder
    from ..pipeline import Qwen3TTS
    from . import tiny_config, tiny_vocoder

    cfg, vcfg = tiny_config(), tiny_vocoder()
    gen = torch.Generator(device=device).manual_seed(0)
    return Qwen3TTS(cfg, W.init_talker_params(gen, cfg.talker, torch.float32),
                    W.init_code_predictor_params(gen, cfg.code_predictor, torch.float32),
                    vocoder.init_vocoder_params(gen, vcfg), _WordIds(), vocoder_config=vcfg,
                    quantize_int8=quantize_int8)


def loop_reads(model, frames: int) -> int:
    """The host reads of one loop call of ``frames`` frames, the prefill and
    the prompt outside it (a staged session's ``_advance``)."""
    from ..pipeline import SynthesisOptions
    from ..profiling import count_host_transfers

    opts = SynthesisOptions(max_length=frames, min_new_tokens=frames, seed=42)
    session = model._custom_voice_session("audit of the loop", "ryan", "english", opts)
    _, reads = count_host_transfers(session._advance, frames)
    if session.frames_generated != frames:
        raise AssertionError(f"audit: {session.frames_generated} frames made, want {frames}")
    return reads


def dynamic_audit(device: torch.device, frames: int = 8) -> dict:
    """Host reads of one loop call of ``frames`` frames on a tiny model in f32
    and in weight-only int8, each within ``loop_read_bound``."""
    bound = loop_read_bound(frames)
    reads = {}
    for name, int8 in (("f32", False), ("int8", True)):
        reads[name] = loop_reads(tiny_model(device, quantize_int8=int8), frames)
        print(f"dynamic audit ({name}, {device}): {reads[name]} host reads in a loop call of {frames} frames "
              f"(bound ceil({frames} / {core.DONE_READ_EVERY}) + 2 = {bound})")
    over = {k: n for k, n in reads.items() if n > bound}
    if over:
        raise AssertionError(f"audit: the frame loop made {over} host reads, bound {bound}")
    return reads


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="validation audit", description="Host-read audit of the frame loops")
    ap.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu (default: cuda; no CPU fallback)")
    ap.add_argument("--frames", type=int, default=8)
    return ap


def main(argv: list[str] | None = None) -> int:
    from ..utils.device import parse_device

    args = build_parser().parse_args(argv)
    device = parse_device(args.device)
    bad = static_audit()
    print()
    dynamic_audit(device, args.frames)
    return 1 if bad else 0
