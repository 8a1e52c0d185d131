"""What one run measures, read from ``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix. The configuration's file is
the ``file`` of its ``configs`` entry; the traffic mix is
``bench_port/traffic/<traffic>.json``; each metric is read by
``bench_port/metrics/<name>.py``; the limits of the cell's check are in
``bench_port/limits/<cell>.json``. A later cell, mix or metric is new files
and new entries, never an edit of these: a configuration of any of the three
published model types (``tts_model_type``), and a mix of any of the four
prompt layouts (``harness/traffic.py``), are data.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Spec:
    root: Path  # the checkout
    cell: dict  # the BENCHMARK.json workload entry
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    end_to_end: list  # this cell's end-to-end metric entries
    per_layer: list  # this cell's per-layer metric entries
    limits: dict  # the check's limits, or {} where the cell has none yet

    @property
    def dims(self) -> dict:
        """The widths the harness builds from (see ``dims``)."""
        return dims(self.config)


MODEL_TYPES = ("custom_voice", "base", "voice_design")


def dims(config: dict) -> dict:
    """A configuration file's widths as the harness and the reference read
    them: ``talker`` and ``code_predictor`` (the HF ``talker_config`` keys,
    the code predictor's nested inside it there), ``vocoder``, ``dtype``,
    the talker's ``mrope_section``, the ``model_size`` tag, the
    ``model_type`` (``tts_model_type``: ``custom_voice``, the default,
    ``base`` or ``voice_design``) and, where the file declares them, a Base
    model's ``speaker_encoder`` (the published ``speaker_encoder_config``)
    and ``speech_encoder`` (the speech tokenizer's ``encoder_config``)."""
    t = dict(config["talker_config"])
    c = t.pop("code_predictor_config")
    mrope = (t.pop("rope_scaling", None) or {}).get("mrope_section")
    model_type = config.get("tts_model_type", "custom_voice")
    if model_type not in MODEL_TYPES:
        raise ValueError(f"tts_model_type {model_type!r} is none of {MODEL_TYPES}")
    return {"talker": t, "code_predictor": c, "vocoder": dict(config["vocoder"]), "dtype": config["dtype"],
            "mrope_section": mrope, "model_size": config.get("tts_model_size", "custom"), "model_type": model_type,
            "speaker_encoder": config.get("speaker_encoder_config"), "speech_encoder": config.get("encoder_config")}


def downsample_stride(encoder: dict) -> int:
    """The speech encoder's last stride (``encoder_config``): its SEANet's
    frame rate over the codes' (24000 / 960 Hz over 12.5 Hz: 2)."""
    return round(encoder["sampling_rate"] / math.prod(encoder["upsampling_ratios"]) / encoder["frame_rate"])


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(cell_name: str, root: Path | None = None) -> Spec:
    root = Path(root) if root is not None else BENCH_DIR.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"unknown workload {cell_name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((root / "bench_port" / "traffic" / f"{cell['traffic']}.json").read_text())
    limits_file = root / "bench_port" / "limits" / f"{cell_name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return Spec(root, cell, config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, cell_name)],
                [m for m in bench["per_layer"] if _applies(m, cell_name)],
                limits)
