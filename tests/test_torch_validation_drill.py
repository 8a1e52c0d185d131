"""The port's validation chain end to end on the CPU: ``python -m
qwen3_tts_tpu_torch.validation drill --device cpu`` exits 0 at tiny size
(a seeded checkpoint, the CLI in a process of its own, the quality gate
with the drill's lenient flags, variants, the quant report, the parity
matrix on four CPU ranks), and the entry point refuses an unknown command.
"""

import json

import torch

from qwen3_tts_tpu_torch.validation import __main__ as chain

torch.set_num_threads(1)


def test_drill_on_the_cpu(tmp_path):
    assert chain.main(["drill", "--device", "cpu", "--out", str(tmp_path / "drill")]) == 0
    report = json.loads((tmp_path / "drill" / "parity" / "quant_report.json").read_text())
    assert report["device"] == {"platform": "cpu", "card": "cpu"}
    assert (tmp_path / "drill" / "parity" / "variants" / "report.html").exists()


def test_unknown_command(capsys):
    assert chain.main(["no-such-command"]) == 2
    assert "Commands" in capsys.readouterr().err


