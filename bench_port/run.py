"""Runs one cell of the benchmark of ``qwen3_tts_tpu_torch`` once, on the NVIDIA card of this machine.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, metrics
and limits are found by name from ``BENCHMARK.json`` (``harness/spec.py``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or its
per-layer ones with ``--trace 1``), ``device`` and, traced, ``breakdown``;
its last key, ``compared``, gives each number the check compared beside its
limit, as do the last lines of standard error. Without a CUDA card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
once the window has closed, it exits with another code than 0 and prints no
result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # Kernel caches stay in the checkout, at fixed paths; no library may load
    # JAX behind the program's back.
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    from bench_port.harness import cell, spec

    s = spec.load(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < s.cell["chips"]:
        print(f"{args.workload} needs {s.cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line, notes = cell.run(s, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    loaded = cell.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for note in notes:
        print(note, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
