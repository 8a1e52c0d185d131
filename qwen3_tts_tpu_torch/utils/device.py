"""Device helpers: the port's counterparts of ``qwen3_tts_tpu/utils/device.py``
for PyTorch devices. ``auto`` is the CUDA card; nothing here falls back to
the CPU, which is used only when asked for by name."""

from __future__ import annotations

import torch


def device_or_card(device: torch.device | str | None) -> torch.device:
    """``device``, or the CUDA card when it is None; raises when there is no
    card rather than falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to build on the CPU")
    return torch.device("cuda")


def auto_device() -> torch.device:
    """The best device: CUDA card 0. Raises when there is no card; it never
    falls back to the CPU (which is used only when asked for by name)."""
    return parse_device("cuda")


def parse_device(spec: str) -> torch.device:
    """Resolve "auto" | "cuda" | "cuda:N" | "cpu" to a torch device; "auto"
    and "cuda" mean card 0. A card that is not there raises."""
    spec = spec.strip().lower()
    if spec == "cpu":
        return torch.device("cpu")
    if spec == "auto":
        return auto_device()
    if spec == "cuda" or spec.startswith("cuda:"):
        idx = 0
        if ":" in spec:
            tail = spec.split(":", 1)[1]
            if not tail.isdigit():
                raise ValueError(f"bad device index in '{spec}'")
            idx = int(tail)
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for '{spec}'; pass 'cpu' to run on the CPU")
        if idx >= torch.cuda.device_count():
            raise ValueError(f"no CUDA device {idx}: {torch.cuda.device_count()} present")
        return torch.device("cuda", idx)
    raise ValueError(f"unknown device '{spec}'. Supported: auto, cpu, cuda, cuda:N")


def device_info(device: torch.device | str | None = None) -> str:
    """"cuda:0 (NVIDIA H100 80GB HBM3)" or "cpu"."""
    device = torch.device(device) if device is not None else parse_device("auto")
    if device.type == "cuda":
        idx = device.index or 0
        return f"cuda:{idx} ({torch.cuda.get_device_name(idx)})"
    return device.type


def sync_device(x: torch.Tensor | None = None) -> None:
    """Block until the device's queued work is done (timing boundaries): the
    device of ``x``, or every card when ``x`` is None."""
    if x is not None:
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    elif torch.cuda.is_available():
        torch.cuda.synchronize()
