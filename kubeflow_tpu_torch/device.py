"""Device selection: CUDA by default, the CPU only when asked for."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless `device` says
    otherwise. Raises when CUDA is asked for (or defaulted to) and there
    is no GPU: nothing moves to the CPU unasked. `meta` gives shapes
    only, with nothing allocated."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev} (cuda|cpu|meta)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (launcher: "
            "--device cpu) to run on the CPU")
    return dev
