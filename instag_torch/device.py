"""Device resolution for the port's entry points.

Every entry point takes ``device`` (default ``"cuda"``) and passes it
through :func:`resolve_device`, which raises when a CUDA device is asked for
and no card is present — the port never moves work to the CPU on its own.
It also pins float32 matmuls and cuDNN convolutions to full float32: the
cuDNN default (TF32) would round the AudioNet convolutions to ~3 digits.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
