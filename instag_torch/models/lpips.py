"""LPIPS perceptual distance with an AlexNet backbone (counterpart of
instag_tpu/models/lpips.py).

AlexNet's five convolutions, each followed by a ReLU whose output is a tap,
with a 3x3 stride-2 max-pool (no padding, floored) after taps 0 and 1; the
input is shifted and scaled by the LPIPS constants first. Each tap is
normalised over its channels (rsqrt with 1e-10 inside, so that a pixel
whose channels are all 0 has a finite gradient); the squared difference of
the two images' taps is weighted per channel by ``|lin_i|``, summed over
channels, averaged over the pixels, and summed over the taps.

The module and parameter names follow the flax modules (``alex.conv_i``,
``lin_i``), so ``io.from_jax.lpips_state_dict`` carries a flax tree across.

Weights: ``load_lpips_params`` reads converted AlexNet-LPIPS weights from
``INSTAG_LPIPS_WEIGHTS`` or ``weights/lpips_alex.npz`` (the JAX package's
layout: HWIO kernels). Without them it falls back, with a loud warning, to
fixed-seed He-initialised features and uniform 1/C calibration, and says so
through its ``real`` flag: such distances keep the metric's multi-scale
structure but are not comparable to published LPIPS numbers.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from ..device import resolve_device

# (out_channels, kernel, stride, pad) of AlexNet's features
_ALEX = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_MAXPOOL_AFTER = (0, 1)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class AlexFeatures(nn.Module):
    """``x`` [B, 3, H, W] in [-1, 1] -> the five taps [B, C_i, H_i, W_i]."""

    def __init__(self):
        super().__init__()
        c_in = 3
        for i, (c, k, s, p) in enumerate(_ALEX):
            self.add_module(f"conv_{i}", nn.Conv2d(c_in, c, k, s, p))
            c_in = c
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None,
                                                           None],
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None,
                                                           None],
                             persistent=False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = (x - self.shift) / self.scale
        taps = []
        for i in range(len(_ALEX)):
            x = Fn.relu(getattr(self, f"conv_{i}")(x))
            taps.append(x)
            if i in _MAXPOOL_AFTER:
                x = Fn.max_pool2d(x, 3, 2)
        return taps


class LPIPS(nn.Module):
    """``(img0, img1)`` [B, 3, H, W] in [-1, 1] -> [B] distances."""

    def __init__(self):
        super().__init__()
        self.alex = AlexFeatures()
        for i, (c, *_) in enumerate(_ALEX):
            self.register_parameter(f"lin_{i}",
                                    nn.Parameter(torch.full((c,), 1.0 / c)))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        b = img0.shape[0]
        taps = self.alex(torch.cat([img0, img1]))
        total = img0.new_zeros((b,))
        for i, t in enumerate(taps):
            t = t * torch.rsqrt((t * t).sum(1, keepdim=True) + 1e-10)
            d = (t[:b] - t[b:]) ** 2
            w = getattr(self, f"lin_{i}").abs()
            total = total + (d * w[None, :, None, None]).sum(1).mean((1, 2))
        return total


_warned_fallback = False


def load_lpips_params(rng_seed: int = 0,
                      device: str | torch.device = "cuda"
                      ) -> tuple[LPIPS, bool]:
    """The LPIPS model on ``device``, frozen (no parameter takes a
    gradient), and whether it holds converted AlexNet-LPIPS weights
    (``real``). The weights come from ``INSTAG_LPIPS_WEIGHTS`` or
    ``weights/lpips_alex.npz`` (``conv_i_w`` [K, K, I, O], ``conv_i_b``,
    ``lin_i``); without them the features start from
    ``torch.Generator().manual_seed(rng_seed)`` and a warning says once
    that the distances are random-feature ones."""
    dev = resolve_device(device)
    model = LPIPS()
    path = os.environ.get("INSTAG_LPIPS_WEIGHTS", "weights/lpips_alex.npz")
    real = os.path.exists(path)
    if real:
        data = np.load(path)
        sd = {}
        for i in range(len(_ALEX)):
            sd[f"alex.conv_{i}.weight"] = torch.from_numpy(np.ascontiguousarray(
                data[f"conv_{i}_w"].transpose(3, 2, 0, 1), np.float32))
            sd[f"alex.conv_{i}.bias"] = torch.from_numpy(
                np.asarray(data[f"conv_{i}_b"], np.float32))
            sd[f"lin_{i}"] = torch.from_numpy(
                np.asarray(data[f"lin_{i}"], np.float32).reshape(-1))
        model.load_state_dict(sd, strict=True)
    else:
        gen = torch.Generator().manual_seed(rng_seed)
        with torch.no_grad():
            for i in range(len(_ALEX)):
                conv = getattr(model.alex, f"conv_{i}")
                fan_in = conv.weight[0].numel()
                conv.weight.copy_(torch.randn(conv.weight.shape,
                                              generator=gen)
                                  * (2.0 / fan_in) ** 0.5)
                conv.bias.zero_()
        global _warned_fallback
        if not _warned_fallback:
            _warned_fallback = True
            warnings.warn(
                f"LPIPS: no converted AlexNet weights at '{path}' - falling "
                "back to FIXED-SEED RANDOM FEATURES. Perceptual-loss "
                "training still works but LPIPS values are not comparable "
                "to published numbers (real=False). Provide the weights "
                "through INSTAG_LPIPS_WEIGHTS.", stacklevel=2)
    return model.requires_grad_(False).eval().to(dev), real
