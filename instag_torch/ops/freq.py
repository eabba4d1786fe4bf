"""Frequency (positional) encoding (counterpart of instag_tpu/ops/freq.py):
[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(D-1) x), cos(2^(D-1) x)] per input
dimension."""

from __future__ import annotations

import torch


def freq_encode(x: torch.Tensor, degree: int = 6,
                include_input: bool = True) -> torch.Tensor:
    """[..., D] -> [..., D * (include + 2 degree)]."""
    outs = [x] if include_input else []
    for i in range(degree):
        outs.append(torch.sin((2.0 ** i) * x))
        outs.append(torch.cos((2.0 ** i) * x))
    return torch.cat(outs, dim=-1)


def freq_output_dim(input_dim: int, degree: int = 6,
                    include_input: bool = True) -> int:
    return input_dim * ((1 if include_input else 0) + 2 * degree)
