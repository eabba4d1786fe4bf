"""General math utilities (counterpart of instag_tpu/utils/general.py)."""

from __future__ import annotations

import math

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0,
             max_steps: int = 1000000) -> torch.Tensor:
    """Log-linear learning-rate interpolation with an optional warm-up dip,
    as a float32 0-d tensor; 0 when ``lr_init`` is 0 or ``step`` lies
    outside [0, max_steps]."""
    step = torch.as_tensor(step, dtype=torch.float32)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(math.log(max(lr_init, 1e-32)) * (1 - t)
                         + math.log(max(lr_final, 1e-32)) * t)
    lr = delay_rate * log_lerp
    valid = (step >= 0) & (step <= max_steps) & (lr_init > 0)
    return torch.where(valid, lr, torch.zeros_like(lr))


def safe_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize with a NaN-free gradient at x = 0:
    ``x / sqrt(sum(x^2) + eps^2)`` (a ``maximum(norm, eps)`` guard still
    back-propagates 0 * inf = NaN through the sqrt at zero)."""
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps * eps)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return safe_normalize(q, eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation; [..., 4] -> [..., 3, 3]."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                        2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                        1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R(q) diag(s); s [..., 3], q [..., 4] normalized -> [..., 3, 3]."""
    return quat_to_rotmat(q) * s[..., None, :]


def covariance_from_scaling_rotation(s: torch.Tensor,
                                     q: torch.Tensor) -> torch.Tensor:
    """The 3x3 covariance L L^T with L = R(q) diag(s)."""
    L = build_scaling_rotation(s, q)
    return L @ L.transpose(-1, -2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """3x3 symmetric -> its upper triangle (xx, xy, xz, yy, yz, zz)."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], -1)
