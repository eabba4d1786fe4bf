"""Optimizers of the motion networks (counterpart of
instag_tpu/train/optim.py), with the JAX package's parameter groups.

  * UMF: AdamW, betas (0.9, 0.99), eps 1e-8: ``net`` at lr_net with no
    decay, ``encoder`` at lr with decay 0.01, ``audio_att`` at 5 lr_net with
    decay 1e-4, ``align`` at lr_net / 2; a LambdaLR multiplier of 0.1 below
    ``warm_step``, then 0.5 ** (step / total) (the JAX package's
    ``long`` mode, 0.1 **, belongs to the long-clip trainer, not ported).
  * PMF: Adam, betas (0.9, 0.999), eps 1e-15, constant rates (``net``
    lr_net, ``encoder`` lr, ``audio_att`` 5 lr_net with L2 decay 1e-4 added
    to its gradient, ``align`` lr_net / 2).

optax's ``adamw`` and ``AdamW`` decay the same way (p -= lr wd p, at the
scheduled lr), and so do optax's ``add_decayed_weights`` before
``scale_by_adam`` and ``Adam(weight_decay=)``. Parameters are grouped by
their names, which keep flax's module names.
"""

from __future__ import annotations

import torch
from torch import nn


def label_for_name(name: str) -> str:
    if "audio_att_net" in name:
        return "audio_att"
    if "encoder" in name and "exp_encode" not in name:
        return "encoder"
    if "align_net" in name:
        return "align"
    return "net"


def _groups(net: nn.Module, settings: dict) -> list[dict]:
    """One parameter group per label that has parameters."""
    by_label: dict[str, list] = {}
    for name, p in net.named_parameters():
        by_label.setdefault(label_for_name(name), []).append(p)
    return [dict(params=by_label[label], **kw)
            for label, kw in settings.items() if label in by_label]


def umf_schedule(total_iters: int, warm_step: int = 3000):
    def mult(step: int) -> float:
        return 0.1 if step < warm_step else 0.5 ** (step / total_iters)
    return mult


def umf_optimizer(net: nn.Module, lr: float = 5e-3, lr_net: float = 5e-4,
                  total_iters: int = 10000, warm_step: int = 3000):
    """(AdamW, LambdaLR) over ``net``'s parameters; step the scheduler
    after every optimizer step."""
    opt = torch.optim.AdamW(_groups(net, {
        "net": dict(lr=lr_net, weight_decay=0.0),
        "encoder": dict(lr=lr, weight_decay=0.01),
        "audio_att": dict(lr=lr_net * 5, weight_decay=1e-4),
        "align": dict(lr=lr_net / 2, weight_decay=0.0),
    }), betas=(0.9, 0.99), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, umf_schedule(total_iters, warm_step))
    return opt, sched


def pmf_optimizer(net: nn.Module, lr: float = 1e-3,
                  lr_net: float = 1e-4) -> torch.optim.Adam:
    return torch.optim.Adam(_groups(net, {
        "net": dict(lr=lr_net, weight_decay=0.0),
        "encoder": dict(lr=lr, weight_decay=0.0),
        "audio_att": dict(lr=lr_net * 5, weight_decay=1e-4),
        "align": dict(lr=lr_net / 2, weight_decay=0.0),
    }), betas=(0.9, 0.999), eps=1e-15)
