"""Optimizers of the motion networks (counterpart of
instag_tpu/train/optim.py), with the JAX package's parameter groups.

  * UMF: AdamW, betas (0.9, 0.99), eps 1e-8: ``net`` at lr_net with no
    decay, ``encoder`` at lr with decay 0.01, ``audio_att`` at 5 lr_net with
    decay 1e-4, ``align`` at lr_net / 2; a LambdaLR multiplier of 0.1 below
    ``warm_step``, then 0.5 ** (step / total), or 0.1 ** (step / total) in
    ``long`` mode.
  * PMF: Adam, betas (0.9, 0.999), eps 1e-15, constant rates (``net``
    lr_net, ``encoder`` lr, ``audio_att`` 5 lr_net with L2 decay 1e-4 added
    to its gradient, ``align`` lr_net / 2).
  * pre-training UMF (inline in the JAX package's ``train/pretrain.py``):
    the UMF's groups at lr 5e-3 and lr_net 5e-4, with a LambdaLR
    multiplier of 0.5 ** (s / select_iter) below ``select_iter``, then
    0.1 ** (s / total); and its exponential moving average ``ema_update``.

optax's ``adamw`` and ``AdamW`` decay the same way (p -= lr wd p, at the
scheduled lr), and so do optax's ``add_decayed_weights`` before
``scale_by_adam`` and ``Adam(weight_decay=)``. Parameters are grouped by
their names, which keep flax's module names.
"""

from __future__ import annotations

import torch
from torch import nn


LABELS = ("net", "encoder", "audio_att", "align")


def label_for_name(name: str) -> str:
    if "audio_att_net" in name:
        return "audio_att"
    if "encoder" in name and "exp_encode" not in name:
        return "encoder"
    if "align_net" in name:
        return "align"
    return "net"


def _groups(net: nn.Module, settings: dict, exclude=()) -> list[dict]:
    """One parameter group per label that has parameters, leaving out the
    parameters of ``exclude``."""
    skip = {id(p) for p in exclude}
    by_label: dict[str, list] = {}
    for name, p in net.named_parameters():
        if id(p) not in skip:
            by_label.setdefault(label_for_name(name), []).append(p)
    return [dict(params=by_label[label], **kw)
            for label, kw in settings.items() if label in by_label]


def umf_schedule(total_iters: int, warm_step: int = 3000,
                 long: bool = False):
    base = 0.1 if long else 0.5

    def mult(step: int) -> float:
        return 0.1 if step < warm_step else base ** (step / total_iters)
    return mult


def _umf_adamw(net: nn.Module, lr: float, lr_net: float, mult):
    opt = torch.optim.AdamW(_groups(net, {
        "net": dict(lr=lr_net, weight_decay=0.0),
        "encoder": dict(lr=lr, weight_decay=0.01),
        "audio_att": dict(lr=lr_net * 5, weight_decay=1e-4),
        "align": dict(lr=lr_net / 2, weight_decay=0.0),
    }), betas=(0.9, 0.99), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, mult)


def umf_optimizer(net: nn.Module, lr: float = 5e-3, lr_net: float = 5e-4,
                  total_iters: int = 10000, warm_step: int = 3000,
                  long: bool = False):
    """(AdamW, LambdaLR) over ``net``'s parameters; step the scheduler
    after every optimizer step."""
    return _umf_adamw(net, lr, lr_net,
                      umf_schedule(total_iters, warm_step, long))


def pretrain_schedule(select_iter: int, total_iters: int):
    """The pre-training UMF multiplier at update count ``step``."""
    def mult(step: int) -> float:
        if step < select_iter:
            return 0.5 ** (step / select_iter)
        return 0.1 ** (step / total_iters)
    return mult


def pretrain_umf_optimizer(net: nn.Module, select_iter: int,
                           total_iters: int):
    """(AdamW, LambdaLR) of multi-identity pre-training: the UMF's groups
    under ``pretrain_schedule``. Step the scheduler once per UMF update
    (optax counts updates, not iterations)."""
    return _umf_adamw(net, 5e-3, 5e-4,
                      pretrain_schedule(select_iter, total_iters))


def pmf_optimizer(net: nn.Module, lr: float = 1e-3, lr_net: float = 1e-4,
                  exclude=()) -> torch.optim.Adam:
    """Adam over ``net``'s parameters but those of ``exclude`` (a PMF's
    audio encoder when it is the UMF's, which the UMF optimizer steps)."""
    return torch.optim.Adam(_groups(net, {
        "net": dict(lr=lr_net, weight_decay=0.0),
        "encoder": dict(lr=lr, weight_decay=0.0),
        "audio_att": dict(lr=lr_net * 5, weight_decay=1e-4),
        "align": dict(lr=lr_net / 2, weight_decay=0.0),
    }, exclude), betas=(0.9, 0.999), eps=1e-15)


@torch.no_grad()
def ema_update(ema_net: nn.Module, net: nn.Module,
               decay: float = 0.995) -> None:
    """``e = decay e + (1 - decay) p`` for each parameter of ``ema_net`` and
    its namesake in ``net``, in float32, in place."""
    params = dict(net.named_parameters())
    for name, e in ema_net.named_parameters():
        e.copy_(decay * e + (1 - decay) * params[name])
