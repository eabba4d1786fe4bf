"""Frame-batched data-parallel adaptation (counterpart of
instag_tpu/parallel/data_parallel.py).

A batch of B frames trains a step: the Gaussian state and the nets are
replicated, each of the W ranks renders and differentiates its ``B / W``
frames through the kernels, and the gradients are mean-reduced over the
ranks before one update. It is ``train.face.make_face_step(dp=B, group)``,
the step ``train_face(data_parallel=B, group=)`` runs, with the full loss
and the per-frame densification statistics summed as B serial steps would
(``models.gaussians.frame_stats``, summed in the gradients' bucket by
``train.common.adaptation_grads``); this module packages
one step for scripts and tests, as the JAX module does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import OptimizationConfig
from ..ops.rasterize import RasterizeConfig
from ..train.common import local_block
from ..train.face import Flags, make_face_step


def dp_flags(step: int, warm_step: int = 0, lpips_start: int = 10 ** 9,
             long: bool = False,
             opacity_reset_interval: int = 3000) -> Flags:
    """The phase flags of one step of the ``train_face`` schedule."""
    return Flags(align=float(step > 1000),
                 use_regs=float(step > warm_step),
                 use_sapiens=float((not long) and step > warm_step + 2000),
                 use_depth=float(step % opacity_reset_interval > 100),
                 hair_paint=0.0,
                 use_lpips=float(step > lpips_start))


def make_dp_face_step(cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                      umf_net: nn.Module, pmf_net: nn.Module,
                      spatial_lr_scale: float, dp: int, group=None,
                      has_priors: bool = False,
                      lpips: nn.Module | None = None,
                      lpips_patches: tuple[int, ...] = (),
                      long: bool = False,
                      device: str | torch.device = "cuda"):
    """The full-loss data-parallel face step: ``step(state, gopt, batch,
    idx, it, flags, patch_idx=0) -> (state, gopt, loss)``, ``idx`` the
    step's ``dp`` frame indices into ``batch`` (every rank passes the same
    ``idx`` and takes its own share); ``loss`` is the mean over the ``dp``
    frames."""
    face = make_face_step(cfg, opt_cfg, umf_net, pmf_net, spatial_lr_scale,
                          has_priors, device, long=long, lpips=lpips,
                          lpips_patches=lpips_patches, dp=dp, group=group)

    def step(state, gopt, batch, idx, it: int, flags: Flags,
             patch_idx: int = 0):
        blk, rows = local_block(batch, [([int(i) for i in idx], None)], dp,
                                group)
        return face(state, gopt, blk, rows[0][0], it, flags, patch_idx)

    step.face_step = face
    return step
