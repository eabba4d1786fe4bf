"""Shared training pieces (counterpart of instag_tpu/train/common.py): the
frame batch on one device, the Gaussian learning rates, the lips rectangle
mask and the photometric loss."""

from __future__ import annotations

import dataclasses

import torch

from ..render import Camera
from ..utils.general import expon_lr
from ..utils.losses import l1_loss, ssim


@dataclasses.dataclass
class FrameBatch:
    """All frames of a split, stacked on one device (field layout as the JAX
    package's FrameBatch)."""
    view_transform: torch.Tensor       # [F,4,4]
    full_proj_transform: torch.Tensor  # [F,4,4]
    camera_center: torch.Tensor        # [F,3]
    tanfovx: torch.Tensor              # [F]
    tanfovy: torch.Tensor              # [F]
    image: torch.Tensor                # [F,H,W,3] uint8
    bg: torch.Tensor                   # [F,H,W,3] uint8
    face_mask: torch.Tensor            # [F,H,W] bool
    hair_mask: torch.Tensor
    mouth_mask: torch.Tensor
    auds: torch.Tensor                 # [F,8,D,16]
    blink: torch.Tensor                # [F]
    au_exp: torch.Tensor               # [F,6]
    lips_rect: torch.Tensor            # [F,4] int32
    lhalf_rect: torch.Tensor           # [F,4] int32
    mouth_bound: torch.Tensor          # [F,3]
    normal: torch.Tensor | None = None  # [F,H,W,3] sapiens normal prior
    depth: torch.Tensor | None = None   # [F,H,W] depth prior

    @property
    def num_frames(self) -> int:
        return self.image.shape[0]

    def camera(self, i: int) -> Camera:
        return Camera(self.view_transform[i], self.full_proj_transform[i],
                      self.camera_center[i], self.tanfovx[i], self.tanfovy[i])

    def gt_image(self, i: int) -> torch.Tensor:
        """[3,H,W] float in [0,1]."""
        return self.image[i].to(torch.float32).permute(2, 0, 1) / 255.0


def rgb_loss(image: torch.Tensor, gt: torch.Tensor,
             lambda_dssim: float) -> torch.Tensor:
    """L1 + lambda (1 - SSIM), the photometric loss of every trainer."""
    return l1_loss(image, gt) + lambda_dssim * (1.0 - ssim(image, gt))


def gaussian_lrs(opt_cfg, step, spatial_lr_scale: float) -> dict:
    """Per-attribute learning rates of the Gaussian Adam; xyz follows the
    exponential schedule."""
    xyz_lr = expon_lr(step, opt_cfg.position_lr_init * spatial_lr_scale,
                      opt_cfg.position_lr_final * spatial_lr_scale,
                      lr_delay_mult=opt_cfg.position_lr_delay_mult,
                      max_steps=opt_cfg.position_lr_max_steps)
    return dict(
        xyz=xyz_lr,
        features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        identity=opt_cfg.identity_lr,
        opacity=opt_cfg.opacity_lr,
        scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
    )


def rect_mask(height: int, width: int, rect: torch.Tensor) -> torch.Tensor:
    """[H,W] mask, True inside rect [xmin, xmax, ymin, ymax], where x
    indexes rows (the landmark convention)."""
    rows = torch.arange(height, device=rect.device)[:, None]
    cols = torch.arange(width, device=rect.device)[None, :]
    return ((rows >= rect[0]) & (rows < rect[1]) &
            (cols >= rect[2]) & (cols < rect[3]))
