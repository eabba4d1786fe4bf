"""In-training validation report (counterpart of
instag_tpu/train/report.py): at test iterations, render a fixed subset of
the val and train frames through the face branch, and log their L1 and
PSNR, the val frames' largest share of saturated tiles (the K-cut bound),
the wall time per iteration, the live splat count and the opacity
histogram (``utils.logger.MetricsLogger``), with one panel per subset --
render, ground truth, depth, rendered normal, depth normal, mouth-masked
ground truth and the two attention maps -- written as
``<log_dir>/val_renders/<subset>_<iteration>.png`` through the port's own
PNG writer."""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch import nn

from ..data.image_io import write_png
from ..models import gaussians as G
from ..ops.rasterize import RasterizeConfig
from ..render import render_motion
from ..utils.logger import MetricsLogger
from ..utils.losses import l1_loss, psnr
from ..utils.normals import depth_to_normal
from .common import FrameBatch
from .face import tile_saturation


class FaceValReporter:
    """Renders up to ``num_val`` evenly spaced val frames and ``num_train``
    training frames; ``__call__(iteration, state, umf_net, pmf_net)``
    returns ``{val,train}_{l1,psnr}`` and ``val_tile_sat_max``."""

    def __init__(self, cfg: RasterizeConfig, val_batch: FrameBatch | None,
                 train_batch: FrameBatch, log_dir: str | None,
                 num_val: int = 8, num_train: int = 4,
                 save_images: bool = True):
        self.cfg = cfg
        self.logger = MetricsLogger(log_dir) if log_dir else None
        self.save_images = save_images and log_dir is not None
        self.log_dir = log_dir
        self._last = None                   # (iteration, wall) for iter_time
        self.sets = {}
        if val_batch is not None and val_batch.num_frames > 0:
            step = max(1, val_batch.num_frames // num_val)
            self.sets["val"] = (val_batch, list(range(
                0, val_batch.num_frames, step))[:num_val])
        step = max(1, train_batch.num_frames // num_train)
        self.sets["train"] = (train_batch, list(range(
            0, train_batch.num_frames, step))[:num_train])

    @torch.no_grad()
    def _render_one(self, state: G.GaussianState, umf_net: nn.Module,
                    pmf_net: nn.Module, batch: FrameBatch, i: int):
        green = torch.tensor([0.0, 1.0, 0.0], device=batch.image.device)
        cam = batch.camera(i)
        mr = render_motion(self.cfg, cam, state, umf=umf_net,
                           aud=batch.auds[i], exp=batch.au_exp[i], bg=green,
                           pmf=pmf_net, personalized=False, align=True,
                           return_attn=True)
        alpha = mr.out.alpha
        # over the frame's torso background, comparable with the ground truth
        img = torch.clamp(mr.out.image - green[:, None, None] * (1 - alpha)
                          + batch.bg_image(i) * (1 - alpha), 0.0, 1.0)
        gt = batch.gt_image(i)
        d = mr.out.depth * alpha
        d = d + d.mean() * (1 - alpha)
        d = (d - d.min()) / torch.clamp_min(d.max() - d.min(), 1e-8)
        nrm = mr.out.normal * 0.5 + 0.5
        dn = depth_to_normal(cam.view_transform, cam.tanfovx, cam.tanfovy,
                             mr.out.depth)
        dn = dn.permute(2, 0, 1) * alpha * 0.5 + 0.5
        mouth_gt = torch.where(batch.mouth_mask[i][None], 0.0, gt)
        attn = mr.attn / torch.clamp_min(
            mr.attn.amax(dim=(-2, -1), keepdim=True), 1e-8)
        return (img, gt, d, nrm, dn, mouth_gt, attn), l1_loss(img, gt), \
            psnr(img, gt)

    def __call__(self, iteration: int, state: G.GaussianState,
                 umf_net: nn.Module, pmf_net: nn.Module) -> dict:
        results = {}
        now = time.time()
        if self.logger and self._last is not None:
            it0, t0 = self._last
            if iteration > it0:
                self.logger.scalar("iter_time_ms",
                                   1000 * (now - t0) / (iteration - it0),
                                   iteration)
        self._last = (iteration, now)

        for name, (batch, ids) in self.sets.items():
            l1s, psnrs, sats = [], [], []
            for j, i in enumerate(ids):
                panels, l1, ps = self._render_one(state, umf_net, pmf_net,
                                                  batch, i)
                l1s.append(float(l1))
                psnrs.append(float(ps))
                if name == "val":
                    sats.append(float(tile_saturation(self.cfg, state, batch,
                                                      i)))
                if self.save_images and j == 0:
                    self._save_panel(name, iteration, *panels)
            results[f"{name}_l1"] = float(np.mean(l1s))
            results[f"{name}_psnr"] = float(np.mean(psnrs))
            if self.logger:
                self.logger.scalar(f"{name}/l1", results[f"{name}_l1"],
                                   iteration)
                self.logger.scalar(f"{name}/psnr", results[f"{name}_psnr"],
                                   iteration)
            if sats:
                results["val_tile_sat_max"] = float(np.max(sats))
                if self.logger:
                    self.logger.scalar("val/tile_sat_max",
                                       results["val_tile_sat_max"],
                                       iteration)
        if self.logger:
            self.logger.scalar("total_points", int(state.num_alive()),
                               iteration)
            op = torch.sigmoid(state.params.opacity[:, 0])[state.alive]
            self.logger.histogram("scene/opacity_histogram",
                                  op.cpu().numpy(), iteration)
        return results

    def _save_panel(self, name: str, iteration: int, img, gt, depth, nrm,
                    dn, mouth_gt, attn) -> None:
        def chw(x):
            return x.cpu().numpy().transpose(1, 2, 0)

        def gray3(x):
            return np.repeat(x.cpu().numpy()[:, :, None], 3, axis=2)

        panel = np.concatenate([chw(img), chw(gt), gray3(depth[0]), chw(nrm),
                                chw(dn), chw(mouth_gt), gray3(attn[0]),
                                gray3(attn[1])], axis=1)
        panel = (np.clip(panel, 0, 1) * 255).astype(np.uint8)
        out_dir = os.path.join(self.log_dir, "val_renders")
        os.makedirs(out_dir, exist_ok=True)
        write_png(os.path.join(out_dir, f"{name}_{iteration}.png"), panel)
        if self.logger:
            self.logger.image(f"{name}/panels",
                              panel.transpose(2, 0, 1) / 255.0, iteration)
