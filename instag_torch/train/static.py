"""Vanilla 3DGS fitting of talking-head frames (counterpart of
instag_tpu/train/static.py): no motion networks, the rasterizer, the
Gaussian Adam, densification and the data loop alone. CLI:

    python -m instag_torch.train.static --source_path data/<id> \
        --model_path output/<run> --iterations 2000 --init_num 1000 \
        [--device cuda]

writes ``<model_path>/cfg_args.json`` and ``point_cloud.ply`` and prints
the result. One step renders the cloud over the frame's torso background,
takes L1 + lambda_dssim (1 - SSIM), steps the Gaussian Adam over the alive
slots and adds the densification statistics from the gradient of
``means2d_offset`` (on the card: one launch of each hand-written kernel a
step). The loop bumps the SH degree every 1000 steps, densifies every
``densification_interval`` steps past ``densify_from_iter`` (the split
children drawn from a ``torch.Generator`` seeded with 0 on the device),
resets the opacity every ``opacity_reset_interval`` steps and draws its
frames from ``numpy.random.default_rng(0)``. Losses stay on the device
and are read at log points and at the end.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import (ModelConfig, OptimizationConfig, make_parser, parse_all,
                      save_cfg)
from ..data.dataset import load_frames, random_init_points, scene_extent
from ..device import resolve_device
from ..io.checkpoints import save_gaussian_ply
from ..models import gaussians as G
from ..ops.composite import composite_bwd, composite_fwd
from ..ops.rasterize import RasterizeConfig
from ..ops.scatter import scatter_add_tiles
from ..render import render
from ..utils.losses import psnr
from .common import (FrameBatch, build_frame_batch, gaussian_backward,
                     gaussian_lrs, rgb_loss)


def step_loss(cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
              batch: FrameBatch, frame_idx: int):
    """``loss_fn(state, off) -> (loss, render)`` of one step on frame
    ``frame_idx``: the render (with ``off`` added to the projected means)
    over the frame's torso background against the frame."""
    cam = batch.camera(frame_idx)
    gt = batch.gt_image(frame_idx)
    bg = batch.bg_image(frame_idx)
    zero = torch.zeros(3, device=gt.device)

    def loss_fn(state: G.GaussianState, off: torch.Tensor):
        out = render(cfg, cam, state, zero, means2d_offset=off)
        img = out.image + bg * (1.0 - out.alpha)
        return rgb_loss(img, gt, opt_cfg.lambda_dssim), out
    return loss_fn


def make_train_step(cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                    spatial_lr_scale: float):
    """``step(state, opt, batch, frame_idx, step) -> (state, opt, loss)``,
    with ``loss`` a 0-d tensor on the device."""

    def train_step(state: G.GaussianState, opt: G.AdamState,
                   batch: FrameBatch, frame_idx: int, step: int):
        loss, out, grads, g_off = gaussian_backward(
            step_loss(cfg, opt_cfg, batch, frame_idx), state, ())
        lrs = gaussian_lrs(opt_cfg, step, spatial_lr_scale)
        params, opt = G.adam_update(state.params, grads, opt, lrs,
                                    state.alive)
        visible = out.radii > 0
        state = G.add_densification_stats(state.replace(params=params),
                                          g_off, visible)
        state = G.update_max_radii(state, out.radii, visible)
        return state, opt, loss

    return train_step


def densify_step(state: G.GaussianState, opt: G.AdamState,
                 noise: torch.Tensor, max_screen: bool, max_grad: float,
                 min_opacity: float, extent: float, percent_dense: float):
    """``densify_and_prune`` with the screen-size prune at 20 px once
    ``max_screen``; ``noise`` [2, capacity, 3] are the split draws."""
    return G.densify_and_prune(state, opt, noise, max_grad, min_opacity,
                               extent, 20.0 if max_screen else None,
                               percent_dense)


@torch.no_grad()
def train_view_psnr(cfg: RasterizeConfig, state: G.GaussianState,
                    batch: FrameBatch, n: int = 8) -> float:
    """Mean PSNR over the first ``n`` training views, each render clipped
    to [0, 1] over its torso background."""
    zero = torch.zeros(3, device=batch.image.device)
    scores = []
    for i in range(min(n, batch.num_frames)):
        out = render(cfg, batch.camera(i), state, zero)
        img = out.image + batch.bg_image(i) * (1.0 - out.alpha)
        scores.append(psnr(torch.clamp(img, 0, 1), batch.gt_image(i)))
    return float(np.mean(torch.stack(scores).tolist()))


def train(model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
          log_every: int = 200, eval_at_end: bool = True,
          device: str | torch.device = "cuda"):
    """Fit ``ModelConfig().resolve_capacity()`` slots, ``init_num`` of them
    alive at the start, to the train split of ``model_cfg.source_path`` on
    ``device``. Returns ``(state, opt, result)``; ``result`` has the JAX
    package's ``iterations``, ``final_loss`` (the mean of the last 50
    losses), ``num_points``, ``train_time_s`` and, with ``eval_at_end``,
    ``train_psnr`` (``train_view_psnr``), and besides them
    ``initial_loss`` (the mean of the first 50), ``sh_degree`` (the active
    SH degree at the end), ``kernel_launches`` (each hand-written kernel's
    launches over the steps: 0 on the CPU, where their plain versions run)
    and the per-step ``losses``."""
    dev = resolve_device(device)
    records = load_frames(model_cfg.source_path, "train",
                          model_cfg.audio_extractor, model_cfg.N_views,
                          device=dev)
    batch = build_frame_batch(records, device=dev)
    _, extent = scene_extent(records)

    h, w = records[0].height, records[0].width
    cfg = RasterizeConfig(h, w, max_per_tile=model_cfg.max_per_tile,
                          approx_topk=model_cfg.approx_topk)

    capacity = model_cfg.resolve_capacity()
    xyz, colors = random_init_points(model_cfg.init_num)
    state = G.create_from_points(torch.from_numpy(xyz).to(dev),
                                 torch.from_numpy(colors).to(dev), capacity,
                                 model_cfg.sh_degree, extent)
    opt = G.adam_init(state.params)

    step_fn = make_train_step(cfg, opt_cfg, extent)
    rng = np.random.default_rng(0)
    gen = torch.Generator(dev).manual_seed(0)
    kernels = (composite_fwd, composite_bwd, scatter_add_tiles)
    launched = [fn.launches for fn in kernels]

    t0 = time.time()
    losses: list[torch.Tensor] = []
    for it in range(1, opt_cfg.iterations + 1):
        if it % 1000 == 0:
            state = G.one_up_sh_degree(state)
        frame = int(rng.integers(batch.num_frames))
        state, opt, loss = step_fn(state, opt, batch, frame, it)
        losses.append(loss)

        if (it < opt_cfg.densify_until_iter
                and it > opt_cfg.densify_from_iter
                and it % opt_cfg.densification_interval == 0):
            noise = torch.randn((2, state.capacity, 3), generator=gen,
                                device=dev)
            state, opt = densify_step(
                state, opt, noise, it > opt_cfg.opacity_reset_interval,
                opt_cfg.densify_grad_threshold, 0.005, extent,
                opt_cfg.percent_dense)
        if (it % opt_cfg.opacity_reset_interval == 0
                and it < opt_cfg.densify_until_iter):
            state, opt = G.reset_opacity(state, opt)

        if it % log_every == 0:
            # one read back for the log line
            l, n = torch.stack([torch.stack(losses[-log_every:]).mean(),
                                state.num_alive().to(torch.float32)]
                               ).tolist()
            print(f"[{it}/{opt_cfg.iterations}] loss={l:.4f} "
                  f"points={int(n)} elapsed={time.time() - t0:.1f}s",
                  flush=True)

    all_losses = torch.stack(losses).tolist() if losses else []
    result = {"iterations": opt_cfg.iterations,
              "final_loss": float(np.mean(all_losses[-50:])),
              "num_points": int(state.num_alive()),
              "train_time_s": time.time() - t0,
              "initial_loss": float(np.mean(all_losses[:50])),
              "sh_degree": state.active_sh_degree,
              "kernel_launches": {fn.__name__: fn.launches - n0
                                  for fn, n0 in zip(kernels, launched)}}

    if eval_at_end:
        result["train_psnr"] = train_view_psnr(cfg, state, batch)
        print(f"train-view PSNR: {result['train_psnr']:.2f} dB", flush=True)
    result["losses"] = all_losses
    return state, opt, result


def main(argv=None):
    """Returns ``train``'s ``(state, opt, result)``."""
    parser = make_parser("Vanilla 3DGS static training (minimum slice)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    model_cfg, _, opt_cfg, args = parse_all(parser, argv)
    dev = resolve_device(args.device)
    if model_cfg.model_path:
        save_cfg(model_cfg.model_path, model_cfg)
    state, opt, result = train(model_cfg, opt_cfg, device=dev)
    if model_cfg.model_path:
        save_gaussian_ply(os.path.join(model_cfg.model_path,
                                       "point_cloud.ply"), state)
    print({k: v for k, v in result.items() if k != "losses"})
    return state, opt, result


if __name__ == "__main__":
    main()
