"""Joint fusion fine-tune (counterpart of instag_tpu/train/fuse.py): the
step and the ``train_fuse`` loop, serial or ``dp`` frames a step as the
face's.

The motion nets and the geometry of both clouds are frozen (the nets run
under ``torch.no_grad``; xyz, scaling and rotation of both clouds and the
mouth's opacity are detached) and only appearance trains: the face's SH
features, identity and opacity, and the mouth's SH features and identity,
through the Gaussian Adam at zero learning rate on every other attribute.
One step renders both branches with the PMFs' align heads, composites the
mouth over the frame's torso background and the face over that, and takes
L1 + lambda_dssim (1 - SSIM) against the ground truth, plus, from
``iterations // 2`` and with an LPIPS model, 0.05 LPIPS over the patches of
one drawn side. The loop draws, for each block of 100 steps, first every
step's frame and then every step's patch side. It never densifies, so it
first packs both clouds to a snug power of two.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig, OptimizationConfig
from ..data.dataset import scene_extent
from ..device import resolve_device
from ..models import gaussians as G
from ..models.lpips import load_lpips_params
from ..ops.rasterize import RasterizeConfig
from ..render import composite_fuse, render_motion, render_motion_mouth
from ..utils.losses import patchify
from ..parallel.comm import all_reduce_sum, check_replicas
from ..parallel.mesh import replicate
from .common import (FrameBatch, check_data_parallel, gaussian_lrs,
                     local_block, replica_tensors, rgb_loss)

# appearance-only training: zero learning rate on the frozen attributes
_FACE_TRAIN = frozenset({"features_dc", "features_rest", "identity",
                         "opacity"})
_MOUTH_TRAIN = frozenset({"features_dc", "features_rest", "identity"})
BLOCK = 100          # steps whose frames, then patch sides, are drawn at once


def _mask_lrs(lrs: dict, trainable: frozenset) -> dict:
    return {k: (v if k in trainable else 0.0) for k, v in lrs.items()}


def fuse_patch_sizes(h: int, w: int) -> tuple[int, ...]:
    """The LPIPS patch sides of the fusion loss: the even sides 32..42
    that fit the frame, else the frame's shorter side."""
    return tuple(s for s in (32, 34, 36, 38, 40, 42)
                 if s <= min(h, w)) or (min(h, w),)


def _frozen(net: nn.Module):
    """``net`` called under ``torch.no_grad``."""
    def run(*args):
        with torch.no_grad():
            return net(*args)
    return run


def _leaves(state: G.GaussianState, trainable: frozenset) -> G.GaussianState:
    """The state with its ``trainable`` fields as fresh gradient leaves and
    the others detached."""
    return state.replace(params=G.GaussianParams(**{
        n: (getattr(state.params, n).detach().requires_grad_(n in trainable))
        for n in G.PARAM_FIELDS}))


def _grads(state: G.GaussianState) -> G.GaussianParams:
    return G.GaussianParams(**{
        n: (getattr(state.params, n).grad
            if getattr(state.params, n).grad is not None
            else torch.zeros_like(getattr(state.params, n)))
        for n in G.PARAM_FIELDS})


class _FuseStep:
    """``step(face, face_gopt, mouth, mouth_gopt, batch, i, it, patch_idx,
    use_lpips) -> (face, face_gopt, mouth, mouth_gopt, loss)``: one fusion
    step on frame ``i`` at iteration ``it``."""

    def __init__(self, cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                 face_umf: nn.Module, mouth_umf: nn.Module,
                 face_pmf: nn.Module, mouth_pmf: nn.Module,
                 spatial_lr_scale: float, device: str | torch.device,
                 lpips: nn.Module | None, lpips_patches: tuple[int, ...],
                 dp: int = 1, group=None):
        self.device = resolve_device(device)
        self.dp, self.group = dp, group
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.face_umf, self.mouth_umf = _frozen(face_umf), _frozen(mouth_umf)
        self.face_pmf, self.mouth_pmf = _frozen(face_pmf), _frozen(mouth_pmf)
        self.spatial_lr_scale = spatial_lr_scale
        self.lpips = lpips if lpips_patches else None
        self.lpips_patches = lpips_patches
        self.green = torch.tensor([0.0, 1.0, 0.0], device=self.device)

    def loss(self, face: G.GaussianState, mouth: G.GaussianState,
             batch: FrameBatch, i: int, patch_idx: int, use_lpips: float):
        """The step's loss on frame ``i`` and the fused image."""
        cam, aud, gt = batch.camera(i), batch.auds[i], batch.gt_image(i)
        fr = render_motion(self.cfg, cam, face, umf=self.face_umf, aud=aud,
                           exp=batch.au_exp[i], bg=self.green,
                           pmf=self.face_pmf, personalized=False, align=True)
        mr = render_motion_mouth(self.cfg, cam, mouth,
                                 mouth_umf=self.mouth_umf, face_state=face,
                                 face_umf=self.face_umf, aud=aud,
                                 bg=self.green, pmf=self.mouth_pmf,
                                 personalized=False, align=True)
        image = composite_fuse(fr.out.image, fr.out.alpha, mr.out.image,
                               mr.out.alpha, self.green, batch.bg_image(i))
        loss = rgb_loss(image, gt, self.opt_cfg.lambda_dssim)
        if self.lpips is not None and use_lpips > 0.5:
            ps = self.lpips_patches[patch_idx]
            loss = loss + 0.05 * self.lpips(patchify(image * 2 - 1, ps),
                                            patchify(gt * 2 - 1, ps)).mean()
        return loss, image

    def __call__(self, face: G.GaussianState, face_gopt: G.AdamState,
                 mouth: G.GaussianState, mouth_gopt: G.AdamState,
                 batch: FrameBatch, i, it: int, patch_idx: int,
                 use_lpips: float):
        f_leaf, m_leaf = _leaves(face, _FACE_TRAIN), _leaves(mouth,
                                                            _MOUTH_TRAIN)
        loss, g_face, g_mouth = self._batch_grads(
            f_leaf, m_leaf, batch, i if self.dp > 1 else [i], patch_idx,
            use_lpips)
        lrs = gaussian_lrs(self.opt_cfg, it, self.spatial_lr_scale)
        lrs = dict(lrs, opacity=self.opt_cfg.opacity_lr)
        fp, face_gopt = G.adam_update(face.params, g_face, face_gopt,
                                      _mask_lrs(lrs, _FACE_TRAIN), face.alive)
        mp, mouth_gopt = G.adam_update(mouth.params, g_mouth, mouth_gopt,
                                       _mask_lrs(lrs, _MOUTH_TRAIN),
                                       mouth.alive)
        return (face.replace(params=fp), face_gopt,
                mouth.replace(params=mp), mouth_gopt, loss)

    def _batch_grads(self, f_leaf, m_leaf, batch, rows, patch_idx,
                     use_lpips):
        """The mean loss over the step's ``dp`` frames, of which this rank
        renders ``rows`` (``[i]`` for a serial step), and both clouds'
        gradients, summed over the ranks in one bucket."""
        loss_sum = f_leaf.params.xyz.new_zeros(())
        for i in rows:
            loss, _ = self.loss(f_leaf, m_leaf, batch, i, patch_idx,
                                use_lpips)
            (loss / self.dp).backward()
            loss_sum = loss_sum + loss.detach()
        grads = [getattr(g, n) for g in (_grads(f_leaf), _grads(m_leaf))
                 for n in G.PARAM_FIELDS]
        out = all_reduce_sum(grads + [loss_sum / self.dp], self.group)
        k = len(G.PARAM_FIELDS)
        return (out[-1], G.GaussianParams(**dict(zip(G.PARAM_FIELDS,
                                                     out[:k]))),
                G.GaussianParams(**dict(zip(G.PARAM_FIELDS, out[k:2 * k]))))


def make_fuse_step(cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                   face_umf: nn.Module, mouth_umf: nn.Module,
                   face_pmf: nn.Module, mouth_pmf: nn.Module,
                   spatial_lr_scale: float,
                   device: str | torch.device = "cuda",
                   lpips: nn.Module | None = None,
                   lpips_patches: tuple[int, ...] = (), dp: int = 1,
                   group=None) -> _FuseStep:
    """The fusion step on ``device`` (the nets, both states and the batch
    must live there); LPIPS runs on steps flagged ``use_lpips`` when
    ``lpips`` (a frozen ``models.lpips.LPIPS``) and ``lpips_patches`` are
    given. ``dp`` and ``group`` as in ``train.face.make_face_step`` (the
    fusion has no densification statistics)."""
    return _FuseStep(cfg, opt_cfg, face_umf, mouth_umf, face_pmf, mouth_pmf,
                     spatial_lr_scale, device, lpips, lpips_patches, dp,
                     group)


def train_fuse(model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
               batch: FrameBatch, face_bundle: dict, mouth_bundle: dict, *,
               log_every: int = 500, seed: int = 0,
               lpips_enabled: bool = True,
               device: str | torch.device = "cuda",
               data_parallel: int = 1, group=None) -> dict:
    """Fine-tune the appearance of the face and mouth clouds of
    ``face_bundle`` and ``mouth_bundle`` (the results of ``train_face`` and
    ``train_mouth``: ``state``, ``umf_net``, ``pmf_net``) on the frames of
    ``batch`` (on ``device``) over ``opt_cfg.iterations`` steps; the
    bundles themselves are left as they are. With ``lpips_enabled`` the
    second half adds LPIPS (``models.lpips``: random features unless
    converted weights are present). Frames and patch sides draw from
    ``numpy.random.default_rng(seed)``. Returns both states, the four nets,
    the per-step ``losses`` and the raster ``cfg``. ``data_parallel`` and
    ``group`` as in ``train.face.train_face``: each step draws its
    ``data_parallel`` frames, then the block its patch sides."""
    dev = resolve_device(device)
    rank0 = check_data_parallel(data_parallel, group)
    if batch.image.device.type != dev.type:
        raise ValueError(f"batch lives on {batch.image.device}, not {dev}")
    _, extent = scene_extent(batch.camera_center.cpu().numpy())
    h, w = batch.image.shape[1:3]
    cfg = RasterizeConfig(h, w, max_per_tile=model_cfg.max_per_tile,
                          approx_topk=model_cfg.approx_topk)

    face, mouth = face_bundle["state"], mouth_bundle["state"]
    face_gopt, mouth_gopt = G.adam_init(face.params), G.adam_init(
        mouth.params)
    if model_cfg.adaptive_capacity and not model_cfg.deterministic_slots:
        # no densification from here on: one pack to a snug power of two
        packed = []
        for name, st, go in (("face", face, face_gopt),
                             ("mouth", mouth, mouth_gopt)):
            n_alive = int(st.num_alive())
            new_cap = min(max(G._pow2ceil(2 * max(n_alive, 1)), 2048),
                          st.capacity)
            if new_cap != st.capacity:
                if rank0:
                    print(f"[fuse] {name} capacity {st.capacity} -> "
                          f"{new_cap} (alive {n_alive})", flush=True)
                st, go = G.pack_resize(st, go, new_cap)
            packed.append((st, go))
        (face, face_gopt), (mouth, mouth_gopt) = packed

    iterations = opt_cfg.iterations
    lpips_start = iterations // 2
    patch_sizes = fuse_patch_sizes(h, w)
    lpips = load_lpips_params(device=dev)[0] if lpips_enabled else None
    step = make_fuse_step(
        cfg, opt_cfg, face_bundle["umf_net"], mouth_bundle["umf_net"],
        face_bundle["pmf_net"], mouth_bundle["pmf_net"], extent, dev, lpips,
        patch_sizes if lpips_enabled else (), data_parallel, group)
    replicate((face, mouth), group)

    rng = np.random.default_rng(seed)
    losses: list[torch.Tensor] = []
    t0 = time.time()
    it = 1
    while it <= iterations:
        end = min(iterations, ((it - 1) // BLOCK + 1) * BLOCK)
        steps = range(it, end + 1)
        rows = [[int(rng.integers(batch.num_frames))
                 for _ in range(data_parallel)] for _ in steps]
        pidx = [int(rng.integers(len(patch_sizes))) for _ in steps]
        _, idxs = local_block(batch, [(r, None) for r in rows],
                              data_parallel, group)
        idxs = [i for i, _ in idxs]
        block_losses = []
        for s, i, p in zip(steps, idxs, pidx):
            face, face_gopt, mouth, mouth_gopt, loss = step(
                face, face_gopt, mouth, mouth_gopt, batch, i, s, p,
                float(s > lpips_start))
            block_losses.append(loss)
        losses.append(torch.stack(block_losses))
        it = end + 1
        if end % log_every < len(steps):
            check_replicas({**replica_tensors(face), **{
                k.replace("gaussians", "mouth"): v
                for k, v in replica_tensors(mouth).items()}}, group)
            recent = torch.cat(losses[-max(1, log_every // BLOCK):]).tolist()
            if rank0:
                print(f"[fuse {end}/{iterations}] "
                      f"loss={np.mean(recent[-log_every:]):.4f} "
                      f"t={time.time() - t0:.0f}s", flush=True)

    return dict(face_state=face, mouth_state=mouth,
                face_umf_net=face_bundle["umf_net"],
                mouth_umf_net=mouth_bundle["umf_net"],
                face_pmf_net=face_bundle["pmf_net"],
                mouth_pmf_net=mouth_bundle["pmf_net"],
                losses=torch.cat(losses).tolist() if losses else [],
                cfg=cfg)
