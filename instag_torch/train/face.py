"""Few-shot face adaptation (counterpart of instag_tpu/train/face.py): the
step and the ``train_face`` loop, serial or ``dp`` frames a step over the
ranks of a process group (``parallel/``).

One step renders the face branch with the PMF's align head and the UMF
attention maps, and takes the loss of the JAX package's ``step_loss``:
  * L1 + lambda_dssim (1 - SSIM) against the ground truth painted green
    off the head and on the mouth (a 3x3 dilate-then-erode soft mouth mask
    while ``use_lpips``), and on the hair while ``hair_paint``;
  * with ``has_priors`` (not in ``long`` mode): the sapiens normal prior
    0.01 and the depth prior 1e-2;
  * the motion regularisers 1e-5, the alpha regulariser 1e-3, and the
    lips and hair attention regularisers 1e-4;
  * while ``use_lpips``, with an LPIPS model: 0.01 (0.21 in ``long`` mode)
    LPIPS over the patches of one drawn side of the image and the ground
    truth, both painted green on the lips rectangle, and in ``long`` mode
    0.01 LPIPS on a ``lips_crop`` square around the lips.
Then it takes the Gaussian Adam step at ``gaussian_lrs``, the UMF (AdamW +
LambdaLR) and PMF (Adam) steps, and adds the densification statistics from
the gradient of ``means2d_offset`` and ``radii > 0``.

The loop runs the JAX loop's schedule: blocks that end at the next
densification interval or 1000-step boundary, the per-step phase flags,
the frame curriculum, and at block ends the SH-degree bump, densification
(with a rising opacity floor), the opacity reset, the green/depth prune
and, at log points, the adaptive capacity. Losses stay on the device and
are read at log points only.

The curriculum reads its window values from a float64 ``FrameMeta``, as
the JAX loop reads them from its frame records. The loop draws a block's
frames before running it, so that a ``HostFrameStore`` can upload them
together; it resumes from a bundle (the state, the nets and every
optimizer state), and its val reporter (``train.report``) runs every
``test_every`` steps.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from ..config import ModelConfig, OptimizationConfig
from ..data.dataset import random_init_points, scene_extent
from ..device import resolve_device
from ..io.checkpoints import (branch_from_bundle, gopt_from_dict,
                              pmf_opt_to_dict, restore_pmf_opt,
                              restore_umf_opt, umf_opt_to_dict)
from ..models import gaussians as G
from ..models.lpips import load_lpips_params
from ..models.motion import (MotionNetwork, PersonalizedMotionNetwork,
                             init_motion_params)
from ..ops.rasterize import RasterizeConfig, selection_stats
from ..render import render_motion
from ..utils.losses import normalize_depth, patchify
from ..utils.sh import eval_sh
from ..parallel.comm import check_replicas
from ..parallel.mesh import replicate
from .common import (FrameBatch, FrameMeta, HostFrameStore,
                     adaptation_step, check_data_parallel,
                     frame_camera, gaussian_backward,
                     local_block, rect_mask, replica_tensors, rgb_loss)
from .optim import pmf_optimizer, umf_optimizer


@dataclasses.dataclass
class Flags:
    """Per-step phase toggles, each 0.0 or 1.0 (the JAX package's Flags
    without ``valid``: there is no block padding here)."""
    align: float
    use_regs: float
    use_sapiens: float
    use_depth: float
    hair_paint: float
    use_lpips: float


class _FaceStep:
    """``step(state, gopt, batch, i, it, flags, patch_idx) -> (state, gopt,
    loss)``: one face adaptation step on frame ``i`` at iteration ``it``,
    with LPIPS patches of side ``lpips_patches[patch_idx]``. It owns the UMF
    and PMF optimizers; the Gaussian Adam state ``gopt`` is passed in and
    returned, as in the JAX package."""

    def __init__(self, cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                 umf_net: nn.Module, pmf_net: nn.Module,
                 spatial_lr_scale: float, has_priors: bool,
                 device: str | torch.device, total_iters: int,
                 warm_step: int, long: bool, lpips: nn.Module | None,
                 lpips_patches: tuple[int, ...], lips_crop: int,
                 dp: int = 1, group=None):
        self.device = resolve_device(device)
        self.dp, self.group = dp, group
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.umf_net, self.pmf_net = umf_net, pmf_net
        self.spatial_lr_scale = spatial_lr_scale
        self.has_priors = has_priors and not long
        self.long = long
        self.lpips = lpips if lpips_patches else None
        self.lpips_patches, self.lips_crop = lpips_patches, lips_crop
        self.umf_opt, self.umf_sched = umf_optimizer(
            umf_net, total_iters=total_iters, warm_step=warm_step, long=long)
        self.pmf_opt = pmf_optimizer(pmf_net)
        self.green = torch.tensor([0.0, 1.0, 0.0], device=self.device)

    def loss(self, state: G.GaussianState, off: torch.Tensor,
             batch: FrameBatch, i: int, flags: Flags, patch_idx: int = 0):
        """The step's loss on frame ``i`` and its render."""
        h, w = self.cfg.image_height, self.cfg.image_width
        gt = batch.gt_image(i)
        face_m = batch.face_mask[i]
        hair_m = batch.hair_mask[i]
        mouth_m_raw = batch.mouth_mask[i]
        head_m = face_m | hair_m
        mouth_m = mouth_m_raw
        if flags.use_lpips > 0:
            # soft mouth mask: 3x3 dilate, then 3x3 erode
            mm = mouth_m_raw[None, None].to(torch.float32)
            dil = Fn.max_pool2d(mm, 3, stride=1, padding=1)
            ero = -Fn.max_pool2d(-dil, 3, stride=1, padding=1)
            mouth_m = ero[0, 0] > 0.5

        mr = render_motion(self.cfg, batch.camera(i), state, umf=self.umf_net,
                           aud=batch.auds[i], exp=batch.au_exp[i],
                           bg=self.green, pmf=self.pmf_net,
                           personalized=False, align=float(flags.align),
                           return_attn=True, means2d_offset=off)
        out = mr.out
        green = self.green[:, None, None]
        gt_w = torch.where(head_m[None], gt, green)
        gt_w = torch.where(mouth_m[None], green, gt_w)
        img_w = out.image
        if flags.hair_paint > 0:
            img_w = torch.where(hair_m[None], green, img_w)
            gt_w = torch.where(hair_m[None], green, gt_w)

        loss = rgb_loss(img_w, gt_w, self.opt_cfg.lambda_dssim)

        if self.has_priors:
            n_prior = batch.normal[i].permute(2, 0, 1)
            nm = (head_m ^ mouth_m_raw).to(torch.float32)
            cos = (1.0 - n_prior * out.normal).sum(0)
            loss = loss + flags.use_sapiens * 0.01 * (
                (cos * nm).sum() / torch.clamp_min(nm.sum(), 1.0))
            fm = (face_m ^ mouth_m_raw).to(torch.float32)
            dd = torch.abs(normalize_depth(out.depth[0])
                           - normalize_depth(batch.depth[i]))
            loss = loss + (flags.use_sapiens * flags.use_depth * 1e-2
                           * (dd * fm).sum() / torch.clamp_min(fm.sum(), 1.0))

        m = mr.motion
        reg = (m["d_xyz"].abs().mean() + m["d_rot"].abs().mean()
               + m["d_opa"].abs().mean() + m["d_scale"].abs().mean()
               + mr.p_motion["p_xyz"].abs().mean())
        loss = loss + flags.use_regs * 1e-5 * reg

        hm = head_m[None].to(torch.float32)
        loss = loss + flags.use_regs * 1e-3 * (
            ((1 - out.alpha) * hm).mean() + (out.alpha * (1 - hm)).mean())

        lips_m = rect_mask(h, w, batch.lips_rect[i]).to(torch.float32)
        loss = loss + flags.use_regs * 1e-4 * (
            (mr.attn[1] * lips_m).sum() / torch.clamp_min(lips_m.sum(), 1.0))

        hmf = hair_m.to(torch.float32)
        attn_hair = ((mr.attn[1] * hmf).sum() + (mr.attn[0] * hmf).sum()
                     ) / torch.clamp_min(hmf.sum(), 1.0)
        loss = loss + flags.use_regs * (1 - flags.hair_paint) * 1e-4 * attn_hair

        if self.lpips is not None and flags.use_lpips > 0.5:
            loss = loss + self._lpips_terms(img_w, gt_w, batch.lips_rect[i],
                                            lips_m, patch_idx)
        return loss, out

    def _lpips_terms(self, img: torch.Tensor, gt: torch.Tensor,
                     rect: torch.Tensor, lips_m: torch.Tensor,
                     patch_idx: int) -> torch.Tensor:
        """The LPIPS phase's terms (inputs in [0, 1], LPIPS on [-1, 1])."""
        term = img.new_zeros(())
        if self.long:
            h, w = self.cfg.image_height, self.cfg.image_width
            c = self.lips_crop
            ar = torch.arange(c, device=img.device)
            rows = torch.clamp((rect[0] + rect[1]) // 2 - c // 2, 0,
                               h - c) + ar
            cols = torch.clamp((rect[2] + rect[3]) // 2 - c // 2, 0,
                               w - c) + ar

            def crop(x):
                return x.index_select(1, rows).index_select(2, cols)[None]
            term = term + 0.01 * self.lpips(crop(img) * 2 - 1,
                                            crop(gt) * 2 - 1).mean()
        green = self.green[:, None, None]
        lips = lips_m[None] > 0
        img = torch.where(lips, green, img)
        gt = torch.where(lips, green, gt)
        ps = self.lpips_patches[patch_idx]
        d = self.lpips(patchify(img * 2 - 1, ps),
                       patchify(gt * 2 - 1, ps)).mean()
        return term + (0.21 if self.long else 0.01) * d

    def loss_and_grads(self, state: G.GaussianState, batch: FrameBatch,
                       i: int, flags: Flags, patch_idx: int = 0):
        """(loss, render, Gaussian gradients, means2d_offset gradient) of one
        step, with the UMF and PMF gradients left in their ``.grad`` (zeros
        where a parameter does not reach the loss, as in the JAX package,
        so that weight decay still applies to it)."""
        if state.params.xyz.device.type != self.device.type:
            raise ValueError(f"state lives on {state.params.xyz.device}, "
                             f"not {self.device}")
        return gaussian_backward(
            lambda st, off: self.loss(st, off, batch, i, flags, patch_idx),
            state, (self.umf_net, self.pmf_net))

    def __call__(self, state: G.GaussianState, gopt: G.AdamState,
                 batch: FrameBatch, i, it: int, flags: Flags,
                 patch_idx: int = 0):
        return adaptation_step(
            self, state, gopt, i if self.dp > 1 else [i], it,
            lambda st, off, j: self.loss(st, off, batch, j, flags,
                                         patch_idx))


def make_face_step(cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                   umf_net: nn.Module, pmf_net: nn.Module,
                   spatial_lr_scale: float, has_priors: bool,
                   device: str | torch.device = "cuda",
                   total_iters: int = 10000, warm_step: int = 3000,
                   long: bool = False, lpips: nn.Module | None = None,
                   lpips_patches: tuple[int, ...] = (),
                   lips_crop: int = 96, dp: int = 1,
                   group=None) -> _FaceStep:
    """The face adaptation step on ``device`` (the nets, the state and the
    batch must live there). The UMF's learning-rate schedule runs over
    ``total_iters`` steps with ``warm_step`` and ``long`` (see
    ``optim.umf_schedule``); ``long`` also drops the priors. The LPIPS
    phase runs when ``lpips`` (a frozen ``models.lpips.LPIPS``) and
    ``lpips_patches`` (the patch sides) are given.

    ``dp=B`` trains B frames a step, as the JAX package's ``dp=B`` block:
    the step's frame argument is then a list, this rank's ``B / W`` of the
    B frames (all B without a process ``group``); each renders through
    the kernels, the loss is the mean over the B frames, the Gaussian, UMF
    and PMF gradients are reduced over the ranks before one update that
    every rank applies alike, and the per-frame statistics add as B serial
    steps' would."""
    return _FaceStep(cfg, opt_cfg, umf_net, pmf_net, spatial_lr_scale,
                     has_priors, device, total_iters, warm_step, long,
                     lpips, lpips_patches, lips_crop, dp, group)


def make_face_block(cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                    umf_net: nn.Module, pmf_net: nn.Module,
                    spatial_lr_scale: float, has_priors: bool,
                    device: str | torch.device = "cuda",
                    total_iters: int = 10000, warm_step: int = 3000,
                    long: bool = False, lpips: nn.Module | None = None,
                    lpips_patches: tuple[int, ...] = (),
                    lips_crop: int = 96, dp: int = 1, group=None):
    """``block(state, gopt, batch, idxs, its, flags, patch_idxs=None) ->
    (state, gopt, losses)``: one step per frame index in ``idxs`` (with
    ``dp`` > 1, per list of this rank's frames, see ``make_face_step``) at
    the iterations ``its`` (with the LPIPS patch sides ``patch_idxs``, 0
    when absent), all under ``flags``; ``losses`` [n] stays on the
    device."""
    step = make_face_step(cfg, opt_cfg, umf_net, pmf_net, spatial_lr_scale,
                          has_priors, device, total_iters, warm_step, long,
                          lpips, lpips_patches, lips_crop, dp, group)

    def block(state: G.GaussianState, gopt: G.AdamState, batch: FrameBatch,
              idxs, its, flags: Flags, patch_idxs=None):
        losses = []
        patch_idxs = [0] * len(idxs) if patch_idxs is None else patch_idxs
        for i, it, p in zip(idxs, its, patch_idxs):
            i = [int(j) for j in i] if dp > 1 else int(i)
            state, gopt, loss = step(state, gopt, batch, i, int(it), flags,
                                     int(p))
            losses.append(loss)
        return state, gopt, torch.stack(losses)

    return block


def face_patch_sizes(h: int, w: int) -> tuple[int, ...]:
    """The LPIPS patch sides of the JAX loop (a lattice over [64, 96] px).
    The loop draws a patch index every step, with LPIPS or without it, as
    the JAX loop does, so that both draw the same curriculum from one
    seed."""
    return tuple(s for s in (64, 72, 80, 88, 96) if s <= min(h, w)) \
        or (min(h, w),)


def tile_saturation(cfg: RasterizeConfig, state: G.GaussianState,
                    batch: FrameBatch, i: int) -> torch.Tensor:
    """The fraction of tiles of frame ``i`` whose true hit count exceeds
    ``max_per_tile`` (the K-cut diagnostic of the log line), as a 0-d
    tensor on the state's device."""
    return camera_saturation(cfg, state, batch.camera(i))


def camera_saturation(cfg: RasterizeConfig, state: G.GaussianState,
                      cam) -> torch.Tensor:
    """``tile_saturation`` seen from the camera ``cam``."""
    return selection_stats(cfg, state.params.xyz, state.get_scaling(),
                           state.get_rotation(), cam.view_transform,
                           cam.full_proj_transform, cam.camera_center,
                           cam.tanfovx, cam.tanfovy,
                           active=state.alive)["saturated_frac"]


@torch.no_grad()
def _prune_green_and_depth(state: G.GaussianState, opt: G.AdamState,
                           campos: torch.Tensor, prune_depth: bool):
    """Kill the splats whose colour seen from ``campos`` is background
    green and, with ``prune_depth``, those behind z = -0.07."""
    dirs = state.params.xyz - campos[None, :]
    dirs = dirs / torch.clamp_min(
        torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), 1e-8)
    colors = torch.clamp_min(eval_sh(
        state.max_sh_degree, state.get_features().transpose(-1, -2), dirs)
        + 0.5, 0.0)
    mask = ((colors[:, 0] < 30 / 255) & (colors[:, 1] > 225 / 255)
            & (colors[:, 2] < 30 / 255))
    if prune_depth:
        mask = mask | (state.params.xyz[:, 2] < -0.07)
    return G.prune_mask(state, opt, mask)


def sample_frame_curriculum(rng: np.random.Generator, meta: FrameMeta,
                            stack: list, it: int, warm_step: int,
                            iterations: int, select_interval: int = 10
                            ) -> int:
    """The next frame index (host side). Frames are drawn without
    replacement from ``stack``; every ``select_interval`` steps the draw
    must fall in a window, tried up to 100 times before the nearest frame
    is taken: before ``warm_step`` a window of mouth openings that moves
    from the closed to the open bound over the run, after it a window of
    blink values. The window test runs in float64 on ``meta``."""
    if not stack:
        stack.extend(range(len(meta.mouth)))
    idx = stack.pop(int(rng.integers(len(stack))))

    mouth_step = 1.0 / max(iterations, 1)
    if it % select_interval != 0:
        return idx
    if it < warm_step:
        lb, ub = meta.mouth_lb, meta.mouth_ub
        lb = lb + (ub - lb) * 0.2
        window = (ub - lb) * 0.5
        lo = lb + mouth_step * it * (ub - lb)
        hi = lo + window
        lo = lo - window
        vals = meta.mouth
    else:
        window = 0.4
        lo = mouth_step * it
        hi = lo + window
        lo = lo - window * 1.5
        vals = meta.blink

    for _ in range(100):
        if lo <= vals[idx] <= hi:
            return idx
        if not stack:
            stack.extend(range(len(vals)))
        idx = stack.pop(int(rng.integers(len(stack))))
    arr = np.asarray(vals)
    dist = np.where(arr < lo, lo - arr, np.where(arr > hi, arr - hi, 0.0))
    return int(np.argmin(dist))


def _step_flags(step: int, warm_step: int, lpips_start: int, long: bool,
                opt_cfg: OptimizationConfig) -> Flags:
    hair_iter = warm_step < step < lpips_start - 1000 and step % 7 != 0
    return Flags(align=float(step > 1000),
                 use_regs=float(step > warm_step),
                 use_sapiens=float((not long) and step > warm_step + 2000),
                 use_depth=float(step % opt_cfg.opacity_reset_interval > 100),
                 hair_paint=float(hair_iter),
                 # the phase also softens the mouth mask, with LPIPS or
                 # without it
                 use_lpips=float(step > lpips_start))


def train_face(model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
               batch: FrameBatch | HostFrameStore, meta: FrameMeta, *,
               umf_net: nn.Module | None = None,
               pmf_net: nn.Module | None = None, long: bool = False,
               log_every: int = 500, eval_fn=None, warm_step: int = 3000,
               seed: int = 0, lpips_enabled: bool = True,
               resume_bundle: dict | None = None,
               log_dir: str | None = None, test_every: int = 0,
               val_batch: FrameBatch | None = None,
               device: str | torch.device = "cuda",
               data_parallel: int = 1, group=None) -> dict:
    """Adapt a face cloud and the UMF to the frames of ``batch`` (on
    ``device``, or a ``HostFrameStore`` that uploads each block's frames)
    over ``opt_cfg.iterations`` steps. ``meta`` holds the frames' curriculum
    values in float64. With ``lpips_enabled`` the LPIPS phase runs from
    ``iterations - 2500`` (``models.lpips``: random features unless
    converted weights are present).

    ``umf_net`` / ``pmf_net`` are the starting nets (trained in place and
    moved to ``device``); absent, they start from ``seed`` through
    ``torch.Generator``s. The cloud starts from ``random_init_points(
    model_cfg.init_num, seed)``; the curriculum draws from
    ``numpy.random.default_rng(seed)`` and the split children from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.
    ``resume_bundle`` (a face bundle of either package) replaces the cloud,
    its Adam state, both nets and both optimizer states, and the run goes
    on from its ``iteration + 1``; the curriculum, its stack and the split
    draws start afresh from ``seed``, as in the JAX package, so a resumed
    run is not the uninterrupted one. ``eval_fn(end, state, umf_net,
    pmf_net)`` runs at log points; with ``log_dir`` or ``test_every`` a
    ``FaceValReporter`` renders ``val_batch`` and the first 32 training
    frames every ``test_every`` steps (``iterations // 5`` when only
    ``log_dir`` is given) and at the end. Returns the state, its Adam
    state ``gopt``, the nets and their optimizer states as bundle dicts
    (``umf_opt_state``, ``pmf_opt_state``), the per-step ``losses``, the
    raster ``cfg``, the scene ``extent`` and ``max_sh_degree``.

    ``data_parallel=B`` draws B curriculum frames a step (the JAX loop's
    draws) and trains them as one step (``make_face_step(dp=B)``); under a
    process ``group`` of W ranks each rank takes its ``B / W`` of them,
    every rank holds the one seeded ``rng`` and split generator, the
    replicated state and nets are checked bit for bit across the ranks at
    every log point, and rank 0 alone logs and runs the reporter."""
    dev = resolve_device(device)
    rank0 = check_data_parallel(data_parallel, group)
    stream = isinstance(batch, HostFrameStore)
    frames = batch.host if stream else batch
    where = batch.device if stream else batch.image.device
    if where.type != dev.type:
        raise ValueError(f"batch lives on {where}, not {dev}")
    has_priors = frames.normal is not None
    _, extent = scene_extent(frames.camera_center.cpu().numpy())
    h, w = frames.image.shape[1:3]
    cfg = RasterizeConfig(h, w, max_per_tile=model_cfg.max_per_tile,
                          approx_topk=model_cfg.approx_topk)

    iterations = opt_cfg.iterations
    densify_until = iterations - 1000
    lpips_start = densify_until - 1500

    max_sh = model_cfg.sh_degree if long else 1
    cap_max = model_cfg.resolve_capacity()
    adaptive = model_cfg.adaptive_capacity
    det_slots = model_cfg.deterministic_slots
    capacity = (G.adaptive_start_capacity(model_cfg.init_num, cap_max)
                if adaptive else cap_max)
    xyz, colors = random_init_points(model_cfg.init_num, seed)
    state = G.create_from_points(torch.from_numpy(xyz).to(dev),
                                 torch.from_numpy(colors).to(dev), capacity,
                                 max_sh, extent)
    gopt = G.adam_init(state.params)

    first_iter = 1
    if resume_bundle is not None:
        r = branch_from_bundle(resume_bundle, "face",
                               model_cfg.audio_extractor, dev)
        state, umf_net, pmf_net = r["state"], r["umf_net"], r["pmf_net"]
        gopt = gopt_from_dict(resume_bundle["gopt"], dev)
        first_iter = int(resume_bundle.get("iteration", 0)) + 1
    if umf_net is None:
        umf_net = init_motion_params(MotionNetwork(model_cfg.audio_extractor),
                                     torch.Generator().manual_seed(2 * seed))
    if pmf_net is None:
        pmf_net = init_motion_params(
            PersonalizedMotionNetwork("face", model_cfg.audio_extractor),
            torch.Generator().manual_seed(2 * seed + 1))
    umf_net, pmf_net = umf_net.to(dev), pmf_net.to(dev)
    patch_sizes = face_patch_sizes(h, w)
    lpips = load_lpips_params(device=dev)[0] if lpips_enabled else None
    step = make_face_step(cfg, opt_cfg, umf_net, pmf_net, extent, has_priors,
                          dev, total_iters=iterations, warm_step=warm_step,
                          long=long, lpips=lpips,
                          lpips_patches=patch_sizes if lpips_enabled else (),
                          lips_crop=min(96, h, w), dp=data_parallel,
                          group=group)
    replicate((state, umf_net, pmf_net), group)
    if resume_bundle is not None:
        if "umf_opt_state" in resume_bundle:
            restore_umf_opt(umf_net, step.umf_opt, step.umf_sched,
                            resume_bundle["umf_opt_state"])
        if "pmf_opt_state" in resume_bundle:
            restore_pmf_opt(pmf_net, step.pmf_opt,
                            resume_bundle["pmf_opt_state"])

    reporter = None
    if rank0 and (log_dir or test_every):
        from .report import FaceValReporter
        rep_train = (batch.gather(range(min(32, batch.num_frames)))
                     if stream else batch)
        reporter = FaceValReporter(cfg, val_batch, rep_train, log_dir)
        test_every = test_every or max(iterations // 5, 1)

    rng = np.random.default_rng(seed)
    gen = torch.Generator(dev).manual_seed(seed)
    stack: list[int] = []
    losses: list[torch.Tensor] = []      # one [n] tensor per block
    dropped_seen = 0
    t0 = time.time()

    interval = opt_cfg.densification_interval
    it = first_iter
    while it <= iterations:
        # a block ends at the next event boundary: densification interval
        # or 1000-step SH bump
        end = min(iterations, ((it - 1) // interval + 1) * interval,
                  ((it - 1) // 1000 + 1) * 1000)
        n = end - it + 1
        draws = []
        for s in range(it, end + 1):
            row = [sample_frame_curriculum(rng, meta, stack, s, warm_step,
                                           iterations)
                   for _ in range(data_parallel)]
            draws.append((row, int(rng.integers(len(patch_sizes)))))
        last = draws[-1][0][-1]
        blk, draws = local_block(batch, draws, data_parallel, group)
        block_losses = []
        for s, (i, p) in zip(range(it, end + 1), draws):
            state, gopt, loss = step(state, gopt, blk, i, s, _step_flags(
                s, warm_step, lpips_start, long, opt_cfg), p)
            block_losses.append(loss)
        losses.append(torch.stack(block_losses))
        it = end + 1
        cam = frame_camera(frames, last, dev)

        # host-side events at block ends
        if end % 1000 == 0:
            state = G.one_up_sh_degree(state)
        if opt_cfg.densify_from_iter < end < densify_until \
                and end % interval == 0:
            floor = 0.05 + 0.25 * end / densify_until
            noise = torch.randn((2, state.capacity, 3), generator=gen,
                                device=dev)
            state, gopt = G.densify_and_prune(
                state, gopt, noise, opt_cfg.densify_grad_threshold, floor,
                extent,
                20.0 if end > opt_cfg.opacity_reset_interval else None,
                opt_cfg.percent_dense)
        if (not long) and end % opt_cfg.opacity_reset_interval == 0 \
                and end < densify_until:
            state, gopt = G.reset_opacity(state, gopt)
        if end > opt_cfg.densify_from_iter and end % interval == 0:
            state, gopt = _prune_green_and_depth(
                state, gopt, cam.camera_center, not long)

        if end % log_every < n:
            check_replicas(replica_tensors(state, umf=umf_net, pmf=pmf_net),
                           group)
            # one read back for everything the log line needs
            sat = camera_saturation(cfg, state, cam)
            recent = losses[-max(1, log_every // interval):]
            vals = torch.cat([state.num_alive().to(torch.float32)[None],
                              sat[None], *recent]).tolist()
            n_alive, sat, recent = int(vals[0]), vals[1], vals[2:]
            dropped = state.dropped_children
            if rank0:
                print(f"[face {end}/{iterations}] loss="
                      f"{np.mean(recent[-log_every:]):.4f} pts={n_alive} "
                      + (f"capacity_dropped={dropped} " if dropped else "")
                      + (f"tile_sat={sat * 100:.1f}% " if sat > 0 else "")
                      + f"t={time.time() - t0:.0f}s", flush=True)
            if adaptive:
                new_cap = G.adaptive_capacity_target(
                    n_alive, state.capacity, cap_max,
                    allow_shrink=(end % 2000 < n) and not det_slots)
                if dropped > dropped_seen:   # saturated inside the window
                    new_cap = max(new_cap, min(state.capacity * 2, cap_max))
                    dropped_seen = dropped
                if new_cap != state.capacity:
                    if rank0:
                        print(f"[face] capacity {state.capacity} -> "
                              f"{new_cap} (alive {n_alive})", flush=True)
                    state, gopt = G.pack_resize(state, gopt, new_cap,
                                                keep_slots=det_slots)
            if eval_fn is not None:
                eval_fn(end, state, umf_net, pmf_net)
        if reporter is not None and (end % test_every < n
                                     or end == iterations):
            scores = reporter(end, state, umf_net, pmf_net)
            print(f"[face eval {end}] " + " ".join(
                f"{k}={v:.3f}" for k, v in scores.items()), flush=True)

    return dict(state=state, gopt=gopt, umf_net=umf_net, pmf_net=pmf_net,
                umf_opt_state=umf_opt_to_dict(umf_net, step.umf_opt,
                                              step.umf_sched),
                pmf_opt_state=pmf_opt_to_dict(pmf_net, step.pmf_opt),
                losses=torch.cat(losses).tolist() if losses else [],
                cfg=cfg, extent=extent, max_sh_degree=max_sh)
