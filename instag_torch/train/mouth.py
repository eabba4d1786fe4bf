"""Few-shot mouth-interior adaptation (counterpart of
instag_tpu/train/mouth.py): the step and the ``train_mouth`` loop, serial
or ``dp`` frames a step as the face's.

The mouth branch renders with the face cloud and the face UMF of a trained
face bundle, both frozen: the face UMF's motion range, at the ``k`` drawn
each step from [10, 50], conditions the mouth UMF. One step takes the loss
of the JAX package's ``step_loss``:
  * L1 + lambda_dssim (1 - SSIM) of the render, painted green on the band
    (lips rectangle xor mouth mask), against the ground truth painted
    green off the mouth mask;
  * while ``use_regs``: the PMF's ``p_xyz`` regulariser 1e-5 and the lips
    rectangle alpha regulariser 1e-3.
Then the Gaussian Adam step, the UMF (AdamW + LambdaLR) and PMF (Adam)
steps, and the densification statistics.

The loop runs the JAX loop's schedule: an AU25 curriculum (widest-open
frames first, then a window that slides down, and at least 20 mouth
pixels), blocks that end at the next densification interval or 1000-step
boundary, and at block ends the SH bump, densification (with a rising
opacity floor) followed after step 2000 by softening the greenish splats,
the opacity reset and, at log points, the adaptive capacity. It draws a
block's frames before running it (for a ``HostFrameStore``) and resumes
from a bundle, as the face loop does.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig, OptimizationConfig
from ..data.dataset import random_init_points, scene_extent
from ..device import resolve_device
from ..io.checkpoints import (branch_from_bundle, gopt_from_dict,
                              pmf_opt_to_dict, restore_pmf_opt,
                              restore_umf_opt, umf_opt_to_dict)
from ..models import gaussians as G
from ..models.motion import (MouthMotionNetwork, PersonalizedMotionNetwork,
                             init_motion_params)
from ..ops.rasterize import RasterizeConfig
from ..render import render_motion_mouth
from ..utils.general import inverse_sigmoid
from ..utils.sh import eval_sh
from ..parallel.comm import check_replicas
from ..parallel.mesh import replicate
from .common import (FrameBatch, FrameMeta, HostFrameStore,
                     adaptation_step, check_data_parallel,
                     frame_camera, gaussian_backward,
                     local_block, rect_mask, replica_tensors, rgb_loss)
from .optim import pmf_optimizer, umf_optimizer


@dataclasses.dataclass
class MouthFlags:
    """Per-step phase toggles, each 0.0 or 1.0 (the JAX package's
    MouthFlags without ``valid``: there is no block padding here)."""
    align: float
    use_regs: float


class _MouthStep:
    """``step(state, gopt, batch, i, it, k, flags) -> (state, gopt, loss)``:
    one mouth adaptation step on frame ``i`` at iteration ``it`` with the
    move feature's ``k``. It owns the UMF and PMF optimizers and holds the
    frozen face state and face UMF."""

    def __init__(self, cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                 umf_net: nn.Module, pmf_net: nn.Module,
                 face_state: G.GaussianState, face_net: nn.Module,
                 spatial_lr_scale: float, device: str | torch.device,
                 total_iters: int, warm_step: int, long: bool, dp: int = 1,
                 group=None):
        self.device = resolve_device(device)
        self.dp, self.group = dp, group
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.umf_net, self.pmf_net = umf_net, pmf_net
        self.face_state, self.face_net = face_state, face_net
        self.spatial_lr_scale = spatial_lr_scale
        self.umf_opt, self.umf_sched = umf_optimizer(
            umf_net, total_iters=total_iters, warm_step=warm_step, long=long)
        self.pmf_opt = pmf_optimizer(pmf_net)
        self.green = torch.tensor([0.0, 1.0, 0.0], device=self.device)

    @torch.no_grad()
    def _face_umf(self, x, a, e):
        return self.face_net(x, a, e)

    def loss(self, state: G.GaussianState, off: torch.Tensor,
             batch: FrameBatch, i: int, k: int, flags: MouthFlags):
        """The step's loss on frame ``i`` and its render."""
        h, w = self.cfg.image_height, self.cfg.image_width
        gt = batch.gt_image(i)
        mouth_m = batch.mouth_mask[i]
        lips_m = rect_mask(h, w, batch.lips_rect[i])
        mr = render_motion_mouth(
            self.cfg, batch.camera(i), state, mouth_umf=self.umf_net,
            face_state=self.face_state, face_umf=self._face_umf,
            aud=batch.auds[i], bg=self.green, pmf=self.pmf_net,
            personalized=False, align=float(flags.align), k=k,
            means2d_offset=off)
        out = mr.out
        green = self.green[:, None, None]
        gt_green = torch.where(mouth_m[None], gt, green)
        img = torch.where((lips_m ^ mouth_m)[None], green, out.image)

        loss = rgb_loss(img, gt_green, self.opt_cfg.lambda_dssim)
        loss = loss + flags.use_regs * 1e-5 * mr.p_motion["p_xyz"].abs().mean()
        lm = lips_m[None].to(torch.float32)
        loss = loss + flags.use_regs * 1e-3 * (
            ((1 - out.alpha) * lm).mean() + (out.alpha * (1 - lm)).mean())
        return loss, out

    def loss_and_grads(self, state: G.GaussianState, batch: FrameBatch,
                       i: int, k: int, flags: MouthFlags):
        """(loss, render, Gaussian gradients, means2d_offset gradient) of one
        step, with the UMF and PMF gradients left in their ``.grad``."""
        if state.params.xyz.device.type != self.device.type:
            raise ValueError(f"state lives on {state.params.xyz.device}, "
                             f"not {self.device}")
        return gaussian_backward(
            lambda st, off: self.loss(st, off, batch, i, k, flags), state,
            (self.umf_net, self.pmf_net))

    def __call__(self, state: G.GaussianState, gopt: G.AdamState,
                 batch: FrameBatch, i, it: int, k: int, flags: MouthFlags):
        return adaptation_step(
            self, state, gopt, i if self.dp > 1 else [i], it,
            lambda st, off, j: self.loss(st, off, batch, j, k, flags))


def make_mouth_step(cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                    umf_net: nn.Module, pmf_net: nn.Module,
                    face_state: G.GaussianState, face_net: nn.Module,
                    spatial_lr_scale: float,
                    device: str | torch.device = "cuda",
                    total_iters: int = 10000, warm_step: int = 3000,
                    long: bool = False, dp: int = 1,
                    group=None) -> _MouthStep:
    """The mouth adaptation step on ``device`` (the nets, both states and
    the batch must live there). ``face_state`` and ``face_net`` stay
    frozen; the UMF's learning-rate schedule runs over ``total_iters``
    steps with ``warm_step`` and ``long`` (see ``optim.umf_schedule``).
    ``dp`` and ``group`` as in ``train.face.make_face_step``."""
    return _MouthStep(cfg, opt_cfg, umf_net, pmf_net, face_state, face_net,
                      spatial_lr_scale, device, total_iters, warm_step, long,
                      dp, group)


@torch.no_grad()
def _soften_green(state: G.GaussianState,
                  campos: torch.Tensor) -> G.GaussianState:
    """The live splats whose colour seen from ``campos`` is greenish keep
    half their gradient accumulation, opacity 0.1 and a tenth of their raw
    scales."""
    dirs = state.params.xyz - campos[None, :]
    dirs = dirs / torch.clamp_min(
        torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), 1e-8)
    colors = torch.clamp_min(eval_sh(
        state.max_sh_degree, state.get_features().transpose(-1, -2), dirs)
        + 0.5, 0.0)
    green = ((colors[:, 0] < 100 / 255) & (colors[:, 1] > 180 / 255)
             & (colors[:, 2] < 100 / 255)) & state.alive
    g = green[:, None]
    p = state.params
    params = dataclasses.replace(
        p, opacity=torch.where(
            g, inverse_sigmoid(torch.full_like(p.opacity, 0.1)), p.opacity),
        scaling=torch.where(g, p.scaling / 10, p.scaling))
    return state.replace(params=params, xyz_grad_accum=torch.where(
        green, state.xyz_grad_accum / 2, state.xyz_grad_accum))


def sample_mouth_curriculum(rng: np.random.Generator, au25_vals, au25_pcts,
                            mouth_px, stack: list, it: int, warm_step: int,
                            iterations: int, select_interval: int = 5) -> int:
    """The next frame index (host side), drawn without replacement from
    ``stack``: before ``warm_step`` redrawn (up to 200 times) until its AU25
    reaches p75; after it, every ``select_interval`` steps, until its AU25
    lies in a window below p75 that widens toward p25 over the run; then
    redrawn until its mouth mask has at least 20 pixels."""
    def draw():
        if not stack:
            stack.extend(range(len(au25_vals)))
        return stack.pop(int(rng.integers(len(stack))))

    idx = draw()
    lb_g, ub_g = au25_pcts[0], au25_pcts[2]
    mouth_step = 1.0 / max(iterations, 1)
    tries = 0
    if it < warm_step:
        while au25_vals[idx] < ub_g and tries < 200:
            idx = draw()
            tries += 1
    elif it % select_interval == 0:
        au_ub = ub_g
        au_lb = au_ub - mouth_step * it * (ub_g - lb_g)
        while (au25_vals[idx] < au_lb or au25_vals[idx] > au_ub) \
                and tries < 200:
            idx = draw()
            tries += 1
    tries = 0
    while mouth_px[idx] < 20 and tries < 200:
        idx = draw()
        tries += 1
    return idx


def train_mouth(model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
                batch: FrameBatch | HostFrameStore, meta: FrameMeta,
                face_bundle: dict, *, umf_net: nn.Module | None = None,
                pmf_net: nn.Module | None = None, long: bool = False,
                log_every: int = 500, warm_step: int = 3000, seed: int = 0,
                resume_bundle: dict | None = None,
                device: str | torch.device = "cuda",
                data_parallel: int = 1, group=None) -> dict:
    """Adapt a mouth cloud, the mouth UMF and the mouth PMF to the frames of
    ``batch`` (on ``device``, or a ``HostFrameStore``) over
    ``opt_cfg.iterations`` steps, under the frozen ``face_bundle`` (the
    result of ``train.face.train_face``: its ``state`` and ``umf_net``).
    ``meta`` holds the frames' curriculum values in float64.

    ``umf_net`` / ``pmf_net`` are the starting nets (trained in place and
    moved to ``device``); absent, they start from ``seed`` through
    ``torch.Generator``s. The cloud starts from ``random_init_points(
    model_cfg.init_num, seed)`` halved and moved down by 0.05, at
    ``model_cfg.sh_degree``; the curriculum and ``k`` draw from
    ``numpy.random.default_rng(seed)`` and the split children from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.
    ``resume_bundle`` (a mouth bundle of either package) replaces the
    cloud, its Adam state, both nets and both optimizer states, and the
    run goes on from its ``iteration + 1`` with fresh draws, as the face
    loop resumes. Returns the state, its Adam state ``gopt``, the nets and
    their optimizer states as bundle dicts, the per-step ``losses``, the
    raster ``cfg`` and the scene ``extent``. ``data_parallel`` and
    ``group`` as in ``train.face.train_face`` (one ``k`` a step for its
    frames, as the JAX loop draws it)."""
    dev = resolve_device(device)
    rank0 = check_data_parallel(data_parallel, group)
    stream = isinstance(batch, HostFrameStore)
    frames = batch.host if stream else batch
    where = batch.device if stream else batch.image.device
    if where.type != dev.type:
        raise ValueError(f"batch lives on {where}, not {dev}")
    _, extent = scene_extent(frames.camera_center.cpu().numpy())
    h, w = frames.image.shape[1:3]
    cfg = RasterizeConfig(h, w, max_per_tile=model_cfg.max_per_tile,
                          approx_topk=model_cfg.approx_topk)

    iterations = opt_cfg.iterations
    densify_until = (opt_cfg.densify_until_iter if long
                     else iterations - 1000)

    cap_max = model_cfg.resolve_capacity()
    adaptive = model_cfg.adaptive_capacity
    det_slots = model_cfg.deterministic_slots
    capacity = (G.adaptive_start_capacity(model_cfg.init_num, cap_max)
                if adaptive else cap_max)
    xyz, colors = random_init_points(model_cfg.init_num, seed)
    xyz = xyz / 2.0
    xyz[:, 1] -= 0.05
    state = G.create_from_points(torch.from_numpy(xyz).to(dev),
                                 torch.from_numpy(colors).to(dev), capacity,
                                 model_cfg.sh_degree, extent)
    gopt = G.adam_init(state.params)

    first_iter = 1
    if resume_bundle is not None:
        r = branch_from_bundle(resume_bundle, "mouth",
                               model_cfg.audio_extractor, dev)
        state, umf_net, pmf_net = r["state"], r["umf_net"], r["pmf_net"]
        gopt = gopt_from_dict(resume_bundle["gopt"], dev)
        first_iter = int(resume_bundle.get("iteration", 0)) + 1
    if umf_net is None:
        umf_net = init_motion_params(
            MouthMotionNetwork(model_cfg.audio_extractor),
            torch.Generator().manual_seed(2 * seed))
    if pmf_net is None:
        pmf_net = init_motion_params(
            PersonalizedMotionNetwork("mouth", model_cfg.audio_extractor),
            torch.Generator().manual_seed(2 * seed + 1))
    umf_net, pmf_net = umf_net.to(dev), pmf_net.to(dev)
    step = make_mouth_step(cfg, opt_cfg, umf_net, pmf_net,
                           face_bundle["state"], face_bundle["umf_net"],
                           extent, dev, total_iters=iterations,
                           warm_step=warm_step, long=long, dp=data_parallel,
                           group=group)
    replicate((state, umf_net, pmf_net), group)
    if resume_bundle is not None:
        if "umf_opt_state" in resume_bundle:
            restore_umf_opt(umf_net, step.umf_opt, step.umf_sched,
                            resume_bundle["umf_opt_state"])
        if "pmf_opt_state" in resume_bundle:
            restore_pmf_opt(pmf_net, step.pmf_opt,
                            resume_bundle["pmf_opt_state"])

    rng = np.random.default_rng(seed)
    gen = torch.Generator(dev).manual_seed(seed)
    stack: list[int] = []
    losses: list[torch.Tensor] = []      # one [n] tensor per block
    dropped_seen = 0
    t0 = time.time()

    interval = opt_cfg.densification_interval
    it = first_iter
    while it <= iterations:
        end = min(iterations, ((it - 1) // interval + 1) * interval,
                  ((it - 1) // 1000 + 1) * 1000)
        n = end - it + 1
        draws = []
        for s in range(it, end + 1):
            row = [sample_mouth_curriculum(
                rng, meta.au25, meta.au25_pcts, meta.mouth_px, stack, s,
                warm_step, iterations, 7 if long else 5)
                for _ in range(data_parallel)]
            draws.append((row, int(rng.integers(10, 51))))
        last = draws[-1][0][-1]
        blk, draws = local_block(batch, draws, data_parallel, group)
        block_losses = []
        for s, (i, k) in zip(range(it, end + 1), draws):
            state, gopt, loss = step(state, gopt, blk, i, s, k, MouthFlags(
                align=float(s > 1000), use_regs=float(s > warm_step)))
            block_losses.append(loss)
        losses.append(torch.stack(block_losses))
        it = end + 1

        # host-side events at block ends
        if end % 1000 == 0:
            state = G.one_up_sh_degree(state)
        if opt_cfg.densify_from_iter < end < densify_until \
                and end % interval == 0:
            floor = 0.05 + 0.25 * end / max(densify_until, 1)
            noise = torch.randn((2, state.capacity, 3), generator=gen,
                                device=dev)
            state, gopt = G.densify_and_prune(
                state, gopt, noise, opt_cfg.densify_grad_threshold, floor,
                extent,
                20.0 if end > opt_cfg.opacity_reset_interval else None,
                opt_cfg.percent_dense)
            if end > 2000:
                state = _soften_green(
                    state, frame_camera(frames, last, dev).camera_center)
        if (not long) and end % opt_cfg.opacity_reset_interval == 0 \
                and end < densify_until:
            state, gopt = G.reset_opacity(state, gopt)

        if end % log_every < n:
            check_replicas(replica_tensors(state, umf=umf_net, pmf=pmf_net),
                           group)
            recent = losses[-max(1, log_every // interval):]
            vals = torch.cat([state.num_alive().to(torch.float32)[None],
                              *recent]).tolist()
            n_alive, recent = int(vals[0]), vals[1:]
            dropped = state.dropped_children
            if rank0:
                print(f"[mouth {end}/{iterations}] loss="
                      f"{np.mean(recent[-log_every:]):.4f} pts={n_alive} "
                      f"t={time.time() - t0:.0f}s", flush=True)
            if adaptive:
                new_cap = G.adaptive_capacity_target(
                    n_alive, state.capacity, cap_max,
                    allow_shrink=(end % 2000 < n) and not det_slots)
                if dropped > dropped_seen:
                    new_cap = max(new_cap, min(state.capacity * 2, cap_max))
                    dropped_seen = dropped
                if new_cap != state.capacity:
                    if rank0:
                        print(f"[mouth] capacity {state.capacity} -> "
                              f"{new_cap} (alive {n_alive})", flush=True)
                    state, gopt = G.pack_resize(state, gopt, new_cap,
                                                keep_slots=det_slots)

    return dict(state=state, gopt=gopt, umf_net=umf_net, pmf_net=pmf_net,
                umf_opt_state=umf_opt_to_dict(umf_net, step.umf_opt,
                                              step.umf_sched),
                pmf_opt_state=pmf_opt_to_dict(pmf_net, step.pmf_opt),
                losses=torch.cat(losses).tolist() if losses else [],
                cfg=cfg, extent=extent)
