"""Multi-identity Universal Motion Field pre-training (counterpart of
instag_tpu/train/pretrain.py, serial path): the warm and motion steps and
the ``pretrain_face`` and ``pretrain_mouth`` loops.

Every identity has its own Gaussian cloud, Gaussian Adam state, frame
curriculum and Personalized Motion Field (PMF, with its own Adam); one
Universal Motion Field (UMF) is shared, with an AdamW under the
pre-training LambdaLR (``optim.pretrain_umf_optimizer``) and an EMA shadow
(``optim.ema_update``, decay 0.995) that the pretrain bundles carry.

  * warm-up (global steps below ``warm_per_id * n``) renders the cloud
    statically and trains the Gaussians alone: the UMF, its schedule, its
    EMA and the PMFs do not step;
  * face motion steps render through UMF + PMF with the attention maps and
    take L1 + D-SSIM against the head painted green off the face and hair
    and on the mouth (and on the hair while ``hair_paint``), the motion
    and alpha regularisers, the eye-attention term in the lips rectangle
    for both fields, the hair-attention term and the cross-identity
    contrastive hinge: every other identity's PMF at the same (detached)
    positions, audio and expression, relu of its d_xyz's inner product
    with the current PMF's, averaged over every capacity slot (dead ones
    included) and summed over the others;
  * mouth motion steps render the mouth branch under the identity's frozen
    face cloud and the frozen EMA face UMF, with the lips-rectangle xor
    mouth band painted green, and one contrastive partner per block.

The other identities' PMFs are evaluated one by one under ``no_grad`` (the
JAX package batches them in one vmap) and are neither differentiated nor
stepped. With ``share_audio_net`` every PMF's ``audio`` module is the
UMF's (module aliasing): the gradients of both uses add into the UMF's
parameters, which only the UMF optimizer steps, and a saved PMF carries
the UMF's audio weights.

The loops run the JAX loop's schedule: blocks of one identity, drawn with
``rng.integers(n)`` before the block's frames, that end at the least of the
run's end, the next multiple of ``identity_block``, of the densification
interval and of 1000, and ``warm_step - 1`` during warm-up; at a block's
end the SH bump (on the global step), densification followed by the green
prune (face) or the green softening (mouth), and at log points each
identity's adaptive capacity. The JAX loop pads every identity's frames to
one count (``_pad_batches``) so that XLA compiles one program; here it is
inert, since every index a block reads, the green prune's camera centre
included, comes from that identity's own curriculum over its own frames,
so there is no padding. Losses stay on the device and are read at log
points only.

With ``identity_parallel`` the loops run the JAX package's
identity-parallel schedule instead (``_idp_loop``): one identity a rank of
a process group, every identity trained at each step
(``parallel.identity_parallel``).
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import os
import time

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig, OptimizationConfig
from ..data.dataset import load_frames, random_init_points, scene_extent
from ..device import resolve_device
from ..io.checkpoints import umf_opt_to_dict
from ..models import gaussians as G
from ..models.motion import (MotionNetwork, MouthMotionNetwork,
                             PersonalizedMotionNetwork, init_motion_params)
from ..ops.rasterize import RasterizeConfig
from ..render import render, render_motion, render_motion_mouth
from ..parallel.comm import all_gather, check_replicas, world
from ..parallel.identity_parallel import (check_identity_ranks,
                                          gather_identities,
                                          make_idp_densify,
                                          make_idp_pretrain_mouth_step,
                                          make_idp_pretrain_step)
from ..parallel.mesh import replicate
from .common import (FrameBatch, FrameMeta, HostFrameStore,
                     build_frame_batch, gaussian_backward, gaussian_lrs,
                     rect_mask, rgb_loss)
from .face import _prune_green_and_depth
from .mouth import _soften_green, sample_mouth_curriculum
from .optim import ema_update, pmf_optimizer, pretrain_umf_optimizer

EMA_DECAY = 0.995


@dataclasses.dataclass
class PretrainFlags:
    """Per-step phase toggles, each 0.0 or 1.0 (the mouth step reads
    ``use_regs`` only)."""
    use_regs: float
    hair_paint: float


def tie_audio_params(pmf_net: nn.Module, umf_net: nn.Module) -> nn.Module:
    """Make the PMF's audio encoder the UMF's module (``--share_audio_net``):
    both uses then differentiate into, and read, the UMF's parameters."""
    pmf_net.audio = umf_net.audio
    return pmf_net


def _update_gaussians(state, gopt, out, grads, g_off, it, opt_cfg,
                      spatial_lr_scale):
    """The Gaussian Adam step and the densification statistics."""
    params, gopt = G.adam_update(state.params, grads, gopt,
                                 gaussian_lrs(opt_cfg, it, spatial_lr_scale),
                                 state.alive)
    return G.add_densification_stats(state.replace(params=params), g_off,
                                     out.radii, out.radii > 0), gopt


class _WarmStep:
    """``step(state, gopt, batch, i, it) -> (state, gopt, loss)``: one
    static-render step of the Gaussians alone on frame ``i``."""

    def __init__(self, cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                 spatial_lr_scale: float, mouth: bool,
                 device: str | torch.device):
        self.device = resolve_device(device)
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.spatial_lr_scale, self.mouth = spatial_lr_scale, mouth
        self.green = torch.tensor([0.0, 1.0, 0.0], device=self.device)

    def loss(self, state: G.GaussianState, off: torch.Tensor,
             batch: FrameBatch, i: int):
        green = self.green[:, None, None]
        gt = batch.gt_image(i)
        mouth_m = batch.mouth_mask[i]
        sel = (mouth_m if self.mouth
               else batch.face_mask[i] | batch.hair_mask[i])
        gt_m = torch.where(sel[None], gt, green)
        if not self.mouth:
            gt_m = torch.where(mouth_m[None], green, gt_m)
        out = render(self.cfg, batch.camera(i), state, self.green,
                     means2d_offset=off)
        img = out.image
        if self.mouth:
            band = rect_mask(self.cfg.image_height, self.cfg.image_width,
                             batch.lips_rect[i]) ^ mouth_m
            img = torch.where(band[None], green, img)
        return rgb_loss(img, gt_m, self.opt_cfg.lambda_dssim), out

    def __call__(self, state: G.GaussianState, gopt: G.AdamState,
                 batch: FrameBatch, i: int, it: int):
        loss, out, grads, g_off = gaussian_backward(
            lambda st, off: self.loss(st, off, batch, i), state, ())
        state, gopt = _update_gaussians(state, gopt, out, grads, g_off, it,
                                        self.opt_cfg, self.spatial_lr_scale)
        return state, gopt, loss


def make_warm_step(cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                   spatial_lr_scale: float, mouth: bool,
                   device: str | torch.device = "cuda"):
    """``block(state, gopt, batch, idxs, its) -> (state, gopt, losses)``:
    warm-up steps on the frames ``idxs`` at the global steps ``its``; for
    the mouth the ground truth keeps the mouth only and the render is
    painted green on the lips-rectangle xor mouth band."""
    step = _WarmStep(cfg, opt_cfg, spatial_lr_scale, mouth, device)

    def block(state, gopt, batch, idxs, its):
        losses = []
        for i, it in zip(idxs, its):
            state, gopt, loss = step(state, gopt, batch, int(i), int(it))
            losses.append(loss)
        return state, gopt, torch.stack(losses)

    return block


class _MotionStep:
    """What the face and mouth motion steps share: the UMF with its AdamW,
    LambdaLR and EMA, one PMF and one Adam a identity, and the update that
    follows a step's backward."""

    def __init__(self, cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                 umf_net: nn.Module, pmf_nets: list, ema_net: nn.Module,
                 spatial_lr_scale: float, select_iter: int, total_iters: int,
                 device: str | torch.device, shared=()):
        self.device = resolve_device(device)
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.umf_net, self.pmf_nets, self.ema_net = umf_net, pmf_nets, ema_net
        self.spatial_lr_scale = spatial_lr_scale
        self.umf_opt, self.umf_sched = pretrain_umf_optimizer(
            umf_net, select_iter, total_iters)
        self.pmf_opts = [pmf_optimizer(p, exclude=shared) for p in pmf_nets]
        self.green = torch.tensor([0.0, 1.0, 0.0], device=self.device)

    def _check(self, state: G.GaussianState):
        if state.params.xyz.device.type != self.device.type:
            raise ValueError(f"state lives on {state.params.xyz.device}, "
                             f"not {self.device}")

    def _contrast(self, cur_dxyz: torch.Tensor, others) -> torch.Tensor:
        """Sum over ``others`` (d_xyz without gradient) of the mean over
        every slot of relu(<other, cur>)."""
        term = cur_dxyz.new_zeros(())
        for d in others:
            term = term + torch.relu((d * cur_dxyz).sum(-1)).mean()
        return term

    def _update(self, state, gopt, cur: int, out, grads, g_off, it: int):
        state, gopt = _update_gaussians(state, gopt, out, grads, g_off, it,
                                        self.opt_cfg, self.spatial_lr_scale)
        self.umf_opt.step()
        self.umf_sched.step()
        ema_update(self.ema_net, self.umf_net, EMA_DECAY)
        self.pmf_opts[cur].step()
        return state, gopt


class _FaceMotionStep(_MotionStep):
    """``step(state, gopt, cur, batch, i, it, flags) -> (state, gopt,
    loss)``: one face motion step of identity ``cur`` on frame ``i``."""

    def loss(self, state: G.GaussianState, off: torch.Tensor, cur: int,
             batch: FrameBatch, i: int, flags: PretrainFlags):
        h, w = self.cfg.image_height, self.cfg.image_width
        gt = batch.gt_image(i)
        aud, exp = batch.auds[i], batch.au_exp[i]
        hair_m, mouth_m = batch.hair_mask[i], batch.mouth_mask[i]
        head_m = batch.face_mask[i] | hair_m
        lips_m = rect_mask(h, w, batch.lips_rect[i]).to(torch.float32)

        mr = render_motion(self.cfg, batch.camera(i), state,
                           umf=self.umf_net, aud=aud, exp=exp, bg=self.green,
                           pmf=self.pmf_nets[cur], personalized=True,
                           align=False, return_attn=True,
                           means2d_offset=off)
        out = mr.out
        green = self.green[:, None, None]
        gt_w = torch.where(head_m[None], gt, green)
        gt_w = torch.where(mouth_m[None], green, gt_w)
        img = out.image
        if flags.hair_paint > 0:
            img = torch.where(hair_m[None], green, img)
            gt_w = torch.where(hair_m[None], green, gt_w)
        loss = rgb_loss(img, gt_w, self.opt_cfg.lambda_dssim)

        m, pm = mr.motion, mr.p_motion
        reg = (m["d_xyz"].abs().mean() + m["d_rot"].abs().mean()
               + m["d_opa"].abs().mean() + m["d_scale"].abs().mean())
        reg = reg + (pm["d_xyz"].abs().mean() + pm["d_rot"].abs().mean()
                     + pm["d_opa"].abs().mean() + pm["d_scale"].abs().mean())
        loss = loss + flags.use_regs * 1e-5 * reg

        hm = head_m[None].to(torch.float32)
        loss = loss + flags.use_regs * 1e-3 * (
            ((1 - out.alpha) * hm).mean() + (out.alpha * (1 - hm)).mean())

        if len(self.pmf_nets) > 1:
            xyz = state.params.xyz.detach()
            with torch.no_grad():
                others = [net(xyz, aud, exp)["d_xyz"]
                          for k, net in enumerate(self.pmf_nets) if k != cur]
            loss = loss + flags.use_regs * self._contrast(pm["d_xyz"], others)

        lsum = torch.clamp_min(lips_m.sum(), 1.0)
        for attn in (mr.attn, mr.p_attn):
            loss = loss + flags.use_regs * 5e-3 * (
                attn[1] * lips_m).sum() / lsum

        hmf = hair_m.to(torch.float32)
        attn_hair = ((mr.attn[1] * hmf).sum() + (mr.attn[0] * hmf).sum()
                     ) / torch.clamp_min(hmf.sum(), 1.0)
        loss = loss + (flags.use_regs * (1 - flags.hair_paint) * 1e-4
                       * attn_hair)
        return loss, out

    def loss_and_grads(self, state, cur, batch, i, flags):
        """(loss, render, Gaussian gradients, means2d_offset gradient), with
        the UMF's and the current PMF's gradients in their ``.grad``."""
        self._check(state)
        return gaussian_backward(
            lambda st, off: self.loss(st, off, cur, batch, i, flags), state,
            (self.umf_net, self.pmf_nets[cur]))

    def __call__(self, state, gopt, cur, batch, i, it, flags):
        loss, out, grads, g_off = self.loss_and_grads(state, cur, batch, i,
                                                      flags)
        state, gopt = self._update(state, gopt, cur, out, grads, g_off, it)
        return state, gopt, loss


class _MouthMotionStep(_MotionStep):
    """``step(state, gopt, cur, other, batch, i, it, flags) -> (state, gopt,
    loss)``: one mouth motion step of identity ``cur`` on frame ``i``,
    under its frozen face cloud and the frozen face UMF, with ``other``'s
    PMF as the contrastive partner."""

    def __init__(self, *args, face_states: list, face_net: nn.Module,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.face_states, self.face_net = face_states, face_net

    @torch.no_grad()
    def _face_umf(self, x, a, e):
        return self.face_net(x, a, e)

    def loss(self, state: G.GaussianState, off: torch.Tensor, cur: int,
             other: int, batch: FrameBatch, i: int, flags: PretrainFlags):
        h, w = self.cfg.image_height, self.cfg.image_width
        gt = batch.gt_image(i)
        aud = batch.auds[i]
        mouth_m = batch.mouth_mask[i]
        lips_m = rect_mask(h, w, batch.lips_rect[i])
        mr = render_motion_mouth(
            self.cfg, batch.camera(i), state, mouth_umf=self.umf_net,
            face_state=self.face_states[cur], face_umf=self._face_umf,
            aud=aud, bg=self.green, pmf=self.pmf_nets[cur],
            personalized=True, align=False, means2d_offset=off)
        out = mr.out
        green = self.green[:, None, None]
        gt_g = torch.where(mouth_m[None], gt, green)
        img = torch.where((lips_m ^ mouth_m)[None], green, out.image)

        loss = rgb_loss(img, gt_g, self.opt_cfg.lambda_dssim)
        m, pm = mr.motion, mr.p_motion
        loss = loss + flags.use_regs * 1e-5 * (
            m["d_xyz"].abs().mean() + m["d_rot"].abs().mean()
            + pm["d_xyz"].abs().mean() + pm["d_rot"].abs().mean())
        lm = lips_m[None].to(torch.float32)
        loss = loss + flags.use_regs * 1e-3 * (
            ((1 - out.alpha) * lm).mean() + (out.alpha * (1 - lm)).mean())

        if len(self.pmf_nets) > 1:
            with torch.no_grad():
                d = self.pmf_nets[other](state.params.xyz.detach(),
                                         aud)["d_xyz"]
            loss = loss + flags.use_regs * self._contrast(pm["d_xyz"], [d])
        return loss, out

    def loss_and_grads(self, state, cur, other, batch, i, flags):
        self._check(state)
        return gaussian_backward(
            lambda st, off: self.loss(st, off, cur, other, batch, i, flags),
            state, (self.umf_net, self.pmf_nets[cur]))

    def __call__(self, state, gopt, cur, other, batch, i, it, flags):
        loss, out, grads, g_off = self.loss_and_grads(state, cur, other,
                                                      batch, i, flags)
        state, gopt = self._update(state, gopt, cur, out, grads, g_off, it)
        return state, gopt, loss


def make_pretrain_face_step(cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                            umf_net: nn.Module, pmf_nets: list,
                            ema_net: nn.Module, spatial_lr_scale: float,
                            select_iter: int, total_iters: int,
                            share_audio_net: bool = False,
                            device: str | torch.device = "cuda"
                            ) -> _FaceMotionStep:
    """The face motion step on ``device`` (nets, state and batch there). It
    owns the UMF's AdamW + LambdaLR (``pretrain_schedule(select_iter,
    total_iters)``) and one PMF Adam a identity, and steps ``ema_net``
    after each UMF update. With ``share_audio_net`` every PMF's audio
    module is tied to the UMF's (``tie_audio_params``) and left out of
    the PMF optimizers."""
    shared = ()
    if share_audio_net:
        for p in pmf_nets:
            tie_audio_params(p, umf_net)
        shared = tuple(umf_net.audio.parameters())
    return _FaceMotionStep(cfg, opt_cfg, umf_net, pmf_nets, ema_net,
                           spatial_lr_scale, select_iter, total_iters, device,
                           shared)


def make_pretrain_mouth_step(cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                             umf_net: nn.Module, pmf_nets: list,
                             ema_net: nn.Module, face_states: list,
                             face_net: nn.Module, spatial_lr_scale: float,
                             select_iter: int, total_iters: int,
                             device: str | torch.device = "cuda"
                             ) -> _MouthMotionStep:
    """The mouth motion step on ``device``, under the frozen per-identity
    ``face_states`` and the frozen face UMF ``face_net`` (see
    ``make_pretrain_face_step`` for the optimizers)."""
    return _MouthMotionStep(cfg, opt_cfg, umf_net, pmf_nets, ema_net,
                            spatial_lr_scale, select_iter, total_iters,
                            device, face_states=face_states,
                            face_net=face_net)


def _load_identity(model_cfg: ModelConfig, name: str, capacity: int,
                   mouth: bool, seed: int, stream: bool = False,
                   device: str | torch.device = "cuda", own: bool = True):
    """One identity's train split under ``model_cfg.source_path``: (records,
    frames as a FrameBatch or a HostFrameStore, the initial cloud, its
    FrameMeta, its scene extent). The cloud starts from
    ``random_init_points(init_num, seed)``, halved and moved down by 0.05
    for the mouth, at ``model_cfg.sh_degree``. An identity that is not
    this process's ``own`` (another rank's, under identity parallelism)
    decodes no frame and has neither frames nor cloud (None): its meta and
    extent alone."""
    dev = resolve_device(device)
    records = load_frames(os.path.join(model_cfg.source_path, name), "train",
                          model_cfg.audio_extractor, -1, device=dev,
                          host=stream, images=own)
    _, extent = scene_extent(records)
    if not own:
        return records, None, None, FrameMeta.from_records(records), extent
    batch = (HostFrameStore(records, device=dev) if stream
             else build_frame_batch(records, device=dev))
    xyz, colors = random_init_points(model_cfg.init_num, seed)
    if mouth:
        xyz = xyz / 2.0
        xyz[:, 1] -= 0.05
    state = G.create_from_points(torch.from_numpy(xyz).to(dev),
                                 torch.from_numpy(colors).to(dev), capacity,
                                 model_cfg.sh_degree, extent)
    return records, batch, state, FrameMeta.from_records(records), extent


def _adaptive_resize(states: list, gopts: list, pts, dropped,
                     dropped_seen: list, cap_max: int, allow_shrink: bool,
                     tag: str, keep_slots: bool = False):
    """Each identity's adaptive capacity at a log point (see
    ``train.face.train_face``); ``dropped_seen`` holds each identity's
    count of children dropped for want of capacity, updated in place."""
    for k in range(len(states)):
        new_cap = G.adaptive_capacity_target(
            int(pts[k]), states[k].capacity, cap_max,
            allow_shrink=allow_shrink and not keep_slots)
        if int(dropped[k]) > dropped_seen[k]:   # saturated inside the window
            new_cap = max(new_cap, min(states[k].capacity * 2, cap_max))
            dropped_seen[k] = int(dropped[k])
        if new_cap != states[k].capacity:
            print(f"[{tag}] id{k} capacity {states[k].capacity} -> "
                  f"{new_cap} (alive {int(pts[k])})", flush=True)
            states[k], gopts[k] = G.pack_resize(states[k], gopts[k], new_cap,
                                                keep_slots=keep_slots)
    return states, gopts


def _sample_face_curriculum(rng: np.random.Generator, meta: FrameMeta,
                            stack: list, it: int, warm_step: int,
                            select_iter: int, select_interval: int) -> int:
    """The next frame of one identity (host side), drawn without
    replacement from ``stack``; every ``select_interval`` steps redrawn up
    to 100 times until it lies in a window: of mouth openings before
    ``warm_step``, of blink values after it."""
    n_frames = len(meta.mouth)
    if not stack:
        stack.extend(range(n_frames))
    idx = stack.pop(int(rng.integers(len(stack))))
    if it % select_interval != 0:
        return idx
    step_rate = 1.0 / max(select_iter, 1)
    if it < warm_step:
        lb, ub = meta.mouth_lb, meta.mouth_ub
        lb = lb + (ub - lb) * 0.2
        window = (ub - lb) * 0.2
        lo = lb + step_rate * it * (ub - lb)
        hi = lo + window
        lo -= window
        vals = meta.mouth
    else:
        window = 0.3
        lo = step_rate * it
        hi = lo + window
        lo -= window * 0.5
        vals = meta.blink
    for _ in range(100):
        if lo <= vals[idx] <= hi:
            return idx
        if not stack:
            stack.extend(range(n_frames))
        idx = stack.pop(int(rng.integers(len(stack))))
    return idx


def _prune_green(state: G.GaussianState, opt: G.AdamState,
                 campos: torch.Tensor):
    """Kill the splats whose colour seen from ``campos`` is background
    green."""
    return _prune_green_and_depth(state, opt, campos, prune_depth=False)


def _auto_stream(source_path: str, data_list: list, threshold: int) -> bool:
    """Whether any identity holds more than ``threshold`` frame JPEGs."""
    return any(len(glob.glob(os.path.join(source_path, name, "gt_imgs",
                                          "*.jpg"))) > threshold
               for name in data_list)


def _start(model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
           data_list: list, mouth: bool, seed: int, stream, stream_threshold,
           dev: torch.device, tag: str, only: int | None = None) -> dict:
    """The run's sizes and every identity's frames, cloud and Adam state;
    with ``only`` (an identity-parallel rank), those of identity ``only``
    alone, and every identity's meta and extent. Identity parallelism
    refuses streaming."""
    n = len(data_list)
    cap_max = model_cfg.resolve_capacity()
    adaptive = model_cfg.adaptive_capacity
    capacity = (G.adaptive_start_capacity(model_cfg.init_num, cap_max)
                if adaptive else cap_max)
    if stream is None:
        stream = _auto_stream(model_cfg.source_path, data_list,
                              stream_threshold)
    if stream and only is not None:
        raise ValueError("identity_parallel is exclusive with streaming")
    if stream:
        print(f"[{tag}] streaming mode: frames stay in host memory, each "
              "block's frames upload on demand", flush=True)
    ids = [_load_identity(model_cfg, name, capacity, mouth,
                          seed + (7 * k if mouth else k), stream, dev,
                          only in (None, k))
           for k, name in enumerate(data_list)]
    r0 = ids[0][0][0]
    return dict(
        n=n, iterations=opt_cfg.iterations * n,
        densify_until=(opt_cfg.iterations - 1000) * n,
        select_iter=max((opt_cfg.iterations - 10000) * n, 1),
        cap_max=cap_max, adaptive=adaptive,
        det_slots=model_cfg.deterministic_slots, stream=stream,
        cfg=RasterizeConfig(r0.height, r0.width,
                            max_per_tile=model_cfg.max_per_tile,
                            approx_topk=model_cfg.approx_topk),
        batches=[x[1] for x in ids], states=[x[2] for x in ids],
        metas=[x[3] for x in ids], extents=[x[4] for x in ids],
        gopts=[None if x[2] is None else G.adam_init(x[2].params)
               for x in ids])


def _loop(run: dict, opt_cfg: OptimizationConfig, warm, motion, curriculum,
          after_densify, draw_other, warm_step: int, identity_block: int,
          log_every: int, seed: int, dev: torch.device, tag: str,
          mean_last: bool) -> list:
    """The block loop both pre-training stages share; updates
    ``run["states"]`` and ``run["gopts"]`` and returns the per-step
    losses. ``curriculum(rng, meta, stack, step)`` draws a frame,
    ``draw_other(rng, sid)`` a block's contrastive partner (motion blocks
    only), and ``after_densify(state, gopt, campos)`` follows each
    densification."""
    n, iterations = run["n"], run["iterations"]
    densify_until = run["densify_until"]
    states, gopts, batches = run["states"], run["gopts"], run["batches"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(dev).manual_seed(seed)
    stacks: list[list[int]] = [[] for _ in range(n)]
    dropped_seen = [0] * n
    losses: list[torch.Tensor] = []      # one [steps] tensor per block
    t0 = time.time()

    interval = opt_cfg.densification_interval
    it = 1
    while it <= iterations:
        end = min(iterations,
                  ((it - 1) // identity_block + 1) * identity_block,
                  ((it - 1) // interval + 1) * interval,
                  ((it - 1) // 1000 + 1) * 1000)
        if it < warm_step:
            end = min(end, warm_step - 1)
        sid = int(rng.integers(n))
        state, gopt = states[sid], gopts[sid]
        steps = range(it, end + 1)
        idxs = [curriculum(rng, run["metas"][sid], stacks[sid], s)
                for s in steps]
        blk = batches[sid]
        if run["stream"]:
            blk = blk.gather(idxs)
            idxs = list(range(len(idxs)))
        if it < warm_step:
            state, gopt, block_losses = warm(state, gopt, blk, idxs, steps)
        else:
            other = draw_other(rng, sid)
            block_losses = []
            for i, s in zip(idxs, steps):
                flags = PretrainFlags(
                    use_regs=float(s > warm_step),
                    hair_paint=float(s > warm_step and s % 7 != 0))
                state, gopt, loss = motion(state, gopt, sid, other, blk, i,
                                           s, flags)
                block_losses.append(loss)
            block_losses = torch.stack(block_losses)
        losses.append(block_losses)
        nsteps = len(steps)
        it = end + 1

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
                run["extents"][sid],
                20.0 if end > opt_cfg.opacity_reset_interval else None,
                opt_cfg.percent_dense)
            state, gopt = after_densify(state, gopt,
                                        blk.camera_center[idxs[-1]])
        states[sid], gopts[sid] = state, gopt

        if end % log_every < nsteps:
            # one read back for everything the log line needs
            recent = losses[-max(1, log_every // nsteps):]
            vals = torch.cat([torch.stack([s.num_alive() for s in states]
                                          ).to(torch.float32),
                              *recent]).tolist()
            pts, recent = [int(v) for v in vals[:n]], vals[n:]
            if mean_last:
                recent = recent[-log_every:]
            print(f"[{tag} {end}/{iterations}] loss={np.mean(recent):.4f} "
                  f"pts={pts} t={time.time() - t0:.0f}s", flush=True)
            if run["adaptive"]:
                _adaptive_resize(states, gopts, pts,
                                 [s.dropped_children for s in states],
                                 dropped_seen, run["cap_max"],
                                 allow_shrink=(end % 2000 < nsteps), tag=tag,
                                 keep_slots=run["det_slots"])
    return torch.cat(losses).tolist() if losses else []


def _idp_loop(run: dict, opt_cfg: OptimizationConfig, warm, step,
              curriculum, after_densify, densify, warm_per_id: int,
              log_every: int, seed: int, group, tag: str,
              mouth: bool) -> list:
    """The identity-parallel schedule (the JAX package's
    ``_pretrain_face_idp`` / ``_pretrain_mouth_idp``): warm-up identity by
    identity, each on its rank, then ``opt_cfg.iterations`` steps that
    train every identity at once. Every rank replays every identity's
    draws from the one seeded ``rng`` (frames, and the mouth's rotated
    partners) and takes its own; ``curriculum(rng, meta, stack, step,
    warm_step, select_iter)`` draws a frame. Updates this rank's entry of
    ``run["states"]`` and ``run["gopts"]``; returns the per-step losses,
    each the mean over the identities."""
    n, rank = run["n"], world(group)[0]
    iterations = opt_cfg.iterations
    densify_until = iterations - 1000
    select_iter = max(iterations - 10000, 1)
    interval = opt_cfg.densification_interval
    rng = np.random.default_rng(seed)
    stacks: list[list[int]] = [[] for _ in range(n)]
    state, gopt = run["states"][rank], run["gopts"][rank]
    batch = run["batches"][rank]
    t0 = time.time()

    for sid in range(n):
        it = 1
        while it <= warm_per_id:
            end = min(warm_per_id, it + 99)
            idxs = [curriculum(rng, run["metas"][sid], stacks[sid], s,
                               warm_per_id + 1, select_iter)
                    for s in range(it, end + 1)]
            if sid == rank:
                state, gopt, _ = warm(state, gopt, batch, idxs,
                                      range(it, end + 1))
            it = end + 1

    losses: list[torch.Tensor] = []      # one [steps, n] tensor per block
    it = 1
    while it <= iterations:
        end = min(iterations, ((it - 1) // interval + 1) * interval,
                  ((it - 1) // 1000 + 1) * 1000)
        steps = range(it, end + 1)
        fidx = [[curriculum(rng, run["metas"][k], stacks[k], warm_per_id + s,
                            warm_per_id, select_iter) for k in range(n)]
                for s in steps]
        others = ([[(k + 1 + int(rng.integers(max(n - 1, 1)))) % n
                    if n > 1 else k for k in range(n)] for _ in steps]
                  if mouth else [[None] * n for _ in steps])
        block_losses = []
        for s, row, orow in zip(steps, fidx, others):
            flags = PretrainFlags(
                use_regs=1.0,
                hair_paint=0.0 if mouth else float(s % 7 != 0))
            state, gopt, loss = step(state, gopt, batch, row[rank], s, flags,
                                     orow[rank])
            block_losses.append(loss)
        losses.append(all_gather(torch.stack(block_losses), group).T)
        it = end + 1

        if end % 1000 == 0:
            state = G.one_up_sh_degree(state)
        if opt_cfg.densify_from_iter < end < densify_until \
                and end % interval == 0:
            floor = 0.05 + 0.25 * end / max(densify_until, 1)
            state, gopt = densify(state, gopt, floor)
            state, gopt = after_densify(state, gopt,
                                        batch.camera_center[fidx[-1][rank]])
        if end % log_every < len(steps):
            check_replicas(replica_tensors_of(step.motion), group)
            pts = all_gather(state.num_alive(), group).tolist()
            if rank == 0:
                print(f"[{tag} idp {end}/{iterations}] "
                      f"loss={float(losses[-1].mean()):.4f} pts={pts} "
                      f"t={time.time() - t0:.0f}s", flush=True)
    run["states"][rank], run["gopts"][rank] = state, gopt
    return torch.cat(losses).mean(-1).tolist() if losses else []


def replica_tensors_of(motion) -> dict:
    """The replicated tensors of an identity-parallel run: the UMF and its
    EMA."""
    return {**{f"umf.{k}": p for k, p in motion.umf_net.named_parameters()},
            **{f"ema.{k}": p for k, p in motion.ema_net.named_parameters()}}


def _gather_run(run: dict, step, group) -> None:
    """Every identity's cloud, Adam state and PMF from its rank, in place
    of ``run``'s and the step's copies, so that every rank returns the
    serial loop's result."""
    rank = world(group)[0]
    run["states"] = gather_identities(run["states"][rank], group)
    run["gopts"] = gather_identities(run["gopts"][rank], group)
    step.refresh_others()


def pretrain_face(model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
                  data_list: list[str], *, log_every: int = 500,
                  seed: int = 0, warm_per_id: int = 1000,
                  identity_block: int = 25, share_audio_net: bool = False,
                  stream: bool | None = None, stream_threshold: int = 1000,
                  umf_net: nn.Module | None = None,
                  pmf_nets: list | None = None,
                  device: str | torch.device = "cuda",
                  identity_parallel: bool = False, group=None) -> dict:
    """Face UMF pre-training over the identities ``data_list`` (directories
    under ``model_cfg.source_path``) on ``device``: ``opt_cfg.iterations``
    steps an identity, the first ``warm_per_id`` an identity in warm-up.

    ``umf_net`` and ``pmf_nets`` (one a identity) are the starting nets,
    trained in place and moved to ``device``; absent, they start from
    ``seed`` through ``torch.Generator``s. Identity k's cloud starts from
    ``random_init_points(init_num, seed + k)``; the identity and frame
    draws come from ``numpy.random.default_rng(seed)`` and the split
    children from a ``torch.Generator`` seeded with ``seed`` on ``device``.
    ``stream`` keeps each identity's frames in host memory and uploads a
    block's frames (by default when any identity has more than
    ``stream_threshold`` frames). Returns the JAX loop's result with nets
    for its trees: ``umf_net``, ``ema_net`` (the EMA of the UMF),
    ``umf_opt_state`` (the UMF optimizer as an optax state dict),
    ``pmf_nets``, and the per-identity ``states`` and ``gopts``, with
    ``data_list``, the per-step ``losses`` and the raster ``cfg``.

    ``identity_parallel`` trains one identity a rank of the process
    ``group`` (``parallel.identity_parallel``; the JAX package's
    identity-parallel path): after each identity's warm-up, on its rank,
    ``opt_cfg.iterations`` steps train every identity at once; at the end
    every rank holds every identity's cloud, Adam state and PMF, and the
    losses are the means over the identities. It needs as many ranks as
    identities and refuses streaming, as in the JAX package."""
    dev = resolve_device(device)
    only = None
    if identity_parallel:
        check_identity_ranks(len(data_list), world(group)[1])
        only = world(group)[0]
    run = _start(model_cfg, opt_cfg, data_list, False, seed, stream,
                 stream_threshold, dev, "pretrain_face", only)
    n = run["n"]
    if umf_net is None:
        umf_net = init_motion_params(MotionNetwork(model_cfg.audio_extractor),
                                     torch.Generator().manual_seed(seed))
    if pmf_nets is None:
        pmf_nets = [init_motion_params(
            PersonalizedMotionNetwork("face", model_cfg.audio_extractor),
            torch.Generator().manual_seed(seed + 1 + k)) for k in range(n)]
    if len(pmf_nets) != n:
        raise ValueError(f"{len(pmf_nets)} PMFs for {n} identities")
    umf_net = umf_net.to(dev)
    pmf_nets = [p.to(dev) for p in pmf_nets]
    ema_net = copy.deepcopy(umf_net).requires_grad_(False)

    extent = run["extents"][0]
    warm = make_warm_step(run["cfg"], opt_cfg, extent, False, dev)
    step = make_pretrain_face_step(
        run["cfg"], opt_cfg, umf_net, pmf_nets, ema_net, extent,
        run["select_iter"], run["iterations"], share_audio_net, dev)
    warm_step = warm_per_id * n

    def motion(state, gopt, sid, other, blk, i, s, flags):
        return step(state, gopt, sid, blk, i, s, flags)

    if identity_parallel:
        replicate(umf_net, group)
        idp = make_idp_pretrain_step(step, group, share_audio_net)
        gen = torch.Generator(dev).manual_seed(seed + 7)
        densify = make_idp_densify(opt_cfg, extent, n, group)
        losses = _idp_loop(
            run, opt_cfg, warm, idp,
            lambda rng, meta, stack, s, ws, si: _sample_face_curriculum(
                rng, meta, stack, s, ws, si, 15),
            lambda st, go, campos: (st, go),
            lambda st, go, floor: densify(st, go, gen, floor), warm_per_id,
            log_every, seed, group, "pretrain_face", mouth=False)
        _gather_run(run, idp, group)
    else:
        losses = _loop(
            run, opt_cfg, warm, motion,
            lambda rng, meta, stack, s: _sample_face_curriculum(
                rng, meta, stack, s, warm_step, run["select_iter"], 15),
            lambda st, go, campos: _prune_green(st, go, campos),
            lambda rng, sid: sid, warm_step, identity_block, log_every, seed,
            dev, "pretrain_face", mean_last=False)
    return dict(umf_net=umf_net, ema_net=ema_net,
                umf_opt_state=umf_opt_to_dict(umf_net, step.umf_opt,
                                              step.umf_sched),
                pmf_nets=pmf_nets, states=run["states"], gopts=run["gopts"],
                data_list=list(data_list), losses=losses, cfg=run["cfg"])


def pretrain_mouth(model_cfg: ModelConfig, opt_cfg: OptimizationConfig,
                   data_list: list[str], face_result: dict, *,
                   log_every: int = 500, seed: int = 0,
                   warm_per_id: int = 3000, identity_block: int = 25,
                   stream: bool | None = None, stream_threshold: int = 1000,
                   umf_net: nn.Module | None = None,
                   pmf_nets: list | None = None,
                   device: str | torch.device = "cuda",
                   identity_parallel: bool = False, group=None) -> dict:
    """Mouth UMF pre-training under a face pre-training result
    ``face_result`` (its per-identity ``states`` and its ``ema_net``, both
    frozen), as ``pretrain_face`` runs the face: identity k's mouth cloud
    starts from ``random_init_points(init_num, seed + 7k)`` halved and
    moved down by 0.05; absent nets start from ``seed + 99`` on. Each motion
    block draws one contrastive partner among the other identities, after
    its frames. Returns the same keys as ``pretrain_face``.
    ``identity_parallel`` and ``group`` as there: each rank trains its
    identity under that identity's face cloud, with a contrastive partner
    a step for every identity (JAX's rotation)."""
    dev = resolve_device(device)
    only = None
    if identity_parallel:
        check_identity_ranks(len(data_list), world(group)[1])
        only = world(group)[0]
    run = _start(model_cfg, opt_cfg, data_list, True, seed, stream,
                 stream_threshold, dev, "pretrain_mouth", only)
    n = run["n"]
    if umf_net is None:
        umf_net = init_motion_params(
            MouthMotionNetwork(model_cfg.audio_extractor),
            torch.Generator().manual_seed(seed + 99))
    if pmf_nets is None:
        pmf_nets = [init_motion_params(
            PersonalizedMotionNetwork("mouth", model_cfg.audio_extractor),
            torch.Generator().manual_seed(seed + 100 + k)) for k in range(n)]
    if len(pmf_nets) != n:
        raise ValueError(f"{len(pmf_nets)} PMFs for {n} identities")
    umf_net = umf_net.to(dev)
    pmf_nets = [p.to(dev) for p in pmf_nets]
    ema_net = copy.deepcopy(umf_net).requires_grad_(False)
    face_states = [s.to(dev) for s in face_result["states"]]
    face_net = face_result["ema_net"].to(dev)

    extent = run["extents"][0]
    warm = make_warm_step(run["cfg"], opt_cfg, extent, True, dev)
    step = make_pretrain_mouth_step(
        run["cfg"], opt_cfg, umf_net, pmf_nets, ema_net, face_states,
        face_net, extent, run["select_iter"], run["iterations"], dev)
    warm_step = warm_per_id * n

    def draw_other(rng, sid):
        if n == 1:
            return sid
        return int(rng.choice([k for k in range(n) if k != sid]))

    def meta_curriculum(rng, meta, stack, s):
        return sample_mouth_curriculum(rng, meta.au25, meta.au25_pcts,
                                       meta.mouth_px, stack, s, warm_step,
                                       run["select_iter"], 7)

    if identity_parallel:
        replicate(umf_net, group)
        idp = make_idp_pretrain_mouth_step(step, group)
        gen = torch.Generator(dev).manual_seed(seed + 13)
        densify = make_idp_densify(opt_cfg, extent, n, group)
        losses = _idp_loop(
            run, opt_cfg, warm, idp,
            lambda rng, meta, stack, s, ws, si: sample_mouth_curriculum(
                rng, meta.au25, meta.au25_pcts, meta.mouth_px, stack, s, ws,
                si, 7),
            lambda st, go, campos: (_soften_green(st, campos), go),
            lambda st, go, floor: densify(st, go, gen, floor), warm_per_id,
            log_every, seed, group, "pretrain_mouth", mouth=True)
        _gather_run(run, idp, group)
    else:
        losses = _loop(
            run, opt_cfg, warm, step, meta_curriculum,
            lambda st, go, campos: (_soften_green(st, campos), go),
            draw_other, warm_step, identity_block, log_every, seed, dev,
            "pretrain_mouth", mean_last=True)
    return dict(umf_net=umf_net, ema_net=ema_net,
                umf_opt_state=umf_opt_to_dict(umf_net, step.umf_opt,
                                              step.umf_sched),
                pmf_nets=pmf_nets, states=run["states"], gopts=run["gopts"],
                data_list=list(data_list), losses=losses, cfg=run["cfg"])
