"""Few-shot face adaptation step (counterpart of instag_tpu/train/face.py's
``make_face_block``, serial path, without the LPIPS phase).

One step renders the face branch with the PMF's align head and the UMF
attention maps, and takes the loss of the JAX package's ``step_loss``:
  * L1 + lambda_dssim (1 - SSIM) against the ground truth painted green
    off the head and on the mouth (a 3x3 dilate-then-erode soft mouth mask
    while ``use_lpips``), and on the hair while ``hair_paint``;
  * with ``has_priors``: the sapiens normal prior 0.01 and the depth prior
    1e-2;
  * the motion regularisers 1e-5, the alpha regulariser 1e-3, and the
    lips and hair attention regularisers 1e-4.
Then it takes the Gaussian Adam step at ``gaussian_lrs``, the UMF (AdamW +
LambdaLR) and PMF (Adam) steps, and adds the densification statistics from
the gradient of ``means2d_offset`` and ``radii > 0``.

The JAX package's LPIPS phase needs AlexNet weights that are not in the
repository; it is not part of this step (``lpips_fn=None`` there).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as Fn
from torch import nn

from ..config import OptimizationConfig
from ..device import resolve_device
from ..models import gaussians as G
from ..ops.rasterize import RasterizeConfig
from ..render import render_motion
from ..utils.losses import normalize_depth
from .common import FrameBatch, gaussian_lrs, rect_mask, rgb_loss
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
    """``step(state, gopt, batch, i, it, flags) -> (state, gopt, loss)``:
    one face adaptation step on frame ``i`` at iteration ``it``. It owns
    the UMF and PMF optimizers; the Gaussian Adam state ``gopt`` is passed
    in and returned, as in the JAX package."""

    def __init__(self, cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                 umf_net: nn.Module, pmf_net: nn.Module,
                 spatial_lr_scale: float, has_priors: bool,
                 device: str | torch.device):
        self.device = resolve_device(device)
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.umf_net, self.pmf_net = umf_net, pmf_net
        self.spatial_lr_scale = spatial_lr_scale
        self.has_priors = has_priors
        self.umf_opt, self.umf_sched = umf_optimizer(umf_net)
        self.pmf_opt = pmf_optimizer(pmf_net)
        self.green = torch.tensor([0.0, 1.0, 0.0], device=self.device)

    def loss(self, state: G.GaussianState, off: torch.Tensor,
             batch: FrameBatch, i: int, flags: Flags):
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
        return loss, out

    def loss_and_grads(self, state: G.GaussianState, batch: FrameBatch,
                       i: int, flags: Flags):
        """(loss, render, Gaussian gradients, means2d_offset gradient) of one
        step, with the UMF and PMF gradients left in their ``.grad`` (zeros
        where a parameter does not reach the loss, as in the JAX package,
        so that weight decay still applies to it)."""
        if state.params.xyz.device.type != self.device.type:
            raise ValueError(f"state lives on {state.params.xyz.device}, "
                             f"not {self.device}")
        leaves = G.GaussianParams(**{
            n: getattr(state.params, n).detach().requires_grad_(True)
            for n in G.PARAM_FIELDS})
        off = torch.zeros((state.capacity, 2), device=self.device,
                          requires_grad=True)
        self.umf_opt.zero_grad(set_to_none=True)
        self.pmf_opt.zero_grad(set_to_none=True)
        loss, out = self.loss(state.replace(params=leaves), off, batch, i,
                              flags)
        loss.backward()
        for net in (self.umf_net, self.pmf_net):
            for p in net.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        grads = G.GaussianParams(**{
            n: (getattr(leaves, n).grad if getattr(leaves, n).grad is not None
                else torch.zeros_like(getattr(leaves, n)))
            for n in G.PARAM_FIELDS})
        return loss.detach(), out, grads, off.grad

    def __call__(self, state: G.GaussianState, gopt: G.AdamState,
                 batch: FrameBatch, i: int, it: int, flags: Flags):
        loss, out, grads, g_off = self.loss_and_grads(state, batch, i, flags)
        lrs = gaussian_lrs(self.opt_cfg, it, self.spatial_lr_scale)
        params, gopt = G.adam_update(state.params, grads, gopt, lrs,
                                     state.alive)
        self.umf_opt.step()
        self.umf_sched.step()
        self.pmf_opt.step()
        visible = out.radii > 0
        state = G.add_densification_stats(state.replace(params=params),
                                          g_off, visible)
        state = G.update_max_radii(state, out.radii, visible)
        return state, gopt, loss


def make_face_step(cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                   umf_net: nn.Module, pmf_net: nn.Module,
                   spatial_lr_scale: float, has_priors: bool,
                   device: str | torch.device = "cuda") -> _FaceStep:
    """The face adaptation step on ``device`` (the nets, the state and the
    batch must live there), with the UMF's default learning-rate
    schedule."""
    return _FaceStep(cfg, opt_cfg, umf_net, pmf_net, spatial_lr_scale,
                     has_priors, device)


def make_face_block(cfg: RasterizeConfig, opt_cfg: OptimizationConfig,
                    umf_net: nn.Module, pmf_net: nn.Module,
                    spatial_lr_scale: float, has_priors: bool,
                    device: str | torch.device = "cuda"):
    """``block(state, gopt, batch, idxs, its, flags) -> (state, gopt,
    losses)``: one step per frame index in ``idxs`` at the iterations
    ``its``, all under ``flags``; ``losses`` [n] stays on the device."""
    step = make_face_step(cfg, opt_cfg, umf_net, pmf_net, spatial_lr_scale,
                          has_priors, device)

    def block(state: G.GaussianState, gopt: G.AdamState, batch: FrameBatch,
              idxs, its, flags: Flags):
        losses = []
        for i, it in zip(idxs, its):
            state, gopt, loss = step(state, gopt, batch, int(i), int(it),
                                     flags)
            losses.append(loss)
        return state, gopt, torch.stack(losses)

    return block
