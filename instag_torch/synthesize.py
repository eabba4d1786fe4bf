"""Fused synthesis: one two-branch talking-head frame (counterpart of
instag_tpu/synthesize.py::make_synthesis_fn).

Per frame: the face ``render_motion`` (align, optionally personalized),
the mouth ``render_motion_mouth`` reusing the face UMF prediction as its
motion cache, optional mouth-alpha max-pool dilation (k=13), then the alpha
composite over the per-frame torso background, as uint8 [H, W, 3].
"""

from __future__ import annotations

import dataclasses

import torch

from .device import resolve_device
from .models.gaussians import GaussianState
from .models.motion import (MotionNetwork, MouthMotionNetwork,
                            PersonalizedMotionNetwork)
from .ops.rasterize import RasterizeConfig
from .render import (Camera, composite_fuse, dilate_alpha, render_motion,
                     render_motion_mouth)


@dataclasses.dataclass
class SynthesisModel:
    """The clip-constant model: both clouds and their motion networks."""
    face_state: GaussianState
    mouth_state: GaussianState
    face_umf: MotionNetwork
    mouth_umf: MouthMotionNetwork
    face_pmf: PersonalizedMotionNetwork
    mouth_pmf: PersonalizedMotionNetwork


def synthesize_frame(cfg: RasterizeConfig, model: SynthesisModel,
                     cam: Camera, aud: torch.Tensor, exp: torch.Tensor,
                     torso_bg: torch.Tensor, personalized: bool = False,
                     dilate: bool = False) -> torch.Tensor:
    """One fused frame as a float image [3, H, W] (not clipped)."""
    green = torch.tensor([0.0, 1.0, 0.0], device=aud.device)
    fr = render_motion(cfg, cam, model.face_state, umf=model.face_umf,
                       aud=aud, exp=exp, bg=green, pmf=model.face_pmf,
                       personalized=personalized, align=True)
    mr = render_motion_mouth(cfg, cam, model.mouth_state,
                             mouth_umf=model.mouth_umf,
                             face_state=model.face_state, face_umf=None,
                             aud=aud, bg=green, pmf=model.mouth_pmf,
                             personalized=personalized, align=True,
                             face_motion_cache=fr.motion)
    alpha_m = mr.out.alpha
    dil = dilate_alpha(alpha_m, 13) if dilate else alpha_m
    return composite_fuse(fr.out.image, fr.out.alpha, mr.out.image, alpha_m,
                          green, torso_bg, mouth_dilate_alpha=dil)


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """[3, H, W] float in [0, 1] -> uint8 [H, W, 3]."""
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8).permute(1, 2, 0)


def make_synthesis_fn(cfg: RasterizeConfig, dilate: bool = False,
                      personalized: bool = False,
                      device: str | torch.device = "cuda"):
    """Build the per-frame synthesis step
    ``fn(model, cam, aud, exp, torso_bg) -> uint8 [H, W, 3]`` on ``device``;
    the model must already live there."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def synth(model: SynthesisModel, cam: Camera, aud: torch.Tensor,
              exp: torch.Tensor, torso_bg: torch.Tensor) -> torch.Tensor:
        if model.face_state.params.xyz.device.type != dev.type:
            raise ValueError(f"model lives on "
                             f"{model.face_state.params.xyz.device}, not {dev}")
        img = synthesize_frame(cfg, model, cam.to(dev), aud.to(dev),
                               exp.to(dev), torso_bg.to(dev),
                               personalized=personalized, dilate=dilate)
        return to_u8(img)

    return synth
