"""Render paths of the synthesis frame (counterpart of instag_tpu/render.py):
the face-motion branch, the mouth-motion branch conditioned on the face
motion, and their fusion.

Conventions kept from the JAX package:
  * deltas compose as UMF + PMF: ``d += p_d``; ``xyz += p_xyz`` (align) feeds
    the UMF only; ``d_xyz *= p_scale`` (align); the splats move from the
    *unaligned* positions, ``means3d = xyz0 + d_xyz``;
  * scales activate as softplus(raw + d_scale), rotations as
    safe_normalize(raw + d_rot); opacity ignores d_opa;
  * mouth: move feature = [k-th largest, k-th smallest, range] of the face
    d_xyz.y over alive face slots, times 1e2, with top-k at ``k_max`` and
    the k index clamped to the alive count; the mouth uses its raw
    rotations and scales.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as Fn

from .models.gaussians import GaussianState
from .ops.rasterize import (Prepared, RasterizeConfig, RasterizeOutput,
                            composite_prepared, prepare, rasterize,
                            sh_colors)
from .utils.general import safe_normalize


@dataclasses.dataclass
class Camera:
    """Per-frame camera (transposed, row-vector matrices)."""
    view_transform: torch.Tensor       # [4,4] world->view
    full_proj_transform: torch.Tensor  # [4,4] world->ndc
    camera_center: torch.Tensor        # [3]
    tanfovx: torch.Tensor              # scalar
    tanfovy: torch.Tensor              # scalar

    def to(self, device) -> "Camera":
        return Camera(*(t.to(device) for t in dataclasses.astuple(self)))


def _sh_degree_mask(active_degree: int, max_degree: int, device):
    """[K] 0/1 mask keeping coefficients of degree <= active."""
    idx = torch.arange((max_degree + 1) ** 2, device=device)
    deg = torch.floor(torch.sqrt(idx.to(torch.float32))).to(torch.int64)
    return (deg <= active_degree).to(torch.float32)


def _masked_features(state: GaussianState) -> torch.Tensor:
    feats = state.get_features()
    mask = _sh_degree_mask(state.active_sh_degree, state.max_sh_degree,
                           feats.device)
    return feats * mask[None, :, None]


def render(cfg: RasterizeConfig, cam: Camera, state: GaussianState,
           bg: torch.Tensor,
           means2d_offset: torch.Tensor | None = None) -> RasterizeOutput:
    """Static render of the cloud, without deformation (pre-training's
    warm-up)."""
    return rasterize(
        cfg, state.params.xyz, state.get_opacity(), state.get_scaling(),
        state.get_rotation(), cam.view_transform, cam.full_proj_transform,
        cam.camera_center, cam.tanfovx, cam.tanfovy, bg,
        shs=_masked_features(state), sh_degree=state.max_sh_degree,
        means2d_offset=means2d_offset, active=state.alive)


class MotionRender(NamedTuple):
    out: RasterizeOutput
    motion: dict[str, Any]
    p_motion: dict[str, Any] | None
    attn: torch.Tensor | None = None      # [3, H, W] UMF attention map
    p_attn: torch.Tensor | None = None    # [3, H, W] PMF attention map
    # this frame's tile lists (ids, valid), to reuse in a later frame
    selection: tuple = ()
    # the projection and selection the composite used
    prep: Prepared | None = None


def render_motion(cfg: RasterizeConfig, cam: Camera, state: GaussianState,
                  umf: Callable[..., dict], aud: torch.Tensor,
                  exp: torch.Tensor, bg: torch.Tensor,
                  pmf: Callable[..., dict] | None = None,
                  personalized: bool = False, align: bool | float = False,
                  return_attn: bool = False,
                  means2d_offset: torch.Tensor | None = None,
                  selection=None) -> MotionRender:
    """Face-branch motion render. ``umf(x, aud, exp)`` and
    ``pmf(x, aud, exp)`` are the motion networks.

    ``align`` is a bool, or a float weight ``align_s`` (the trainer's 0/1
    warm-up flag): any float runs the PMF's align head and applies
    ``xyz + p_xyz align_s`` and ``d_xyz (1 + (p_scale - 1) align_s)``.
    ``return_attn`` composites the attention maps
    ``[ambient_aud, ambient_eye, 0]`` (and the PMF's when personalized) as
    aux channels of the same composite, with stop-gradient weights.
    ``means2d_offset`` [N, 2] is added to the projected means; its gradient
    is the pixel-space position gradient of the densification statistics.
    ``selection``: a previous frame's ``MotionRender.selection`` to reuse,
    or a selection callable (``ops.rasterize.prepare``); either composites
    with the culled splats' opacity zeroed.
    """
    xyz0 = state.params.xyz
    xyz = xyz0

    align_structural = not (isinstance(align, bool) and not align)
    align_s = (1.0 if align else 0.0) if isinstance(align, bool) else align

    p_preds = None
    if personalized or align_structural:
        p_preds = pmf(xyz0, aud, exp)
    if align_structural:
        xyz = xyz + p_preds["p_xyz"] * align_s

    preds = umf(xyz, aud, exp)
    d_xyz, d_scale, d_rot = preds["d_xyz"], preds["d_scale"], preds["d_rot"]
    if personalized:
        d_xyz = d_xyz + p_preds["d_xyz"]
        d_scale = d_scale + p_preds["d_scale"]
        d_rot = d_rot + p_preds["d_rot"]
    if align_structural:
        d_xyz = d_xyz * (1.0 + (p_preds["p_scale"] - 1.0) * align_s)

    means3d = xyz0 + d_xyz
    opacity = state.get_opacity()
    scales = Fn.softplus(state.params.scaling + d_scale)
    rotations = safe_normalize(state.params.rotation + d_rot)

    prep = prepare(cfg, means3d, scales, rotations, cam.view_transform,
                   cam.full_proj_transform, cam.camera_center, cam.tanfovx,
                   cam.tanfovy, means2d_offset=means2d_offset,
                   active=state.alive, selection=selection)
    reused = selection is not None
    colors = sh_colors(means3d, cam.camera_center, _masked_features(state),
                       state.max_sh_degree)
    sel = (prep.ids, prep.valid)
    if not return_attn:
        return MotionRender(composite_prepared(cfg, prep, opacity, colors, bg,
                                               mask_invisible=reused),
                            preds, p_preds, selection=sel, prep=prep)
    aux = [preds["ambient_aud"], preds["ambient_eye"]]
    if personalized:
        aux += [p_preds["ambient_aud"], p_preds["ambient_eye"]]
    out, aux_img = composite_prepared(cfg, prep, opacity, colors, bg,
                                      aux_colors=torch.cat(aux, dim=-1),
                                      mask_invisible=reused)
    zero = torch.zeros_like(aux_img[0])
    attn = torch.stack([aux_img[0], aux_img[1], zero])
    p_attn = (torch.stack([aux_img[2], aux_img[3], zero]) if personalized
              else None)
    return MotionRender(out, preds, p_preds, attn, p_attn, sel, prep)


def _move_feature(face_preds: dict, face_state: GaussianState, k: int,
                  k_max: int) -> torch.Tensor:
    """[1, 3] = [k-th largest, k-th smallest, range] of the alive face
    slots' d_xyz.y, times 1e2 (top-k at k_max, k clamped to the alive
    count; non-finite picks read as 0)."""
    dy = face_preds["d_xyz"][:, 1]
    k_max = min(k_max, dy.shape[0])
    alive = face_state.alive
    inf = torch.tensor(float("inf"), device=dy.device, dtype=dy.dtype)
    top_max = torch.topk(torch.where(alive, dy, -inf), k_max).values
    top_min = torch.topk(-torch.where(alive, dy, inf), k_max).values
    kidx = torch.clamp(torch.clamp_max(alive.sum(), k) - 1, 0, k_max - 1)
    m_hi, m_lo = top_max[kidx], -top_min[kidx]
    zero = torch.zeros((), device=dy.device, dtype=dy.dtype)
    m_hi = torch.where(torch.isfinite(m_hi), m_hi, zero)
    m_lo = torch.where(torch.isfinite(m_lo), m_lo, zero)
    return (torch.stack([m_hi, m_lo, m_hi - m_lo])[None, :] * 1e2).detach()


def render_motion_mouth(cfg: RasterizeConfig, cam: Camera,
                        state: GaussianState, mouth_umf: Callable[..., dict],
                        face_state: GaussianState,
                        face_umf: Callable[..., dict] | None,
                        aud: torch.Tensor, bg: torch.Tensor,
                        pmf: Callable[..., dict] | None = None,
                        personalized: bool = False,
                        align: bool | float = False,
                        k: int = 10, k_max: int = 50,
                        face_motion_cache: dict | None = None,
                        means2d_offset: torch.Tensor | None = None,
                        selection=None) -> MotionRender:
    """Mouth-branch render conditioned on the face UMF's motion range.
    ``pmf(x, aud)`` is the mouth PMF; ``face_motion_cache`` the face
    branch's motion prediction, reused at inference instead of running
    ``face_umf`` with a zero expression. ``align`` is a bool, or the
    trainer's per-step 0/1 float: any float runs the PMF and adds
    ``p_xyz align`` (so ``p_xyz`` exists, for the regulariser, while the
    flag is 0). ``means2d_offset`` [N, 2] is added to the projected means
    and ``selection`` reuses or picks the tile lists (see
    ``render_motion``)."""
    xyz0 = state.params.xyz
    xyz = xyz0

    align_structural = not (isinstance(align, bool) and not align)
    align_s = (1.0 if align else 0.0) if isinstance(align, bool) else align

    p_preds = None
    if personalized or align_structural:
        p_preds = pmf(xyz0, aud)
    if align_structural:
        xyz = xyz + p_preds["p_xyz"] * align_s

    if face_motion_cache is not None:
        face_preds = face_motion_cache
    else:
        zero_exp = torch.zeros((6,), dtype=xyz.dtype, device=xyz.device)
        face_preds = face_umf(face_state.params.xyz, aud, zero_exp)
    move = _move_feature(face_preds, face_state, k, k_max)

    preds = mouth_umf(xyz, aud, move)
    d_xyz = preds["d_xyz"]
    if personalized:
        d_xyz = d_xyz + p_preds["d_xyz"]

    means3d = xyz0 + d_xyz
    prep = prepare(cfg, means3d, state.get_scaling(), state.get_rotation(),
                   cam.view_transform, cam.full_proj_transform,
                   cam.camera_center, cam.tanfovx, cam.tanfovy,
                   means2d_offset=means2d_offset, active=state.alive,
                   selection=selection)
    colors = sh_colors(means3d, cam.camera_center, _masked_features(state),
                       state.max_sh_degree)
    return MotionRender(
        composite_prepared(cfg, prep, state.get_opacity(), colors, bg,
                           mask_invisible=selection is not None),
        preds, p_preds, selection=(prep.ids, prep.valid), prep=prep)


def composite_fuse(face_img, face_alpha, mouth_img, mouth_alpha, bg_color,
                   torso_bg, mouth_dilate_alpha=None):
    """Two-branch fusion: mouth over the torso background, face over that.
    Images [3,H,W], alphas [1,H,W], bg_color [3] (the raster background to
    subtract), torso_bg [3,H,W]."""
    ma = mouth_dilate_alpha if mouth_dilate_alpha is not None else mouth_alpha
    mouth_full = (mouth_img - bg_color[:, None, None] * (1.0 - ma)
                  + torso_bg * (1.0 - ma))
    return (face_img - bg_color[:, None, None] * (1.0 - face_alpha)
            + mouth_full * (1.0 - face_alpha))


def dilate_alpha(alpha: torch.Tensor, k: int = 13) -> torch.Tensor:
    """Max-pool dilation of the mouth alpha [1,H,W] (stride 1, same size)."""
    return Fn.max_pool2d(alpha[None], k, stride=1, padding=k // 2)[0]
