"""Fused synthesis: the two-branch talking head, frame by frame and as a
clip (counterpart of instag_tpu/synthesize.py).

Per frame: the face ``render_motion`` (align, optionally personalized),
the mouth ``render_motion_mouth`` reusing the face UMF prediction as its
motion cache, optional mouth-alpha max-pool dilation (k=13), then the alpha
composite over the per-frame torso background, as uint8 [H, W, 3].

A clip runs in chunks of ``DISPATCH_CHUNK`` frames, with three selection
modes, as in the JAX package: exact (every frame selects its tiles' splats
afresh), ``select_every`` k (a fresh selection every k-th frame, reused in
between) and ``select_auto`` (a branch reuses its last selection until the
largest projected move of a splat visible then and now exceeds a threshold
in pixels, and then selects afresh for that same frame). Where the JAX
package decides the refresh with ``lax.cond`` on the device, the port reads
the decision on the host, once per branch per frame.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .device import resolve_device
from .models.gaussians import GaussianState
from .models.motion import (MotionNetwork, MouthMotionNetwork,
                            PersonalizedMotionNetwork)
from .ops.rasterize import RasterizeConfig, tile_select
from .render import (Camera, composite_fuse, dilate_alpha, render_motion,
                     render_motion_mouth)
from .utils.spans import span, spanned

DISPATCH_CHUNK = 4
FETCH_WINDOW = 64           # frames copied to the host at a time


@dataclasses.dataclass
class SynthesisModel:
    """The clip-constant model: both clouds and their motion networks."""
    face_state: GaussianState
    mouth_state: GaussianState
    face_umf: MotionNetwork
    mouth_umf: MouthMotionNetwork
    face_pmf: PersonalizedMotionNetwork
    mouth_pmf: PersonalizedMotionNetwork


def _render(cfg: RasterizeConfig, model: SynthesisModel, cam: Camera,
            aud: torch.Tensor, exp: torch.Tensor, torso_bg: torch.Tensor,
            personalized: bool, dilate: bool, sels=None):
    """(fused float image [3, H, W], face render, mouth render); ``sels``
    the (face, mouth) selections to reuse or the selection callables."""
    face_sel, mouth_sel = sels if sels is not None else (None, None)
    green = torch.tensor([0.0, 1.0, 0.0], device=aud.device)
    with span("render.face"):
        fr = render_motion(cfg, cam, model.face_state, umf=model.face_umf,
                           aud=aud, exp=exp, bg=green, pmf=model.face_pmf,
                           personalized=personalized, align=True,
                           selection=face_sel)
    with span("render.mouth"):
        mr = render_motion_mouth(cfg, cam, model.mouth_state,
                                 mouth_umf=model.mouth_umf,
                                 face_state=model.face_state, face_umf=None,
                                 aud=aud, bg=green, pmf=model.mouth_pmf,
                                 personalized=personalized, align=True,
                                 face_motion_cache=fr.motion,
                                 selection=mouth_sel)
    with span("render.fuse"):
        alpha_m = mr.out.alpha
        dil = dilate_alpha(alpha_m, 13) if dilate else alpha_m
        image = composite_fuse(fr.out.image, fr.out.alpha, mr.out.image,
                               alpha_m, green, torso_bg,
                               mouth_dilate_alpha=dil)
    return image, fr, mr


def synthesize_frame(cfg: RasterizeConfig, model: SynthesisModel,
                     cam: Camera, aud: torch.Tensor, exp: torch.Tensor,
                     torso_bg: torch.Tensor, personalized: bool = False,
                     dilate: bool = False) -> torch.Tensor:
    """One fused frame as a float image [3, H, W] (not clipped)."""
    return _render(cfg, model, cam, aud, exp, torso_bg, personalized,
                   dilate)[0]


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """[3, H, W] float in [0, 1] -> uint8 [H, W, 3]."""
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8).permute(1, 2, 0)


def make_synthesis_fn(cfg: RasterizeConfig, dilate: bool = False,
                      personalized: bool = False, variants: bool = False,
                      device: str | torch.device = "cuda",
                      _return_one: bool = False):
    """Build the per-frame synthesis step
    ``fn(model, cam, aud, exp, torso_bg) -> uint8 [H, W, 3]`` on ``device``;
    the model must already live there. With ``variants`` the composite,
    face-branch and mouth-branch images come back stacked, uint8
    [3, H, W, 3]. ``_return_one`` also returns ``synth_one(model, cam, aud,
    exp, torso_bg, sels=None) -> (image(s), (face_sel, mouth_sel),
    (face_prep, mouth_prep))``, where ``sels`` are a previous frame's
    selections to reuse or selection callables."""
    dev = resolve_device(device)

    @torch.inference_mode()
    @spanned("synth.frame")
    def synth_one(model: SynthesisModel, cam: Camera, aud: torch.Tensor,
                  exp: torch.Tensor, torso_bg: torch.Tensor, sels=None):
        if model.face_state.params.xyz.device.type != dev.type:
            raise ValueError(f"model lives on "
                             f"{model.face_state.params.xyz.device}, not {dev}")
        image, fr, mr = _render(cfg, model, cam.to(dev), aud.to(dev),
                                exp.to(dev), torso_bg.to(dev), personalized,
                                dilate, sels)
        with span("render.fuse"):
            if variants:
                img = torch.stack([to_u8(image), to_u8(fr.out.image),
                                   to_u8(mr.out.image)])
            else:
                img = to_u8(image)
        return img, (fr.selection, mr.selection), (fr.prep, mr.prep)

    def synth(model: SynthesisModel, cam: Camera, aud: torch.Tensor,
              exp: torch.Tensor, torso_bg: torch.Tensor) -> torch.Tensor:
        return synth_one(model, cam, aud, exp, torso_bg)[0]

    return (synth, synth_one) if _return_one else synth


def _frame_args(batch, i: int):
    return (batch.camera(i), batch.auds[i], batch.au_exp[i],
            batch.bg_image(i))


def make_synthesis_chunk_fn(cfg: RasterizeConfig, dilate: bool = False,
                            personalized: bool = False,
                            variants: bool = False,
                            chunk: int = DISPATCH_CHUNK,
                            select_every: int = 1,
                            device: str | torch.device = "cuda"):
    """``fn(model, batch, ivec) -> uint8 [len(ivec), ...]``: the frames
    ``ivec`` (host ints) in order. ``select_every`` k > 1 selects afresh on
    every k-th frame and reuses that selection for the k - 1 after it
    (projection, colours, alpha and the composite stay per-frame exact); k
    must divide the chunk."""
    if select_every < 1:
        raise ValueError(f"select_every must be >= 1, got {select_every}")
    if chunk % select_every != 0:
        raise ValueError(f"select_every={select_every} must divide the "
                         f"dispatch chunk ({chunk})")
    _, synth_one = make_synthesis_fn(cfg, dilate, personalized, variants,
                                     device, _return_one=True)

    def synth_chunk(model: SynthesisModel, batch, ivec) -> torch.Tensor:
        imgs = []
        for g in np.asarray(ivec).reshape(-1, select_every):
            sels = None
            for j, i in enumerate(g):
                img, sels, _ = synth_one(model, *_frame_args(batch, int(i)),
                                         sels if j else None)
                imgs.append(img)
        return torch.stack(imgs)

    return synth_chunk


def make_synthesis_chunk_auto_fn(cfg: RasterizeConfig, dilate: bool = False,
                                 personalized: bool = False,
                                 variants: bool = False,
                                 thresh_px: float = 4.0,
                                 device: str | torch.device = "cuda"):
    """Staleness-guarded selection reuse (``select_auto``). Each branch
    keeps its last selection and the projected px, py and visibility of
    the frame that selected it. Every frame measures, between projection
    and composite, the largest move max(|dx|, |dy|) of a splat visible both
    then and now; above ``thresh_px`` the branch selects afresh from this
    frame's projection and composites with that (no frame of lag).

    Returns ``(boot, step)``: ``boot(model, batch, ivec) -> (imgs, carry)``
    renders ``ivec[0]`` with a fresh selection and then the rest;
    ``step(model, batch, ivec, carry) -> (imgs, carry)`` continues. The
    carry's ``"refreshes"`` counts fresh selections per branch (int32 [2]
    on the device, the boot frame counted), as the JAX package's carry
    does."""
    _, synth_one = make_synthesis_fn(cfg, dilate, personalized, variants,
                                     device, _return_one=True)

    def chooser(ref: dict, log: list):
        """Selection callable for ``prepare``: the guarded refresh."""
        def choose(proj, px, py):
            d = torch.maximum((px - ref["px"]).abs(), (py - ref["py"]).abs())
            both = proj.visible & ref["visible"]
            stale = torch.where(both, d, torch.zeros_like(d)).max()
            # the one host read of the mode, per branch and frame
            refresh = bool(stale > thresh_px)
            if refresh:
                ids, valid = tile_select(cfg, proj)
                new = dict(sel=(ids, valid), px=px, py=py,
                           visible=proj.visible)
            else:
                new = ref
            log.append((refresh, new))
            return new["sel"]
        return choose

    def body(model, batch, carry, i: int):
        logs = ([], [])
        img, _, _ = synth_one(model, *_frame_args(batch, i),
                              (chooser(carry["face"], logs[0]),
                               chooser(carry["mouth"], logs[1])))
        (f_ref, face), = logs[0]
        (m_ref, mouth), = logs[1]
        step = torch.tensor([f_ref, m_ref], dtype=torch.int32,
                            device=carry["refreshes"].device)
        return img, dict(face=face, mouth=mouth,
                         refreshes=carry["refreshes"] + step)

    def step(model: SynthesisModel, batch, ivec, carry):
        imgs = []
        for i in np.asarray(ivec):
            img, carry = body(model, batch, carry, int(i))
            imgs.append(img)
        return torch.stack(imgs), carry

    def boot(model: SynthesisModel, batch, ivec):
        ivec = np.asarray(ivec)
        img0, (fsel, msel), (fprep, mprep) = synth_one(
            model, *_frame_args(batch, int(ivec[0])))
        carry = dict(
            face=dict(sel=fsel, px=fprep.px, py=fprep.py,
                      visible=fprep.proj.visible),
            mouth=dict(sel=msel, px=mprep.px, py=mprep.py,
                       visible=mprep.proj.visible),
            refreshes=torch.ones(2, dtype=torch.int32, device=img0.device))
        imgs, carry = step(model, batch, ivec[1:], carry)
        return torch.cat([img0[None], imgs]), carry

    return boot, step


@torch.inference_mode()
def export_deformed_plys(model: SynthesisModel, batch,
                         out_dir: str, n_frames: int = 11,
                         personalized: bool = False) -> None:
    """Write the first ``n_frames`` deformed face clouds as
    ``deformed_<i>.ply`` (the reference's save_deformed_ply)."""
    from .io.checkpoints import save_gaussian_ply

    state = model.face_state
    xyz0 = state.params.xyz
    for i in range(min(n_frames, batch.num_frames)):
        aud, exp = batch.auds[i], batch.au_exp[i]
        p = model.face_pmf(xyz0, aud, exp)
        d_xyz = model.face_umf(xyz0 + p["p_xyz"], aud, exp)["d_xyz"]
        if personalized:
            d_xyz = d_xyz + p["d_xyz"]
        xyz = xyz0 + d_xyz * p["p_scale"]
        save_gaussian_ply(os.path.join(out_dir, f"deformed_{i}.ply"),
                          state.replace(params=dataclasses.replace(
                              state.params, xyz=xyz)))


def synthesize(model_cfg, model: SynthesisModel, split: str = "val",
               audio_file: str = "", dilate: bool = False,
               personalized: bool = False, out_path: str | None = None,
               fps: int = 25, max_frames: int | None = None,
               dump_plys: int = 0, ply_dir: str = "", fast: bool = True,
               select_every: int = 1, select_auto: float = 0.0,
               device: str | torch.device = "cuda"):
    """Render the clip of ``model_cfg.source_path``'s ``split`` (or of
    ``audio_file``'s features); returns (frames [T, H, W, 3] uint8 on the
    host, frames per second over the timed run). The model must live on
    ``device``.

    The frames stay on the device and are copied to the host
    ``FETCH_WINDOW`` at a time. The first chunk (and, with ``select_auto``,
    the second) is rendered once before the timed run, as the JAX package
    compiles on it. With ``fast=False`` and an ``out_path`` the face- and
    mouth-branch clips and the ground truth are written beside it
    (out_face, out_mouth, gt), and with ``dump_plys`` the first deformed
    face clouds go to ``ply_dir``.
    """
    from .data.dataset import load_frames
    from .train.common import build_frame_batch

    dev = resolve_device(device)
    records = load_frames(model_cfg.source_path, split,
                          model_cfg.audio_extractor, -1,
                          audio_file=audio_file, device=dev)
    if max_frames:
        records = records[:max_frames]
    batch = build_frame_batch(records, device=dev)
    h, w = records[0].height, records[0].width
    cfg = RasterizeConfig(h, w, max_per_tile=model_cfg.max_per_tile)

    variants = (not fast) and out_path is not None
    if select_auto > 0 and select_every > 1:
        raise ValueError("--select_auto and --select_every are mutually "
                         "exclusive serving modes")
    if select_auto > 0:
        boot_fn, step_fn = make_synthesis_chunk_auto_fn(
            cfg, dilate, personalized, variants, thresh_px=select_auto,
            device=dev)
    else:
        synth_full = make_synthesis_chunk_fn(
            cfg, dilate, personalized, variants, select_every=select_every,
            device=dev)

    if dump_plys:
        export_deformed_plys(model, batch,
                             ply_dir or os.path.dirname(out_path or "."),
                             n_frames=dump_plys, personalized=personalized)

    carry = None

    def synth(ivec, first: bool):
        nonlocal carry
        if select_auto <= 0:
            return synth_full(model, batch, ivec)
        if first:
            imgs, carry = boot_fn(model, batch, ivec)
        else:
            imgs, carry = step_fn(model, batch, ivec, carry)
        return imgs

    nf = batch.num_frames
    idx_all = np.minimum(np.arange(-(-nf // DISPATCH_CHUNK)
                                   * DISPATCH_CHUNK), nf - 1)
    chunks = idx_all.reshape(-1, DISPATCH_CHUNK)
    synth(chunks[0], True).cpu()            # warm-up, as the JAX compile
    if select_auto > 0 and len(chunks) > 1:
        synth(chunks[1], False).cpu()
    carry = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    frames, pending = [], []
    for ci, ch in enumerate(chunks):
        pending.append(synth(ch, ci == 0))
        if len(pending) * DISPATCH_CHUNK >= FETCH_WINDOW:
            frames.append(torch.cat(pending).cpu().numpy())
            pending = []
    if pending:
        frames.append(torch.cat(pending).cpu().numpy())
    dt = time.time() - t0
    achieved_fps = nf / max(dt, 1e-9)
    if select_auto > 0 and carry is not None:
        nf_ref, nm_ref = (int(x) for x in carry["refreshes"].tolist())
        print(f"[synthesize] select_auto({select_auto:g}px): "
              f"face {nf_ref}/{len(idx_all)}, mouth {nm_ref}/{len(idx_all)} "
              f"selection refreshes")

    stacked = np.concatenate(frames, axis=0)[:nf]
    if variants:
        video = stacked[:, 0]
        base = os.path.dirname(out_path) or "."
        for name, clip in (("out_face.mp4", stacked[:, 1]),
                           ("out_mouth.mp4", stacked[:, 2]),
                           ("gt.mp4", torch.stack(
                               [r.image for r in records]).cpu().numpy())):
            print(f"[synthesize] wrote "
                  f"{write_video(os.path.join(base, name), clip, fps)}")
    else:
        video = stacked
    if out_path:
        print(f"[synthesize] wrote {write_video(out_path, video, fps)}")
    return video, achieved_fps


def write_video(out_path: str, video: np.ndarray, fps: int = 25) -> str:
    """Write [T, H, W, 3] uint8 frames to an mp4 through OpenCV when it
    imports and opens a writer, else as ``<out_path>.frames.npz``; returns
    the path written."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        h, w = video.shape[1:3]
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
        ok = writer.isOpened()
        if ok:
            for frame in video:
                writer.write(frame[:, :, ::-1])  # RGB -> BGR
        writer.release()
        if ok:
            return out_path
    np.savez_compressed(out_path + ".frames.npz", video=video, fps=fps)
    return out_path + ".frames.npz"
