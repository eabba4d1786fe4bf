"""Teeth masks and sapiens geometry priors (tasks 11 and 12; counterpart
of instag_tpu/data_utils/priors.py).

  * ``create_teeth_masks``: boolean [H, W] arrays ``teeth_mask/{id}.npy``,
    True on visible teeth, from the first of three routes that is there: a
    TorchScript segmentation model (``INSTAG_TEETH_MODEL``, class 7 =
    teeth), the EasyPortrait FPN (``INSTAG_EASYPORTRAIT_FPN``, the
    reference's ``fpn-fp-512.pth``), else the inner-mouth polygon of
    landmarks 60-67 (``cv_ops.fill_poly``).
  * ``run_sapiens``: monocular depth [H, W] and normal [H, W, 3] float32
    ``.npy`` priors under ``sapiens/{depth,normal}/sapiens_0.3b/`` for the
    first 500 gt frames, from TorchScript checkpoints
    (``INSTAG_SAPIENS_DEPTH``, ``INSTAG_SAPIENS_NORMAL``); without them it
    raises.

Frames are read through the port's JPEG route and the networks run on
``device``; the resizes are OpenCV's (``cv_ops``).
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..data.image_io import read_jpegs
from ..device import resolve_device
from . import cv_ops

_MEAN = [0.485, 0.456, 0.406]
_STD = [0.229, 0.224, 0.225]


def _normalized(img: np.ndarray, dev: torch.device) -> torch.Tensor:
    """[1, 3, H, W] float32 of a uint8 RGB image, ImageNet-normalized in
    float64 as the JAX package does it."""
    inp = (img.astype(np.float32) / 255.0 - _MEAN) / _STD
    return torch.from_numpy(inp.transpose(2, 0, 1))[None].float().to(dev)


def _frames(paths: list[str], dev: torch.device):
    for s in range(0, len(paths), 32):
        chunk = paths[s:s + 32]
        yield from zip(chunk, read_jpegs(chunk, dev).cpu().numpy())


def create_teeth_masks(base_dir: str, ori_imgs_dir: str,
                       use_fallback: bool = True,
                       device: str | torch.device = "cuda") -> None:
    """Write ``teeth_mask/{id}.npy`` for every frame."""
    dev = resolve_device(device)
    out_dir = os.path.join(base_dir, "teeth_mask")
    os.makedirs(out_dir, exist_ok=True)
    model_path = os.environ.get("INSTAG_TEETH_MODEL", "weights/teeth_fpn.pt")
    fpn_path = os.environ.get("INSTAG_EASYPORTRAIT_FPN",
                              "weights/fpn-fp-512.pth")

    model = fpn = None
    if os.path.exists(model_path):
        model = torch.jit.load(model_path, map_location=dev).eval()
    elif os.path.exists(fpn_path):
        from .easyportrait_fpn import load_fpn_fp
        fpn = load_fpn_fp(fpn_path, dev)
    elif not use_fallback:
        raise RuntimeError(
            f"teeth segmentation model not found at {model_path}; set "
            "INSTAG_TEETH_MODEL or enable the landmark fallback")

    for image_path, img in _frames(
            sorted(glob.glob(os.path.join(ori_imgs_dir, "*.jpg"))), dev):
        img_id = os.path.basename(image_path).split(".")[0]
        h, w = img.shape[:2]
        if model is not None:
            with torch.no_grad():
                seg = model(_normalized(cv_ops.resize_linear(
                    img, (512, 512)), dev))[0]
            cls = seg.argmax(0).cpu().numpy().astype(np.uint8)
            teeth = cv_ops.resize_nearest((cls == 7).astype(np.uint8),
                                          (w, h)).astype(bool)
        elif fpn is not None:
            from .easyportrait_fpn import TEETH_CLASS, segment
            teeth = segment(fpn, img) == TEETH_CLASS
        else:
            # the inner-mouth polygon (landmarks 60-67)
            lms_path = image_path.replace(".jpg", ".lms")
            teeth = np.zeros((h, w), bool)
            if os.path.exists(lms_path):
                poly = np.loadtxt(lms_path)[60:68].astype(np.int32)
                mask = cv_ops.fill_poly(np.zeros((h, w), np.uint8), poly, 1)
                teeth = mask.astype(bool)
        np.save(os.path.join(out_dir, f"{img_id}.npy"), teeth)
    src = ("torchscript model" if model is not None else
           "EasyPortrait FPN" if fpn is not None else "landmark fallback")
    print(f"[teeth] wrote masks to {out_dir} ({src})")


def run_sapiens(base_dir: str, max_frames: int = 500,
                device: str | torch.device = "cuda") -> None:
    """Write ``sapiens/{depth,normal}/sapiens_0.3b/{id}.npy`` for the first
    ``max_frames`` gt frames (the reference's budget): each frame resized
    to 768x1024 for the networks, their outputs resized back (OpenCV's
    bilinear) and the normals renormalized."""
    dev = resolve_device(device)
    depth_path = os.environ.get("INSTAG_SAPIENS_DEPTH", "")
    normal_path = os.environ.get("INSTAG_SAPIENS_NORMAL", "")
    if not (depth_path and os.path.exists(depth_path)
            and normal_path and os.path.exists(normal_path)):
        raise RuntimeError(
            "sapiens torchscript checkpoints not found; set "
            "INSTAG_SAPIENS_DEPTH and INSTAG_SAPIENS_NORMAL, or copy "
            "precomputed sapiens/{depth,normal}/sapiens_*/{id}.npy outputs "
            "from the reference pipeline — training runs without priors "
            "(the sapiens losses simply stay off)")
    d_model = torch.jit.load(depth_path, map_location=dev).eval()
    n_model = torch.jit.load(normal_path, map_location=dev).eval()
    d_dir = os.path.join(base_dir, "sapiens/depth/sapiens_0.3b")
    n_dir = os.path.join(base_dir, "sapiens/normal/sapiens_0.3b")
    os.makedirs(d_dir, exist_ok=True)
    os.makedirs(n_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(base_dir, "gt_imgs", "*.jpg")),
                   key=lambda p: int(os.path.basename(p).split(".")[0]))
    for p, img in _frames(paths[:max_frames], dev):
        img_id = os.path.basename(p).split(".")[0]
        h, w = img.shape[:2]
        t = _normalized(cv_ops.resize_linear(img, (768, 1024)), dev)
        with torch.no_grad():
            depth = d_model(t)[0, 0].float().cpu().numpy()
            normal = n_model(t)[0].float().cpu().numpy().transpose(1, 2, 0)
        depth = cv_ops.resize_linear_f32(depth, (w, h))
        normal = cv_ops.resize_linear_f32(np.ascontiguousarray(normal),
                                          (w, h))
        normal = normal / np.maximum(
            np.linalg.norm(normal, axis=-1, keepdims=True), 1e-6)
        np.save(os.path.join(d_dir, f"{img_id}.npy"), depth)
        np.save(os.path.join(n_dir, f"{img_id}.npy"), normal)
    print(f"[sapiens] wrote priors for {min(len(paths), max_frames)} frames")
