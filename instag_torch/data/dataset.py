"""The talking-head dataset reader (counterpart of
instag_tpu/data/dataset.py): a preprocessed video directory as frame
records, the random initial cloud and the scene extent.

A scene directory holds:

  transforms_{train,val}.json   focal_len and per-frame c2w + img_id
  aud_ds/_eo/_hu/_ave.npy       audio features [T, 16, D]
  au.csv                        OpenFace action units (AU45 blink, AU25, exp)
  ori_imgs/{id}.lms             68 landmarks -> lips and lower-half rects
  gt_imgs/{id}.jpg              ground-truth frames
  torso_imgs/{id}.png, bc.jpg   the per-frame torso over the background
  parsing/{id}.png              colour-coded face parsing
  teeth_mask/{id}.npy           boolean teeth mask
  sapiens/{normal,depth}/...    monocular priors (train split, few-shot)

JPEGs decode on ``device`` (nvJPEG on the card, PIL on the CPU) and the
frame and background images stay there as uint8 tensors; every other field
is numpy on the host, as in the JAX package. A host read (``host=True``,
for a streamed split) decodes ``DECODE_CHUNK`` frames at a time on
``device``, copies each chunk to host memory and frees it, and composites
the torso on the host: its records hold CPU tensors and nothing of the split
stays on the card. PNGs decode with
``image_io.read_png`` and ``au.csv`` reads with the ``csv`` module into
float64 columns. Camera convention: NeRF c2w with OpenGL axes, flipped to
COLMAP by negating the y and z columns; matrices stored transposed.
"""

from __future__ import annotations

import csv
import dataclasses
import glob
import json
import os
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..utils.graphics import focal2fov, projection_matrix, world_to_view
from ..utils.sh import C0
from .audio import window_audio_features
from .image_io import read_jpegs, read_png

AUDIO_POSTFIX = {"deepspeech": "_ds", "esperanto": "_eo", "hubert": "_hu",
                 "ave": "_ave"}


@dataclasses.dataclass
class FrameRecord:
    uid: int
    img_id: int
    width: int
    height: int
    fovx: float
    fovy: float
    view_transform: np.ndarray       # [4,4] transposed W2C
    full_proj_transform: np.ndarray  # [4,4] transposed W2C @ P
    camera_center: np.ndarray        # [3]
    image: torch.Tensor | None       # [H,W,3] uint8, on the reader's device
                                     # (the host for a host read; None
                                     # when read without images)
    bg: torch.Tensor | None          # [H,W,3] uint8 torso over bc.jpg, same
    face_mask: np.ndarray            # [H,W] bool
    hair_mask: np.ndarray
    mouth_mask: np.ndarray
    auds: np.ndarray                 # [8, D, 16] (or [8, 1, 512] for ave)
    blink: float
    au25: tuple                      # (value, p25, p50, p75, max)
    au_exp: np.ndarray               # [6]
    lips_rect: list                  # [xmin, xmax, ymin, ymax] (rows, cols)
    lhalf_rect: list
    mouth_bound: list                # [lb, ub, this frame's mouth opening]
    normal: np.ndarray | None = None  # [H,W,3]
    depth: np.ndarray | None = None   # [H,W]

    @property
    def tanfovx(self):
        return float(np.tan(self.fovx / 2))

    @property
    def tanfovy(self):
        return float(np.tan(self.fovy / 2))


def _camera_matrices(c2w_gl, fovx: float, fovy: float):
    c2w = np.array(c2w_gl, dtype=np.float64)
    c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP
    w2c = np.linalg.inv(c2w)
    R = w2c[:3, :3].T
    T = w2c[:3, 3]
    view = world_to_view(R, T)
    proj = projection_matrix(0.01, 100.0, fovx, fovy)
    view_T = view.T.astype(np.float32)
    full_T = (proj @ view).T.astype(np.float32)
    campos = np.linalg.inv(view)[:3, 3].astype(np.float32)
    return view_T, full_T, campos, R, T


def read_au_csv(path: str) -> dict[str, np.ndarray]:
    """``au.csv`` as float64 columns by header name (names kept as they
    are, as pandas keeps them)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: np.array([float(r[i]) for r in body], np.float64)
            for i, name in enumerate(header)}


# memo of loaded splits (at most _FRAMES_CACHE_MAX): the adaptation stages
# read the same split in turn; callers treat the returned list as immutable
_FRAMES_CACHE: dict[tuple, list[FrameRecord]] = {}
_FRAMES_CACHE_MAX = 3
_FRAMES_LOCK = threading.Lock()

DECODE_CHUNK = 16   # frames a host read decodes on the device at a time


def load_frames(path: str, split: str = "train",
                audio_extractor: str = "deepspeech", n_views: int = -1,
                audio_file: str = "", preload: bool = True,
                with_priors: bool | None = None,
                device: str | torch.device = "cuda",
                host: bool = False, images: bool = True) -> list[FrameRecord]:
    """One split of a scene directory as FrameRecords, memoized per
    (path, split, arguments, device, the transforms file's mtime). With
    ``host`` the frames decode on ``device`` in chunks into host memory and
    the read is not memoized. Without ``images`` no frame is decoded and
    the records' ``image`` and ``bg`` are None: the cameras, action units,
    landmarks and masks alone."""
    dev = resolve_device(device)
    if host:
        return _load_frames_uncached(path, split, audio_extractor, n_views,
                                     audio_file, with_priors, dev, True,
                                     images)
    tf = os.path.join(path, f"transforms_{split}.json")
    key = (os.path.abspath(path), split, audio_extractor, n_views,
           audio_file, preload, with_priors, str(dev), images,
           os.path.getmtime(tf) if os.path.exists(tf) else 0.0)
    with _FRAMES_LOCK:
        if key in _FRAMES_CACHE:
            return _FRAMES_CACHE[key]
        records = _load_frames_uncached(path, split, audio_extractor,
                                        n_views, audio_file, with_priors,
                                        dev, images=images)
        while len(_FRAMES_CACHE) >= _FRAMES_CACHE_MAX:
            _FRAMES_CACHE.pop(next(iter(_FRAMES_CACHE)))
        _FRAMES_CACHE[key] = records
        return records


def _composite_torso(torso: torch.Tensor, bc: torch.Tensor) -> torch.Tensor:
    """RGBA torso frames [N, H, W, 4] uint8 over the background [H, W, 3]
    uint8, in float32 (the same operations on either device)."""
    torso = torso.to(torch.float32)
    a = torso[..., 3:] / 255.0
    return (torso[..., :3] * a + bc * (1 - a)).to(torch.uint8)


def _decode_frames(path: str, ids: list[int], dev: torch.device,
                   host: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The frames ``gt_imgs/{id}.jpg`` and their torso-over-``bc.jpg``
    backgrounds as uint8 [N, H, W, 3]: on ``dev``, or (``host``) decoded
    there ``DECODE_CHUNK`` at a time into host tensors."""
    def torso(chunk):
        return torch.from_numpy(np.stack([
            read_png(os.path.join(path, "torso_imgs", f"{i}.png"),
                     channels=4) for i in chunk]))

    def jpegs(chunk):
        return read_jpegs([os.path.join(path, "gt_imgs", f"{i}.jpg")
                           for i in chunk], dev)

    bc = read_jpegs([os.path.join(path, "bc.jpg")], dev)[0]
    if not host:
        return jpegs(ids), _composite_torso(torso(ids).to(dev), bc)
    bc = bc.cpu()
    h, w = bc.shape[:2]
    gt = torch.empty((len(ids), h, w, 3), dtype=torch.uint8)
    bg = torch.empty_like(gt)
    for s in range(0, len(ids), DECODE_CHUNK):
        chunk = ids[s:s + DECODE_CHUNK]
        gt[s:s + len(chunk)] = jpegs(chunk)
        bg[s:s + len(chunk)] = _composite_torso(torso(chunk), bc)
    return gt, bg


def _load_frames_uncached(path: str, split: str, audio_extractor: str,
                          n_views: int, audio_file: str,
                          with_priors: bool | None, dev: torch.device,
                          host: bool = False,
                          images: bool = True) -> list[FrameRecord]:
    with open(os.path.join(path, f"transforms_{split}.json")) as f:
        contents = json.load(f)
    focal = contents["focal_len"]
    frames = contents["frames"]
    if split == "train" and n_views > 0 and not audio_file:
        frames = frames[:n_views]

    # audio features: [T, 16, D] on disk -> [T, D, 16] windows
    if audio_file:
        aud = np.load(audio_file)
    else:
        aud = np.load(os.path.join(
            path, f"aud{AUDIO_POSTFIX[audio_extractor]}.npy"))
    aud = np.transpose(aud.astype(np.float32), (0, 2, 1))

    if audio_file:
        loop = aud.shape[0] // len(frames) + 1
        frames = frames * loop

    # OpenFace AUs
    au = read_au_csv(os.path.join(path, "au.csv"))
    au_blink = au["AU45_r"]
    nv = len(frames) if (split == "train" and n_views > 0) else None
    au25_raw = au["AU25_r"]
    au25 = np.clip(au25_raw[:nv], 0, np.percentile(au25_raw[:nv], 95))
    au25_pcts = (np.percentile(au25, 25), np.percentile(au25, 50),
                 np.percentile(au25, 75), au25.max())
    exp_cols = []
    for i in [1, 4, 5, 6, 7, 45]:
        col = au[f"AU{i:02d}_r"]
        if i == 45:
            col = col.clip(0, 2)
        exp_cols.append(col[:, None])
    au_exp = np.concatenate(exp_cols, axis=-1).astype(np.float32)

    # landmark rects
    lips_rects, mouth_opens, lhalf_rects = [], [], []
    for frame in frames:
        lms = np.loadtxt(os.path.join(path, "ori_imgs",
                                      f"{frame['img_id']}.lms"))
        lips, mouth = slice(48, 60), slice(60, 68)
        xmin, xmax = int(lms[lips, 1].min()), int(lms[lips, 1].max())
        ymin, ymax = int(lms[lips, 0].min()), int(lms[lips, 0].max())
        lips_rects.append([xmin, xmax, ymin, ymax])
        mouth_opens.append(int(lms[mouth, 1].max()) - int(lms[mouth, 1].min()))
        lh_xmin = int(lms[31:36, 1].min())
        lh_xmax = int(lms[:, 1].max())
        lhalf_rects.append([lh_xmin, lh_xmax, int(lms[:, 0].min()),
                            int(lms[:, 0].max())])
    mouth_lb = min(mouth_opens)
    mouth_ub = max(mouth_opens)

    use_priors = (with_priors if with_priors is not None
                  else (split == "train" and n_views > 0))
    normal_dir = depth_dir = None
    if use_priors:
        nc = sorted(glob.glob(os.path.join(path, "sapiens/normal/sapiens_*")),
                    reverse=True)
        dc = sorted(glob.glob(os.path.join(path, "sapiens/depth/sapiens_*")),
                    reverse=True)
        if nc and dc:
            normal_dir, depth_dir = nc[0], dc[0]

    gt_all = bg_all = None
    if images:
        gt_all, bg_all = _decode_frames(
            path, [frame["img_id"] for frame in frames], dev, host)

    records = []
    for idx, frame in enumerate(frames):
        img_id = frame["img_id"]
        teeth = np.load(os.path.join(path, "teeth_mask", f"{img_id}.npy"))
        parsing = read_png(os.path.join(path, "parsing", f"{img_id}.png"),
                           channels=3).astype(np.float32)
        face_mask = ((parsing[:, :, 2] > 254) & (parsing[:, :, 0] == 0)
                     & (parsing[:, :, 1] == 0)) ^ teeth
        hair_mask = ((parsing[:, :, 0] < 1) & (parsing[:, :, 1] < 1)
                     & (parsing[:, :, 2] < 1))
        mouth_mask = ((parsing[:, :, 0] == 100) & (parsing[:, :, 1] == 100)
                      & (parsing[:, :, 2] == 100)) | teeth
        image = None if gt_all is None else gt_all[idx]
        h, w = (parsing if image is None else image).shape[:2]
        fovx, fovy = focal2fov(focal, w), focal2fov(focal, h)
        view_T, full_T, campos, _, _ = _camera_matrices(
            frame["transform_matrix"], fovx, fovy)

        aud_idx = idx if audio_file else img_id
        if aud_idx >= aud.shape[0]:
            break
        auds = window_audio_features(aud, aud_idx)

        normal = depth = None
        if normal_dir is not None:
            normal = np.load(os.path.join(normal_dir, f"{img_id}.npy"))
            depth = np.load(os.path.join(depth_dir, f"{img_id}.npy"))

        records.append(FrameRecord(
            uid=idx, img_id=img_id, width=w, height=h, fovx=fovx, fovy=fovy,
            view_transform=view_T, full_proj_transform=full_T,
            camera_center=campos, image=image,
            bg=None if bg_all is None else bg_all[idx],
            face_mask=face_mask, hair_mask=hair_mask, mouth_mask=mouth_mask,
            auds=auds, blink=float(np.clip(au_blink[img_id], 0, 2) / 2),
            au25=(float(au25[min(img_id, len(au25) - 1)]),) + au25_pcts,
            au_exp=au_exp[img_id], lips_rect=lips_rects[idx],
            lhalf_rect=lhalf_rects[idx],
            mouth_bound=[mouth_lb, mouth_ub, mouth_opens[idx]],
            normal=normal, depth=depth))
    return records


def scene_extent(records) -> tuple[np.ndarray, float]:
    """NeRF++-style normalization: the cameras' mean centre and 1.1 x the
    largest distance from it. Takes FrameRecords (their float32 centres,
    as the JAX package computes) or camera centres [F, 3] (in float64)."""
    if len(records) and isinstance(records[0], FrameRecord):
        centers = np.stack([r.camera_center for r in records])
    else:
        centers = np.asarray(records, np.float64)
    center = centers.mean(axis=0)
    radius = float(np.linalg.norm(centers - center, axis=1).max() * 1.1)
    return center, radius


def random_init_points(num: int, seed: int = 0):
    """Random initial cloud in the [-0.1, 0.1]^3 cube with near-black SH
    colours (SH2RGB(rand / 255)): (xyz [num, 3], colors [num, 3]) float32."""
    rng = np.random.default_rng(seed)
    xyz = (rng.random((num, 3)) * 0.2 - 0.1).astype(np.float32)
    shs = rng.random((num, 3)).astype(np.float32) / 255.0
    colors = shs * C0 + 0.5
    return xyz, colors
