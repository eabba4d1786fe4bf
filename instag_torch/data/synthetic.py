"""Synthetic talking-head scene in the reference on-disk format (the port's
own copy of instag_tpu/data/synthetic.py::generate_scene).

Writes a complete preprocessed-video directory (transforms json, gt and
torso images, parsing PNGs, teeth masks, landmarks, au.csv, audio
features, bc.jpg, points3d.ply), so the reader and the synthesis CLI run
without preprocessing models. The "head" is a coloured blob whose mouth
opens with the synthetic audio track. JPEGs encode on ``device`` (nvJPEG
on the card; PIL on the CPU, where every file is byte for byte the JAX
package's for the same arguments), PNGs through ``image_io.encode_png`` and
``au.csv`` through the ``csv`` module, so the card needs neither PIL nor
pandas.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from .dataset import random_init_points
from .image_io import write_jpeg, write_png
from .plyio import write_point_cloud


def generate_scene(path: str, n_frames: int = 20, size: int = 128,
                   audio_extractor: str = "deepspeech", seed: int = 0,
                   n_val: int = 4, variation: float = 0.0,
                   focal_mult: float = 2.0, motion_dims: int = 1,
                   device: str | torch.device = "cuda") -> None:
    """``variation`` > 0 makes identities genuinely different (appearance,
    geometry, talking cadence) while the audio features stay causally tied
    to the mouth motion — required for an honest Universal-Motion-Field
    transfer experiment (scripts/exp_umf_transfer.py): a pretrained UMF
    must generalize across head shape/color AND across each identity's
    random audio-feature projection, not just memorize one blob. The
    default 0.0 reproduces the historical fixture scenes bit-for-bit.

    ``motion_dims`` (1-3) sets the dimensionality of the audio->motion
    manifold. At 1 (default, historical) a single openness signal drives
    mouth height only — a 3-s clip already covers that manifold, so a
    pre-trained motion prior has nothing to transfer at short budgets
    (BASELINE.md round-4 flagship table, 75-frame row). At 3, independent
    non-periodic signals drive mouth height, width, and horizontal shift,
    all mixed into the SHARED audio basis — a product space a few-shot
    clip undersamples, which is the regime real speech lives in
    (reference pretrain_face.py's premise). JPEGs encode on ``device``."""
    dev = resolve_device(device)

    def save_jpeg(name, img, **quality):
        write_jpeg(os.path.join(path, name),
                   torch.from_numpy(img).to(dev), **quality)

    os.makedirs(path, exist_ok=True)
    for sub in ["gt_imgs", "torso_imgs", "parsing", "teeth_mask", "ori_imgs"]:
        os.makedirs(os.path.join(path, sub), exist_ok=True)

    rng = np.random.default_rng(seed)

    h = w = size
    # focal_mult sets the head's WORLD size: radius 10/3 with focal f puts
    # the head at world radius 0.28*size*(10/3)/f. The historical 2.0 gives
    # ~0.47 — 3x larger than a tracked real head (the motion nets' hash
    # grids clamp at bound 0.15, scene/motion_net.py:212-218), leaving most
    # splats with zero positional features. Motion-transfer experiments
    # pass ~8.0 so the head spans ~±0.12 like real tracked data.
    focal = size * focal_mult

    # identity parameters (all collapse to the historical constants at
    # variation=0; a separate stream keeps the audio rng draws unchanged)
    vrng = np.random.default_rng(seed + 1000)
    v = variation
    period = 10.0 + v * float(vrng.uniform(-3.0, 4.0))   # talking cadence
    # Under variation the mouth-openness signal is a NON-periodic two-tone
    # mix (incommensurate golden-ratio second period): a 10-s few-shot clip
    # then never covers the full audio-motion product space, which is what
    # makes pretraining vs from-scratch discriminative. At variation=0 the
    # historical single sinusoid is reproduced exactly.
    period2 = period * 1.6180339887
    phase2 = v * float(vrng.uniform(0, 2 * np.pi))

    def openness(tt):
        tt = np.asarray(tt, np.float64)
        if v == 0:
            return np.sin(2 * np.pi * tt / period)
        return (0.6 * np.sin(2 * np.pi * tt / period)
                + 0.4 * np.sin(2 * np.pi * tt / period2 + phase2))
    r_fac = 0.28 + v * float(vrng.uniform(-0.04, 0.04))  # head size
    mouth_w = 0.08 * (1.0 + v * float(vrng.uniform(-0.3, 0.3)))
    mouth_amp = 0.03 * (1.0 + v * float(vrng.uniform(-0.3, 0.4)))
    mouth_pos = 0.45 + v * float(vrng.uniform(-0.08, 0.08))
    head_col = tuple(np.clip(np.array((200, 160, 140))
                             + v * vrng.uniform(-45, 45, 3), 0, 255)
                     .astype(np.uint8))
    hair_col = tuple(np.clip(np.array((30, 20, 10))
                             + v * vrng.uniform(0, 50, 3), 0, 255)
                     .astype(np.uint8))
    mouth_col = tuple(np.clip(np.array((120, 40, 40))
                              + v * vrng.uniform(-30, 30, 3), 0, 255)
                      .astype(np.uint8))
    bob = (3.0 * (1 + v * float(vrng.uniform(-0.5, 0.5))),
           2.0 * (1 + v * float(vrng.uniform(-0.5, 0.5))))

    # extra motion dimensions (drawn AFTER every historical vrng draw so
    # motion_dims=1 leaves the identity parameters bit-identical)
    def _extra_signal():
        p1 = 7.0 + float(vrng.uniform(-2.0, 5.0))
        p2 = p1 * 1.6180339887
        ph1, ph2 = (float(vrng.uniform(0, 2 * np.pi)) for _ in range(2))

        def sig(tt):
            tt = np.asarray(tt, np.float64)
            return (0.6 * np.sin(2 * np.pi * tt / p1 + ph1)
                    + 0.4 * np.sin(2 * np.pi * tt / p2 + ph2))
        return sig

    extra_sigs = [_extra_signal() for _ in range(max(motion_dims - 1, 0))]

    def motion(tt):
        """[D] motion coordinates at time tt: m0 = openness (historical),
        m1 = mouth-width modulation, m2 = mouth horizontal shift."""
        return [openness(tt)] + [s(tt) for s in extra_sigs]

    # background
    bc = np.full((h, w, 3), (40, 80, 120), np.uint8)
    save_jpeg("bc.jpg", bc, quality=75)      # PIL's default quality

    total = n_frames + n_val
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    frames_meta = []
    for i in range(total):
        m = [float(x) for x in motion(i)]
        phase = m[0]
        cx = w / 2 + bob[0] * np.cos(i / 5.0)
        cy = h / 2 + bob[1] * np.sin(i / 7.0)
        r_head = size * r_fac

        d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        head = d < r_head
        # mouth: small ellipse below center; height follows "audio" dim 0,
        # width dim 1, horizontal shift dim 2 (when motion_dims > 1)
        mh = size * mouth_amp * (1.2 + phase)
        mw_i = size * mouth_w * (1.0 + (0.3 * m[1] if len(m) > 1 else 0.0))
        mcx = cx + (size * 0.035 * m[2] if len(m) > 2 else 0.0)
        mouth = (((xx - mcx) / max(mw_i, 1e-3)) ** 2 +
                 ((yy - (cy + r_head * mouth_pos)) / max(mh, 1e-3)) ** 2) < 1.0
        hair = (d < r_head * 1.15) & (yy < cy - r_head * 0.5)

        img = bc.copy()
        img[head] = head_col
        img[mouth] = mouth_col
        img[hair] = hair_col
        save_jpeg(os.path.join("gt_imgs", f"{i}.jpg"), img, quality=95)

        # torso: translucent rectangle at the bottom
        torso = np.zeros((h, w, 4), np.uint8)
        torso[int(h * 0.85):, :, :3] = (90, 90, 110)
        torso[int(h * 0.85):, :, 3] = 255
        write_png(os.path.join(path, "torso_imgs", f"{i}.png"), torso)

        # parsing: blue=face(255 in B), black=hair, gray-100=mouth
        parsing = np.zeros((h, w, 3), np.uint8)
        parsing[head] = (0, 0, 255)
        parsing[mouth] = (100, 100, 100)
        parsing[hair] = (0, 0, 0)
        # non-head region: white background class
        parsing[~(head | hair)] = (255, 255, 255)
        parsing[mouth] = (100, 100, 100)
        write_png(os.path.join(path, "parsing", f"{i}.png"), parsing)

        teeth = np.zeros((h, w), bool)
        teeth[int(cy + r_head * 0.40): int(cy + r_head * 0.43),
              int(cx - size * 0.04): int(cx + size * 0.04)] = True
        np.save(os.path.join(path, "teeth_mask", f"{i}.npy"), teeth)

        # 68 landmarks: synthesize a plausible layout (cols=x=lms[:,0],
        # rows=y=lms[:,1] per the reference indexing)
        lms = np.zeros((68, 2), np.float32)
        ang = np.linspace(0, np.pi, 17)
        lms[0:17, 0] = cx - r_head * np.cos(ang)          # jaw x
        lms[0:17, 1] = cy + r_head * 0.8 * np.sin(ang)    # jaw y
        lms[17:27, 0] = np.linspace(cx - r_head * .6, cx + r_head * .6, 10)
        lms[17:27, 1] = cy - r_head * 0.5
        lms[27:31, 0] = cx
        lms[27:31, 1] = np.linspace(cy - r_head * .2, cy + r_head * .1, 4)
        lms[31:36, 0] = np.linspace(cx - 6, cx + 6, 5)
        lms[31:36, 1] = cy + r_head * 0.15
        for k, (ex, sign) in enumerate([(cx - r_head * .35, 1),
                                        (cx + r_head * .35, -1)]):
            a2 = np.linspace(0, 2 * np.pi, 6, endpoint=False)
            lms[36 + 6 * k: 42 + 6 * k, 0] = ex + 5 * np.cos(a2)
            lms[36 + 6 * k: 42 + 6 * k, 1] = cy - r_head * .2 + 3 * np.sin(a2)
        mouth_cy = cy + r_head * mouth_pos
        a3 = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        lms[48:60, 0] = mcx + (mw_i + size * 0.01) * np.cos(a3)
        lms[48:60, 1] = mouth_cy + (mh + 2) * np.sin(a3)
        a4 = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        lms[60:68, 0] = mcx + (mw_i - size * 0.02) * np.cos(a4)
        lms[60:68, 1] = mouth_cy + mh * np.sin(a4)
        np.savetxt(os.path.join(path, "ori_imgs", f"{i}.lms"), lms, "%.2f")

        # circular camera orbit looking at origin from +z (OpenGL convention:
        # camera looks down its -z; the reader flips to COLMAP)
        theta = 0.15 * np.sin(2 * np.pi * i / total)
        phi = 0.1 * np.cos(2 * np.pi * i / total)
        radius = 10.0 / 3.0
        eye = np.array([radius * np.sin(theta),
                        radius * np.sin(phi),
                        radius * np.cos(theta) * np.cos(phi)])
        forward = -eye / np.linalg.norm(eye)          # toward origin
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(forward, up); right /= np.linalg.norm(right)
        up2 = np.cross(right, forward)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = up2
        c2w[:3, 2] = -forward   # OpenGL: z back
        c2w[:3, 3] = eye
        frames_meta.append({"img_id": i,
                            "transform_matrix": c2w.tolist()})

    with open(os.path.join(path, "transforms_train.json"), "w") as f:
        json.dump({"focal_len": focal, "frames": frames_meta[:n_frames]}, f)
    with open(os.path.join(path, "transforms_val.json"), "w") as f:
        json.dump({"focal_len": focal, "frames": frames_meta[n_frames:]}, f)

    # audio features [T, 16, D]
    dims = {"deepspeech": 29, "esperanto": 44, "hubert": 1024, "ave": 512}
    d = dims[audio_extractor]
    t = np.arange(total, dtype=np.float32)
    base = openness(t).astype(np.float32)
    # Audio projection: per-identity at variation=0 (historical fixtures);
    # SHARED at variation>0 — real identities share one fixed audio
    # extractor (DeepSpeech/wav2vec), so the feature basis encoding the
    # openness signal is identical across people. A UMF's AudioNet learns
    # that shared decoding during pre-training; per-identity projections
    # would (unrealistically) make the held-out identity's audio unreadable.
    arng = rng if v == 0 else np.random.default_rng(424242)
    proj = arng.normal(size=(1, 16, d)).astype(np.float32)
    aud = (base[:, None, None] * proj
           + 0.05 * rng.normal(size=(total, 16, d)).astype(np.float32))
    if motion_dims > 1:
        # every motion dimension rides the SHARED audio basis (one
        # extractor in the real world): aud = sum_d m_d(t) * proj_d + noise
        mrng = np.random.default_rng(424243)
        sigs = np.stack([np.asarray(s(t), np.float32) for s in extra_sigs])
        projs = mrng.normal(size=(len(extra_sigs), 1, 16, d)).astype(
            np.float32)
        aud = aud + np.sum(sigs[:, :, None, None] * projs, axis=0)
    postfix = {"deepspeech": "_ds", "esperanto": "_eo", "hubert": "_hu",
               "ave": "_ave"}[audio_extractor]
    np.save(os.path.join(path, f"aud{postfix}.npy"), aud)

    # au.csv with the OpenFace columns the reader needs, each float32 value
    # in numpy's shortest form (as pandas' to_csv writes it)
    cols = {}
    # full OpenFace intensity column set (needed by the AU-error metric)
    for i_au in [1, 2, 4, 5, 6, 7, 9, 10, 12, 14, 15, 17, 20, 23, 25, 26, 45]:
        cols[f"AU{i_au:02d}_r"] = np.abs(
            rng.normal(0.5, 0.3, total)).astype(np.float32)
    cols["AU25_r"] = (1.2 + openness(t)).astype(np.float32)
    with open(os.path.join(path, "au.csv"), "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(cols))
        writer.writerows(zip(*(v.astype(str) for v in cols.values())))

    # random init point cloud
    xyz, colors = random_init_points(1000, seed)
    write_point_cloud(os.path.join(path, "points3d.ply"), xyz,
                      (colors * 255).astype(np.uint8))
