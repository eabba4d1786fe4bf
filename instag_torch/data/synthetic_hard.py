"""Hard synthetic talking-head identity (the port's own copy of
instag_tpu/data/synthetic_hard.py::generate_hard_scene).

Unlike the blob scenes of ``data.synthetic``, an identity here has what the
method's losses need to matter:

* 3D-consistent rendering: the head is a sphere in world space, ray-traced
  per pixel through the camera model the dataset reader reconstructs, with
  its texture attached to the surface;
* high-frequency texture: multi-octave value noise and freckles on skin,
  ridge stripes on lips, strand stripes on hair, ringed irises;
* AU-driven eyelid blinks, published as AU45_r;
* upper teeth inside the mouth cavity, in ``teeth_mask/``;
* a rich audio -> motion map: ``art_dims`` articulation signals decoded by a
  shared nonlinear map (plus a small per-identity perturbation) into jaw,
  width, shift, smile and brow motion, and window-encoded into the audio
  features by a shared projection.

The scene is written in the reference's on-disk contract, the layout
``data.dataset.load_frames`` reads. JPEGs encode on ``device`` (nvJPEG on
the card; PIL on the CPU, where every file is byte for byte the JAX
package's for the same arguments), PNGs through ``image_io.write_png`` and
``au.csv`` through the ``csv`` module, so the card needs neither PIL nor
pandas. ``render_hard_video`` turns an identity into a raw capture (an
MJPEG AVI and its WAV) for the preprocessing chain,
``instag_torch.data_utils.process``.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from .dataset import random_init_points
from .image_io import read_jpegs, write_jpeg, write_png
from .plyio import write_point_cloud

GOLDEN = 1.6180339887

# head geometry (world units): radius chosen so the head spans ~±0.12 —
# inside the motion-net hash-grid bound 0.15 (scene/motion_net.py:212-218)
R_HEAD = 0.11
CAM_DIST = 10.0 / 3.0


# ---------------------------------------------------------------------------
# procedural texture primitives
# ---------------------------------------------------------------------------

def _hash_lattice(ix: np.ndarray, iy: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic pseudo-random [0,1) value per integer lattice point."""
    h = (ix.astype(np.int64) * 374761393 + iy.astype(np.int64) * 668265263
         + np.int64(seed) * 2147483647)
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return ((h & 0xFFFFFF).astype(np.float32)) / float(0xFFFFFF)


def _value_noise(u: np.ndarray, v: np.ndarray, freq: float,
                 seed: int) -> np.ndarray:
    """Bilinear value noise in [0,1) at the given frequency."""
    x, y = u * freq, v * freq
    ix, iy = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    fx, fy = x - ix, y - iy
    fx = fx * fx * (3 - 2 * fx)
    fy = fy * fy * (3 - 2 * fy)
    n00 = _hash_lattice(ix, iy, seed)
    n10 = _hash_lattice(ix + 1, iy, seed)
    n01 = _hash_lattice(ix, iy + 1, seed)
    n11 = _hash_lattice(ix + 1, iy + 1, seed)
    return ((n00 * (1 - fx) + n10 * fx) * (1 - fy)
            + (n01 * (1 - fx) + n11 * fx) * fy)


def _fbm(u: np.ndarray, v: np.ndarray, base_freq: float, octaves: int,
         seed: int) -> np.ndarray:
    """Multi-octave noise in [-1, 1]."""
    out = np.zeros_like(u, dtype=np.float32)
    amp, freq, norm = 1.0, base_freq, 0.0
    for o in range(octaves):
        out += amp * (_value_noise(u, v, freq, seed + 31 * o) * 2 - 1)
        norm += amp
        amp *= 0.5
        freq *= 2.1
    return out / norm


# ---------------------------------------------------------------------------
# articulation / motion model
# ---------------------------------------------------------------------------

def _two_tone(rng: np.random.Generator, lo=5.0, hi=15.0):
    p1 = float(rng.uniform(lo, hi))
    p2 = p1 * GOLDEN
    ph1, ph2 = (float(rng.uniform(0, 2 * np.pi)) for _ in range(2))

    def sig(tt):
        tt = np.asarray(tt, np.float64)
        return (0.6 * np.sin(2 * np.pi * tt / p1 + ph1)
                + 0.4 * np.sin(2 * np.pi * tt / p2 + ph2)).astype(np.float32)
    return sig


def _blink_signal(rng: np.random.Generator, total: int) -> np.ndarray:
    """Sparse smooth blinks: ~one per 40-90 frames, ~4 frames wide."""
    b = np.zeros(total, np.float32)
    t = 0.0
    tt = np.arange(total, dtype=np.float32)
    while t < total:
        t += float(rng.uniform(40, 90))
        width = float(rng.uniform(1.5, 2.5))
        b += np.exp(-0.5 * ((tt - t) / width) ** 2).astype(np.float32)
    return np.clip(b, 0.0, 1.0)


class _MotionModel:
    """Shared articulation decode + per-identity perturbation.

    a(t) in R^D per identity (the speech content differs per person); the
    decode m = tanh(S0 a(t) + S1 a(t-2)) is SHARED (human anatomy), with a
    small per-identity dS (eps=0.25) for the personalized field to absorb.
    """

    N_PARAMS = 5        # open, width, shift, smile, jaw-extra

    def __init__(self, seed: int, art_dims: int, total: int):
        self.art_dims = art_dims
        id_rng = np.random.default_rng(seed + 5000)
        sh_rng = np.random.default_rng(424242)        # SHARED across ids
        self.sigs = [_two_tone(id_rng) for _ in range(art_dims)]
        scale = 1.0 / np.sqrt(art_dims)
        self.S0 = sh_rng.normal(size=(self.N_PARAMS, art_dims)).astype(
            np.float32) * scale
        self.S1 = sh_rng.normal(size=(self.N_PARAMS, art_dims)).astype(
            np.float32) * scale * 0.6
        self.dS = id_rng.normal(size=(self.N_PARAMS, art_dims)).astype(
            np.float32) * scale * 0.25
        t = np.arange(-4, total, dtype=np.float32)    # includes lag history
        self.a = np.stack([s(t) for s in self.sigs], axis=-1)  # [4+T, D]
        self.t0 = 4
        # non-audio signals: blink + slow brow raise
        self.blink = _blink_signal(id_rng, total)
        self.brow = _two_tone(id_rng, 50.0, 120.0)(
            np.arange(total, dtype=np.float32)) * 0.5

    def art(self, t: int) -> np.ndarray:
        return self.a[self.t0 + t]

    def params(self, t: int) -> np.ndarray:
        """[N_PARAMS] in (-1, 1): open, width, shift, smile, jaw."""
        a0 = self.a[self.t0 + t]
        a2 = self.a[self.t0 + t - 2]
        return np.tanh((self.S0 + self.dS) @ a0 + self.S1 @ a2)


# ---------------------------------------------------------------------------
# camera (must invert data/dataset.py:72-83 exactly)
# ---------------------------------------------------------------------------

def _orbit_c2w(i: int, total: int, wobble: np.ndarray) -> np.ndarray:
    """OpenGL c2w for frame i: slow orbit + per-identity wobble phase."""
    theta = 0.15 * np.sin(2 * np.pi * i / total + wobble[0])
    phi = 0.10 * np.cos(2 * np.pi * i / total + wobble[1])
    # small faster nod on top (head motion, still a rigid camera move)
    theta += 0.02 * np.sin(i / 6.1 + wobble[2])
    phi += 0.015 * np.sin(i / 8.3 + wobble[3])
    eye = np.array([CAM_DIST * np.sin(theta),
                    CAM_DIST * np.sin(phi),
                    CAM_DIST * np.cos(theta) * np.cos(phi)])
    forward = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    up2 = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = up2
    c2w[:3, 2] = -forward                  # OpenGL: z back
    c2w[:3, 3] = eye
    return c2w


def _pixel_rays(c2w: np.ndarray, focal: float, h: int, w: int):
    """World-space (origin, dir[h,w,3]) for every pixel center (OpenGL)."""
    j, i = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    x = (j + 0.5 - w / 2) / focal
    y = (h / 2 - (i + 0.5)) / focal        # +y up in GL camera space
    d_cam = np.stack([x, y, -np.ones_like(x)], axis=-1)
    d = d_cam @ c2w[:3, :3].T.astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return c2w[:3, 3].astype(np.float32), d


def _project(c2w: np.ndarray, focal: float, h: int, w: int,
             pts: np.ndarray) -> np.ndarray:
    """World points -> (col, row) pixels; exact inverse of _pixel_rays."""
    q = (pts - c2w[:3, 3]) @ c2w[:3, :3].astype(np.float64)   # cam coords
    z = -q[:, 2]
    col = w / 2 + focal * q[:, 0] / z - 0.5
    row = h / 2 - focal * q[:, 1] / z - 0.5
    return np.stack([col, row], axis=-1)


# ---------------------------------------------------------------------------
# the face model: per-pixel shading on the sphere surface
# ---------------------------------------------------------------------------

class _Identity:
    """Per-identity appearance + geometry parameters."""

    def __init__(self, seed: int):
        r = np.random.default_rng(seed + 9000)
        self.seed = seed
        self.skin = np.array([205, 162, 138], np.float32) + \
            r.uniform(-35, 35, 3).astype(np.float32)
        self.lip = np.array([170, 75, 80], np.float32) + \
            r.uniform(-30, 30, 3).astype(np.float32)
        self.hair = np.array([55, 38, 25], np.float32) + \
            r.uniform(-25, 60, 3).astype(np.float32)
        self.iris = np.array([70, 95, 140], np.float32) + \
            r.uniform(-40, 60, 3).astype(np.float32)
        self.cavity = np.array([70, 25, 30], np.float32)
        self.teeth_col = np.array([235, 230, 215], np.float32)
        # geometry (azimuth u, height vy = n_y), all on the sphere surface
        self.mouth_v = -0.42 + float(r.uniform(-0.05, 0.05))
        self.mouth_w = 0.30 * (1 + float(r.uniform(-0.2, 0.2)))
        self.mouth_h = 0.085 * (1 + float(r.uniform(-0.2, 0.3)))
        self.open_h = 0.16 * (1 + float(r.uniform(-0.2, 0.3)))
        self.eye_u = 0.26 * (1 + float(r.uniform(-0.12, 0.12)))
        self.eye_v = 0.18 + float(r.uniform(-0.04, 0.04))
        self.eye_w = 0.105 * (1 + float(r.uniform(-0.15, 0.15)))
        self.eye_h = 0.060 * (1 + float(r.uniform(-0.15, 0.15)))
        self.brow_v = 0.34 + float(r.uniform(-0.03, 0.03))
        self.hair_v = 0.52 + float(r.uniform(-0.06, 0.06))
        self.freckle = float(r.uniform(0.0, 1.0))
        self.tex_seed = int(r.integers(0, 2 ** 31 - 1))
        self.wobble = r.uniform(0, 2 * np.pi, 4).astype(np.float64)
        self.light = np.array([0.35, 0.5, 0.8]) + r.uniform(-0.15, 0.15, 3)
        self.light /= np.linalg.norm(self.light)


def _shade_frame(ident: _Identity, n: np.ndarray,
                 m: np.ndarray, blink: float, brow_raise: float):
    """Color hit pixels; returns (rgb[K,3] float, masks dict of [K] bools).

    ``n``: [K, 3] unit surface normals (== surface point / R) of the HIT
    pixels only (flat). All features live in (u=azimuth, vy=n_y) surface
    coordinates so they are rigidly attached to the sphere (3D-consistent
    across views).
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    u = np.arctan2(nx, np.maximum(nz, -0.999))       # azimuth, 0 = front
    vy = ny

    t_open = 0.5 + 0.5 * m[0]                        # 0..1 jaw opening
    width = 1.0 + 0.22 * m[1]
    shift = 0.05 * m[2]
    smile = 0.03 * m[3]
    jaw = 0.10 * (0.65 * t_open + 0.35 * (0.5 + 0.5 * m[4]))

    # --- inverse jaw warp: lower-face texture/features slide down with the
    # jaw; sample canonical coords (u, vc) where vc = vy + jaw*falloff ---
    lip_line = ident.mouth_v + 0.05
    fall = np.clip((lip_line - vy) / 0.6, 0.0, 1.0) ** 1.5
    vc = vy + jaw * fall

    skin_n = _fbm(u * 2.0, vc * 2.0, 24.0, 4, ident.tex_seed)
    rgb = (ident.skin[None, :]
           * (1.0 + 0.16 * skin_n[..., None])).astype(np.float32)
    # freckle spots: thresholded high-frequency noise on the cheeks
    fr = _value_noise(u * 2.0, vc * 2.0, 40.0, ident.tex_seed + 7)
    cheeks = (np.abs(u) > 0.18) & (vc < 0.15) & (vc > -0.35)
    frm = (fr > 1.0 - 0.035 * (0.3 + ident.freckle)) & cheeks
    rgb[frm] *= 0.72

    # --- nose: shaded ridge + nostril dots (texture-space, static) ---
    nose = (np.abs(u) < 0.07) & (vc > -0.18) & (vc < 0.12)
    rgb[nose] *= 1.06
    nostril = (np.abs(np.abs(u) - 0.05) < 0.018) & (np.abs(vc + 0.16) < 0.02)
    rgb[nostril] *= 0.6

    # --- mouth: outer lips / opening / cavity / teeth ---
    mu = (u - shift) / (ident.mouth_w * width)
    corner_lift = smile * np.clip(np.abs(mu), 0, 1.2) ** 2 * 10.0
    mv_c = ident.mouth_v + corner_lift
    open_h = ident.open_h * t_open
    lips_h = ident.mouth_h + 0.5 * open_h
    mv = (vc - mv_c) / np.maximum(lips_h, 1e-4)
    lips_region = (mu ** 2 + mv ** 2) < 1.0
    mo = (vc - mv_c) / np.maximum(open_h, 1e-4)
    opening = (mu ** 2 + mo ** 2) < 1.0 if open_h > 1e-3 else \
        np.zeros_like(lips_region)
    lips = lips_region & ~opening
    # lip ridge stripes (high-frequency vertical micro-texture)
    ridges = 0.5 + 0.5 * np.sin(u * 260.0 + skin_n * 6.0)
    lip_rgb = (ident.lip[None, :]
               * (0.9 + 0.2 * ridges[..., None])).astype(np.float32)
    rgb[lips] = lip_rgb[lips]
    rgb[opening] = ident.cavity
    # upper teeth hang from the upper lip into the cavity
    teeth = opening & (mo < -0.25) & (np.abs(mu) < 0.8)
    tooth_sep = 0.8 + 0.2 * np.sign(np.sin(mu * 22.0))
    rgb[teeth] = (ident.teeth_col[None, :]
                  * tooth_sep[teeth, None]).astype(np.float32)

    # --- eyes + AU-driven blink ---
    eye_mask = np.zeros(u.shape, bool)
    for s in (-1.0, 1.0):
        eu = (u - s * ident.eye_u) / ident.eye_w
        ev = (vy - ident.eye_v) / ident.eye_h
        inside = (eu ** 2 + ev ** 2) < 1.0
        # lid closes from the top: aperture shrinks with blink
        aperture = inside & (ev < (1.0 - 2.0 * blink))
        sclera = np.array([225, 222, 218], np.float32)
        rgb[aperture] = sclera[None, :]
        rr = np.sqrt((eu * ident.eye_w) ** 2 + (ev * ident.eye_h) ** 2)
        iris = aperture & (rr < 0.045)
        rings = 0.75 + 0.25 * np.sin(rr * 700.0)
        rgb[iris] = (ident.iris[None, :]
                     * rings[iris, None]).astype(np.float32)
        pupil = aperture & (rr < 0.018)
        rgb[pupil] = 15.0
        # closed part of the eye = lid skin, slightly darker + crease
        lid = inside & ~aperture
        rgb[lid] = (ident.skin * 0.88)[None, :]
        eye_mask |= inside

    # --- brows: dark arcs, vertical position driven by brow_raise ---
    for s in (-1.0, 1.0):
        bu = (u - s * ident.eye_u) / (ident.eye_w * 1.45)
        curve = 0.035 * (1 - bu ** 2)
        bv = ident.brow_v + 0.04 * brow_raise + curve
        brow = (np.abs(bu) < 1.0) & (np.abs(vy - bv) < 0.022)
        bn = _value_noise(u * 4, vy * 4, 90.0, ident.tex_seed + 13)
        rgb[brow] = ((ident.hair * 0.8)[None, :]
                     * (0.8 + 0.4 * bn[..., None]))[brow].astype(np.float32)

    # --- hair: wavy boundary + strand stripes ---
    hair_b = ident.hair_v + 0.05 * np.sin(u * 7.0 + ident.tex_seed % 7) \
        + 0.03 * np.sin(u * 17.0 + ident.tex_seed % 13)
    hair = (vy > hair_b) | (np.abs(u) > 2.2)
    strands = 0.65 + 0.35 * _value_noise(u * 40.0, vy * 3.0, 8.0,
                                         ident.tex_seed + 29)
    hn = _fbm(u * 3.0, vy * 1.5, 12.0, 3, ident.tex_seed + 31)
    rgb[hair] = (ident.hair[None, :]
                 * (strands * (1 + 0.25 * hn))[..., None])[hair].astype(
        np.float32)

    # --- diffuse shading (surface-attached, view-independent) ---
    lam = 0.72 + 0.28 * np.clip(
        n @ ident.light.astype(np.float32), 0, 1)
    rgb *= lam[..., None]

    masks = dict(mouth=lips_region | opening, teeth=teeth, hair=hair,
                 eyes=eye_mask)
    return rgb, masks


# ---------------------------------------------------------------------------
# landmark synthesis (3D feature points projected through the real camera)
# ---------------------------------------------------------------------------

def _surface_point(u, vy):
    """(azimuth, height) -> 3D point on the sphere (front hemisphere)."""
    u, vy = np.asarray(u, np.float64), np.asarray(vy, np.float64)
    r_xz = np.sqrt(np.maximum(1.0 - vy ** 2, 1e-6))
    return np.stack([r_xz * np.sin(u), vy, r_xz * np.cos(u)],
                    axis=-1) * R_HEAD


def _landmarks(ident: _Identity, m: np.ndarray, c2w, focal, h, w):
    t_open = 0.5 + 0.5 * m[0]
    width = 1.0 + 0.22 * m[1]
    shift = 0.05 * m[2]
    jaw = 0.10 * (0.65 * t_open + 0.35 * (0.5 + 0.5 * m[4]))
    open_h = ident.open_h * t_open
    lips_h = ident.mouth_h + 0.5 * open_h
    mw = ident.mouth_w * width
    mv = ident.mouth_v - jaw * np.clip(
        (ident.mouth_v + 0.05 - ident.mouth_v) / 0.6, 0, 1) ** 1.5

    pts = np.zeros((68, 2))
    # jaw 0:17 — arc along the lower face silhouette
    ang = np.linspace(-np.pi / 2, np.pi / 2, 17)
    pts_jaw = _surface_point(np.sin(ang) * 0.9,
                             -np.abs(np.cos(ang)) * 0.85 - jaw * 0.3)
    # brows 17:27
    bu = np.concatenate([np.linspace(-1, 1, 5) * ident.eye_w * 1.45
                         - ident.eye_u,
                         np.linspace(-1, 1, 5) * ident.eye_w * 1.45
                         + ident.eye_u])
    pts_brow = _surface_point(bu, np.full(10, ident.brow_v))
    # nose 27:36
    pts_nose = _surface_point(np.zeros(4),
                              np.linspace(0.12, -0.14, 4))
    pts_nostr = _surface_point(np.linspace(-0.05, 0.05, 5),
                               np.full(5, -0.16))
    # eyes 36:48
    a2 = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    eyes = []
    for s in (-1.0, 1.0):
        eyes.append(_surface_point(s * ident.eye_u + ident.eye_w * np.cos(a2),
                                   ident.eye_v + ident.eye_h * np.sin(a2)))
    # outer lips 48:60, inner 60:68
    a3 = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    outer = _surface_point(shift + (mw + 0.02) * np.cos(a3),
                           mv + (lips_h + 0.01) * np.sin(a3))
    a4 = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    inner = _surface_point(shift + max(mw - 0.04, 0.02) * np.cos(a4),
                           mv + max(open_h, 0.005) * np.sin(a4))
    p3d = np.concatenate([pts_jaw, pts_brow, pts_nose, pts_nostr,
                          eyes[0], eyes[1], outer, inner])
    pix = _project(c2w, focal, h, w, p3d)
    pts[:, 0] = pix[:, 0]                 # cols = x
    pts[:, 1] = pix[:, 1]                 # rows = y
    return pts.astype(np.float32)


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------

def generate_hard_scene(path: str, n_frames: int = 250, size: int = 256,
                        audio_extractor: str = "deepspeech", seed: int = 0,
                        n_val: int = 25, art_dims: int = 8,
                        supersample: int = 2,
                        device: str | torch.device = "cuda"
                        ) -> "_MotionModel":
    """Write one hard identity in the reference on-disk dataset contract,
    its JPEGs encoded on ``device``. Returns the identity's motion model
    (the articulation behind its audio features)."""
    dev = resolve_device(device)

    def save_jpeg(name, img, **quality):
        write_jpeg(os.path.join(path, name),
                   torch.from_numpy(img).to(dev), **quality)

    os.makedirs(path, exist_ok=True)
    for sub in ["gt_imgs", "torso_imgs", "parsing", "teeth_mask", "ori_imgs"]:
        os.makedirs(os.path.join(path, sub), exist_ok=True)

    h = w = size
    focal = 8.0 * size
    total = n_frames + n_val
    ident = _Identity(seed)
    motion = _MotionModel(seed, art_dims, total)
    rng = np.random.default_rng(seed)

    # lightly textured background + static torso
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    bgn = _fbm(jj / w, ii / h, 6.0, 3, seed + 77)
    bc = np.clip(np.array([46, 84, 124], np.float32)[None, None]
                 * (1 + 0.08 * bgn[..., None]), 0, 255).astype(np.uint8)
    save_jpeg("bc.jpg", bc, quality=75)      # PIL's default quality

    torso = np.zeros((h, w, 4), np.uint8)
    ty = int(h * 0.86)
    cloth = _fbm(jj / w * 4, ii / h * 4, 16.0, 3, seed + 99)
    torso[ty:, :, :3] = np.clip(
        np.array([92, 88, 112], np.float32)[None, None]
        * (1 + 0.12 * cloth[ty:, :, None]), 0, 255).astype(np.uint8)
    torso[ty:, :, 3] = 255

    ss = max(int(supersample), 1)
    hs, ws = h * ss, w * ss

    frames_meta = []
    for i in range(total):
        m = motion.params(i)
        blink = float(motion.blink[i])
        brow_raise = float(motion.brow[i])
        c2w = _orbit_c2w(i, total, ident.wobble)

        eye_o, d = _pixel_rays(c2w, focal * ss, hs, ws)
        # ray-sphere: |o + t d| = R_HEAD
        b = d @ eye_o
        disc = b * b - (eye_o @ eye_o - R_HEAD ** 2)
        hit = disc > 0
        t_hit = (-b - np.sqrt(np.maximum(disc, 0)))[hit]
        # shade only the hit pixels (~6% of the supersampled frame)
        n = (eye_o[None, :] + t_hit[:, None] * d[hit]) / R_HEAD
        rgb, masks_flat = _shade_frame(ident, n, m, blink, brow_raise)

        def full(mk_flat):
            out = np.zeros((hs, ws), bool)
            out[hit] = mk_flat
            return out

        masks = {k: full(v) for k, v in masks_flat.items()}
        img_hi = np.repeat(np.repeat(
            bc, ss, axis=0), ss, axis=1).astype(np.float32)
        img_hi[hit] = rgb
        # box-filter downsample (antialiasing)
        img = img_hi.reshape(h, ss, w, ss, 3).mean(axis=(1, 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        # the reader renders against bg = torso over bc, so gt shows the
        # torso where the head does not cover it (here they never overlap)
        tm = torso[..., 3] > 0
        img[tm] = torso[tm, :3]
        save_jpeg(os.path.join("gt_imgs", f"{i}.jpg"), img, quality=95)
        write_png(os.path.join(path, "torso_imgs", f"{i}.png"), torso)

        def down_mask(mk):
            return mk.reshape(h, ss, w, ss).mean(axis=(1, 3)) > 0.5

        head_m = down_mask(hit & ~masks["hair"])
        hair_m = down_mask(masks["hair"])
        mouth_m = down_mask(masks["mouth"])
        teeth_m = down_mask(masks["teeth"])
        parsing = np.full((h, w, 3), 255, np.uint8)        # bg = white
        parsing[tm] = (255, 0, 0)                           # torso = red
        parsing[head_m] = (0, 0, 255)                       # face = blue
        parsing[hair_m] = (0, 0, 0)                         # hair = black
        parsing[mouth_m] = (100, 100, 100)                  # mouth
        # teeth pixels are blue in parsing: the reader takes face_mask =
        # blue ^ teeth and mouth_mask = gray | teeth
        parsing[teeth_m] = (0, 0, 255)
        write_png(os.path.join(path, "parsing", f"{i}.png"), parsing)
        np.save(os.path.join(path, "teeth_mask", f"{i}.npy"), teeth_m)

        lms = _landmarks(ident, m, c2w, focal, h, w)
        np.savetxt(os.path.join(path, "ori_imgs", f"{i}.lms"), lms, "%.2f")

        frames_meta.append({"img_id": i, "transform_matrix": c2w.tolist()})

    with open(os.path.join(path, "transforms_train.json"), "w") as f:
        json.dump({"focal_len": focal, "frames": frames_meta[:n_frames]}, f)
    with open(os.path.join(path, "transforms_val.json"), "w") as f:
        json.dump({"focal_len": focal, "frames": frames_meta[n_frames:]}, f)

    # audio features: a shared window-encoding of the articulation
    dims = {"deepspeech": 29, "esperanto": 44, "hubert": 1024, "ave": 512}
    d_aud = dims[audio_extractor]
    srng = np.random.default_rng(424242)      # shared basis (one extractor)
    P = srng.normal(size=(art_dims, 16, d_aud)).astype(np.float32)
    P /= np.sqrt(art_dims)
    aud = np.zeros((total, 16, d_aud), np.float32)
    for ti in range(total):
        for wslot in range(16):
            tt = min(max(ti + wslot - 8, 0), total - 1)
            aud[ti, wslot] = motion.art(tt) @ P[:, wslot, :]
    aud += 0.05 * rng.normal(size=aud.shape).astype(np.float32)
    postfix = {"deepspeech": "_ds", "esperanto": "_eo", "hubert": "_hu",
               "ave": "_ave"}[audio_extractor]
    np.save(os.path.join(path, f"aud{postfix}.npy"), aud)

    # au.csv: AU25 tracks the jaw opening, AU45 the blink, AU01/02/05 the
    # brows; each float32 value in numpy's shortest form (as pandas'
    # to_csv writes it)
    t = np.arange(total)
    opens = np.array([0.5 + 0.5 * motion.params(ti)[0] for ti in t],
                     np.float32)
    cols = {}
    for i_au in [1, 2, 4, 5, 6, 7, 9, 10, 12, 14, 15, 17, 20, 23, 25, 26,
                 45]:
        cols[f"AU{i_au:02d}_r"] = np.abs(
            rng.normal(0.3, 0.15, total)).astype(np.float32)
    cols["AU25_r"] = (0.2 + 2.0 * opens).astype(np.float32)
    cols["AU45_r"] = (2.0 * motion.blink).astype(np.float32)
    cols["AU01_r"] = (0.5 + motion.brow).astype(np.float32)
    cols["AU02_r"] = (0.5 + 0.8 * motion.brow).astype(np.float32)
    cols["AU05_r"] = (0.5 - 0.5 * motion.brow).astype(np.float32)
    with open(os.path.join(path, "au.csv"), "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(list(cols))
        writer.writerows(zip(*(v.astype(str) for v in cols.values())))

    xyz, colors = random_init_points(1000, seed)
    write_point_cloud(os.path.join(path, "points3d.ply"), xyz,
                      (colors * 255).astype(np.uint8))
    return motion


def synthesize_articulation_wav(motion: "_MotionModel", total: int,
                                fps: int = 25, sr: int = 16000,
                                seed: int = 0) -> np.ndarray:
    """A WAV whose band energies encode the articulation signals: each
    articulation dim amplitude-modulates one log-spaced sine carrier
    (250 Hz to ~3 kHz), so the deepspeech surrogate features (26 log-mels,
    energy, centroid, flux) recover a(t) linearly and the chain video ->
    process -> train trains an audio-driven motion field with no learned
    extractor."""
    n = int(total / fps * sr)
    tau = np.arange(n, dtype=np.float64) / sr
    # per-sample articulation by linear interpolation of the frame values
    ft = np.clip(tau * fps, 0, total - 1)
    i0 = np.floor(ft).astype(int)
    i1 = np.minimum(i0 + 1, total - 1)
    w1 = ft - i0
    a_frames = np.stack([motion.art(t) for t in range(total)])  # [T, D]
    a_s = a_frames[i0] * (1 - w1[:, None]) + a_frames[i1] * w1[:, None]
    d_dims = a_frames.shape[1]
    freqs = 250.0 * (2.0 ** (0.47 * np.arange(d_dims)))
    sig = np.zeros(n)
    for di in range(d_dims):
        amp = 0.55 + 0.45 * np.tanh(a_s[:, di])
        sig += amp * np.sin(2 * np.pi * freqs[di] * tau + 0.7 * di)
    sig += 0.01 * np.random.default_rng(seed).normal(size=n)
    return (0.5 * sig / np.abs(sig).max()).astype(np.float32)


def render_hard_video(root: str, n_frames: int = 120, size: int = 256,
                      seed: int = 0, n_val: int = 25, fps: int = 25,
                      supersample: int = 2,
                      device: str | torch.device = "cuda"
                      ) -> tuple[str, str]:
    """A raw capture of one hard identity for the preprocessing chain.

    Writes ``<root>/gt_stub/`` (``generate_hard_scene``'s scene: of it the
    chain reads only what its learned extractors would give, the parsing
    masks, landmarks, teeth masks and ``au.csv``), ``<root>/data/video.avi``
    (the stub's frames as an MJPEG AVI at quality 95 with the audio as
    PCM16, through ``io.avmux`` with its frames on ``device``) and
    ``<root>/data/aud.wav`` (the articulation WAV). Everything else (audio
    features, frames, background plate, torso and gt split, head tracking,
    transforms) is computed by ``process --synthetic_gt <root>/gt_stub``.

    Returns (video_path, gt_stub_dir).
    """
    from scipy.io import wavfile

    from ..io.avmux import write_avi_mjpeg_pcm

    dev = resolve_device(device)
    stub = os.path.join(root, "gt_stub")
    data_dir = os.path.join(root, "data")
    os.makedirs(data_dir, exist_ok=True)
    motion = generate_hard_scene(stub, n_frames=n_frames, size=size,
                                 seed=seed, n_val=n_val,
                                 supersample=supersample, device=dev)
    total = n_frames + n_val
    wav = synthesize_articulation_wav(motion, total, fps=fps, seed=seed)
    pcm = (wav * 32767).astype(np.int16)
    wavfile.write(os.path.join(data_dir, "aud.wav"), 16000, pcm)

    frames = read_jpegs([os.path.join(stub, "gt_imgs", f"{i}.jpg")
                         for i in range(total)], dev)
    video_path = os.path.join(data_dir, "video.avi")
    write_avi_mjpeg_pcm(video_path, frames, fps, pcm, 16000,
                        jpeg_quality=95, device=dev)
    return video_path, stub
