"""In-memory synthetic models, cameras and frames (counterpart of
instag_tpu/bench_utils.py): point clouds and frames from numpy seeds,
network weights from ``torch.Generator`` seeds. No dataset files needed."""

from __future__ import annotations

import math

import numpy as np
import torch

from .device import resolve_device
from .models.gaussians import GaussianParams, GaussianState, softplus_inverse
from .models.motion import (MotionNetwork, MouthMotionNetwork,
                            PersonalizedMotionNetwork, init_motion_params)
from .render import Camera
from .utils.general import inverse_sigmoid
from .utils.graphics import projection_matrix, world_to_view
from .utils.sh import rgb2sh


def synthetic_camera(size: int, fov: float = 0.5,
                     device: str | torch.device = "cuda") -> Camera:
    """A camera 10/3 units in front of the origin, looking down +z."""
    dev = resolve_device(device)
    w2c = world_to_view(np.eye(3), np.array([0.0, 0.0, 10.0 / 3.0]))
    proj = projection_matrix(0.01, 100.0, fov, fov)
    tan = torch.tensor(np.float32(np.tan(fov / 2)), device=dev)
    return Camera(
        view_transform=torch.from_numpy(np.ascontiguousarray(w2c.T)).to(dev),
        full_proj_transform=torch.from_numpy(
            np.ascontiguousarray((proj @ w2c).T)).to(dev),
        camera_center=torch.from_numpy(
            np.linalg.inv(w2c)[:3, 3].astype(np.float32)).to(dev),
        tanfovx=tan, tanfovy=tan.clone())


def synthetic_state(n: int, capacity: int, seed: int = 0,
                    max_sh_degree: int = 1, spread: float = 0.1,
                    scale: float = 0.01,
                    device: str | torch.device = "cuda") -> GaussianState:
    """n live splats uniform in a cube of half-width ``spread``, padded to
    ``capacity``; every slot at scale ``scale`` and opacity 0.7."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-spread, spread, (n, 3)).astype(np.float32))
    cols = torch.from_numpy(rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32))
    rest_k = (max_sh_degree + 1) ** 2 - 1

    def pad(x):
        return torch.cat([x, x.new_zeros((capacity - n,) + x.shape[1:])])

    raw_scale = float(softplus_inverse(torch.tensor(scale, dtype=torch.float32)))
    raw_opacity = float(inverse_sigmoid(torch.tensor(0.7, dtype=torch.float32)))
    rot = torch.zeros((n, 4))
    rot[:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(pts),
        features_dc=pad(rgb2sh(cols)[:, None, :]),
        features_rest=torch.zeros((capacity, rest_k, 3)),
        identity=torch.zeros((capacity, 1)),
        scaling=torch.full((capacity, 3), raw_scale),
        rotation=pad(rot),
        opacity=torch.full((capacity, 1), raw_opacity))
    params = GaussianParams(**{k: v.to(dev) for k, v in vars(params).items()})
    return GaussianState(params=params,
                         alive=(torch.arange(capacity) < n).to(dev),
                         active_sh_degree=max_sh_degree,
                         max_sh_degree=max_sh_degree)


def synthetic_motion_params(audio_extractor: str = "deepspeech",
                            seed: int = 0,
                            device: str | torch.device = "cuda") -> dict:
    """Random UMF/PMF networks for both branches (one generator seed each)
    plus an audio window [8, 29, 16] and an AU vector [6] from numpy."""
    dev = resolve_device(device)
    nets = dict(
        face_umf=MotionNetwork(audio_extractor),
        mouth_umf=MouthMotionNetwork(audio_extractor),
        face_pmf=PersonalizedMotionNetwork("face", audio_extractor),
        mouth_pmf=PersonalizedMotionNetwork("mouth", audio_extractor))
    for i, net in enumerate(nets.values()):
        gen = torch.Generator().manual_seed(seed * 4 + i)
        init_motion_params(net, gen).to(dev).eval()
    nets["aud"] = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(8, 29, 16)).astype(np.float32)).to(dev)
    nets["exp"] = torch.from_numpy(np.abs(np.random.default_rng(seed + 1).normal(
        0.3, 0.2, 6)).astype(np.float32)).to(dev)
    return nets


def synthetic_frame_batch(size: int, n_frames: int = 4, seed: int = 0,
                          aud_dim: int = 29,
                          device: str | torch.device = "cuda"):
    """A FrameBatch at adaptation-scale shapes: the JAX package's masks and
    lips rectangles, and images, backgrounds, audio and AU vectors drawn
    from ``numpy.random.default_rng(seed)`` in the same order, so both
    packages see the same frames."""
    from .train.common import FrameBatch

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cam = synthetic_camera(size, device=dev)
    f = n_frames

    def tile(x):
        return x[None].expand((f,) + tuple(x.shape)).contiguous()

    def t(x, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(x))
        return (x if dtype is None else x.to(dtype)).to(dev)

    face = np.zeros((f, size, size), bool)
    face[:, size // 4: 3 * size // 4, size // 4: 3 * size // 4] = True
    hair = np.zeros((f, size, size), bool)
    hair[:, size // 8: size // 4, size // 4: 3 * size // 4] = True
    mouth = np.zeros((f, size, size), bool)
    mouth[:, size // 2: 5 * size // 8, 3 * size // 8: 5 * size // 8] = True
    rect = np.tile(np.array([size // 2, 5 * size // 8, 3 * size // 8,
                             5 * size // 8], np.int32), (f, 1))
    image = rng.integers(0, 255, (f, size, size, 3)).astype(np.uint8)
    bg = rng.integers(0, 255, (f, size, size, 3)).astype(np.uint8)
    auds = rng.normal(size=(f, 8, aud_dim, 16)).astype(np.float32)
    blink = rng.uniform(0, 1, (f,)).astype(np.float32)
    au_exp = rng.uniform(0, 1, (f, 6)).astype(np.float32)
    return FrameBatch(
        view_transform=tile(cam.view_transform),
        full_proj_transform=tile(cam.full_proj_transform),
        camera_center=tile(cam.camera_center),
        tanfovx=cam.tanfovx.expand(f).contiguous(),
        tanfovy=cam.tanfovy.expand(f).contiguous(),
        image=t(image), bg=t(bg),
        face_mask=t(face), hair_mask=t(hair), mouth_mask=t(mouth),
        auds=t(auds), blink=t(blink), au_exp=t(au_exp),
        lips_rect=t(rect), lhalf_rect=t(rect),
        mouth_bound=t(np.tile(np.array([0.1, 0.9, 0.5], np.float32), (f, 1))))


def _orbit_camera(i: int, total: int, fov: float):
    """(view^T, (proj view)^T, centre) of frame ``i`` of the synthetic
    scene's orbit: radius 10/3 around the origin, yaw 0.15 sin and pitch
    0.1 cos of 2 pi i / total, OpenGL axes flipped to COLMAP's."""
    theta = 0.15 * np.sin(2 * np.pi * i / total)
    phi = 0.1 * np.cos(2 * np.pi * i / total)
    radius = 10.0 / 3.0
    eye = np.array([radius * np.sin(theta), radius * np.sin(phi),
                    radius * np.cos(theta) * np.cos(phi)])
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = -np.cross(right, forward)     # OpenGL -> COLMAP: y, z flip
    c2w[:3, 2] = forward
    c2w[:3, 3] = eye
    w2c = np.linalg.inv(c2w)
    view = world_to_view(w2c[:3, :3].T, w2c[:3, 3])
    proj = projection_matrix(0.01, 100.0, fov, fov)
    return (view.T.astype(np.float32), (proj @ view).T.astype(np.float32),
            np.linalg.inv(view)[:3, 3].astype(np.float32))


def orbit_frame_batch(size: int, n_frames: int = 16, seed: int = 0,
                      aud_dim: int = 29,
                      device: str | torch.device = "cuda"):
    """A FrameBatch of the JAX package's synthetic talking head
    (instag_tpu/data/synthetic.py at its defaults, drawn in numpy with no
    files): cameras on its orbit (so the scene extent is not 0), a bobbing
    head disc with hair and a mouth ellipse that opens and closes with a
    period of 10 frames, the masks its parsing and teeth give, the lips and
    lower-half rectangles of its landmarks, and ``mouth_bound`` [lb, ub,
    opening] from the openings. Audio windows follow the opening through a
    random projection; blink, AU vectors and the noise come from
    ``numpy.random.default_rng(seed)``.

    Returns ``(batch, meta)``: ``meta`` the float64 FrameMeta of the same
    frames, with the blink draws before their float32 rounding, the
    openings and their bounds, AU25 as the JAX scene writes it (1.2 plus
    the opening phase) clipped at its p95 with its percentiles, and each
    mouth mask's pixel count."""
    from .train.common import FrameBatch, FrameMeta

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    f, h, w = n_frames, size, size
    fov = 2 * math.atan(size / (2 * size * 2.0))     # focal 2 x size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r_head = size * 0.28
    bc = np.array((40, 80, 120), np.uint8)
    fields = {k: [] for k in ("view_transform", "full_proj_transform",
                              "camera_center", "image", "bg", "face_mask",
                              "hair_mask", "mouth_mask", "lips_rect",
                              "lhalf_rect")}
    opens, openness, mouth_px = [], [], []
    for i in range(f):
        phase = float(np.sin(2 * np.pi * i / 10.0))
        cx = w / 2 + 3.0 * np.cos(i / 5.0)
        cy = h / 2 + 2.0 * np.sin(i / 7.0)
        d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        mh, mw = size * 0.03 * (1.2 + phase), size * 0.08
        mouth_cy = cy + r_head * 0.45
        head = d < r_head
        mouth = (((xx - cx) / mw) ** 2 + ((yy - mouth_cy) / mh) ** 2) < 1.0
        hair = (d < r_head * 1.15) & (yy < cy - r_head * 0.5)
        teeth = np.zeros((h, w), bool)
        teeth[int(cy + r_head * 0.40): int(cy + r_head * 0.43),
              int(cx - size * 0.04): int(cx + size * 0.04)] = True
        img = np.broadcast_to(bc, (h, w, 3)).copy()
        img[head] = (200, 160, 140)
        img[mouth] = (120, 40, 40)
        img[hair] = (30, 20, 10)
        bg = np.broadcast_to(bc, (h, w, 3)).copy()
        bg[int(h * 0.85):] = (90, 90, 110)
        # the landmark rectangles: lips ring, mouth ring, nose, jaw
        a3 = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        lips_y = mouth_cy + (mh + 2) * np.sin(a3)
        lips_x = cx + (mw + size * 0.01) * np.cos(a3)
        inner_y = mouth_cy + mh * np.sin(np.linspace(0, 2 * np.pi, 8,
                                                     endpoint=False))
        opens.append(int(inner_y.max()) - int(inner_y.min()))
        openness.append(phase)
        mouth_px.append(int((mouth | teeth).sum()))
        view_t, full_t, center = _orbit_camera(i, f, fov)
        for k, v in (("view_transform", view_t),
                     ("full_proj_transform", full_t),
                     ("camera_center", center), ("image", img), ("bg", bg),
                     ("face_mask", (head & ~hair & ~mouth) ^ teeth),
                     ("hair_mask", hair & ~mouth),
                     ("mouth_mask", mouth | teeth),
                     ("lips_rect", [int(lips_y.min()), int(lips_y.max()),
                                    int(lips_x.min()), int(lips_x.max())]),
                     ("lhalf_rect", [int(cy + r_head * 0.15),
                                     int(max(cy + r_head * 0.8,
                                             lips_y.max())),
                                     int(cx - r_head), int(cx + r_head)])):
            fields[k].append(v)

    proj = rng.normal(size=(8, aud_dim, 16)).astype(np.float32)
    auds = (np.asarray(openness, np.float32)[:, None, None, None] * proj
            + 0.05 * rng.normal(size=(f, 8, aud_dim, 16)).astype(np.float32))
    blink = rng.uniform(0, 1, (f,))
    au_exp = rng.uniform(0, 1, (f, 6)).astype(np.float32)
    bound = np.array([[min(opens), max(opens), o] for o in opens], np.float32)
    au25, au25_pcts = FrameMeta.au25_stats(1.2 + np.asarray(openness))
    meta = FrameMeta(blink=blink, mouth=opens, mouth_lb=min(opens),
                     mouth_ub=max(opens), au25=au25, au25_pcts=au25_pcts,
                     mouth_px=mouth_px)

    def t(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x, dtype))).to(dev)

    tan = np.float32(np.tan(fov / 2))
    return FrameBatch(
        **{k: t(v, np.int32 if k.endswith("rect") else None)
           for k, v in fields.items()},
        tanfovx=t(np.full(f, tan)), tanfovy=t(np.full(f, tan)),
        auds=t(auds), blink=t(blink, np.float32), au_exp=t(au_exp),
        mouth_bound=t(bound)), meta
