"""Seeded inputs of the benchmark's cells, made from ``--seed`` alone: the
Gaussian clouds and the motion nets' weights on the device from one
``torch.Generator`` each, in a few large draws; cameras, audio windows and
AU vectors of each client's 25 FPS track.

Frozen with the benchmark (a copy of the data ``instag_torch/bench_utils.py``
draws, widened to what the cells need); it imports nothing of the program,
so the program and the plain reference receive the same tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed derived from the run's ``--seed`` and a salt (the
    client's index, the kind of draw)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *salt])
    hi, lo = (int(x) for x in ss.generate_state(2, np.uint32))
    return ((hi << 32) | lo) >> 1


def generator(seed: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def softplus_inverse(y: torch.Tensor) -> torch.Tensor:
    return y + torch.log(-torch.expm1(-y))


def logit(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p / (1.0 - p))


def rgb2sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / 0.28209479177387814


def cloud(gen: torch.Generator, n_live: int, capacity: int, sh_degree: int,
          center, half_axes, scale_range, opacity_range, dev) -> dict:
    """Raw parameters of a cloud of ``n_live`` splats in ``capacity`` slots
    (the program's layout: pre-softplus scales, pre-sigmoid opacities, SH
    coefficients [C, K, 3]). The live splats fill an ellipsoid around
    ``center``; the dead slots are zero, with ``alive`` False, as a padded
    cloud holds them."""
    n, cap = n_live, capacity
    rest_k = (sh_degree + 1) ** 2 - 1
    u = torch.rand((n, 14), generator=gen, device=dev)
    g = torch.randn((n, 4 + 3 * rest_k + 3), generator=gen, device=dev)
    dirs = g[:, 4 + 3 * rest_k:]
    dirs = dirs / dirs.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    radius = u[:, 0:1] ** (1.0 / 3.0)
    xyz = (torch.tensor(center, dtype=torch.float32, device=dev)
           + dirs * radius * torch.tensor(half_axes, dtype=torch.float32,
                                          device=dev))
    lo, hi = (math.log(s) for s in scale_range)
    scale = torch.exp(lo + (hi - lo) * u[:, 1:4])
    opacity = opacity_range[0] + (opacity_range[1] - opacity_range[0]) * u[:, 4:5]
    rgb = 0.15 + 0.7 * u[:, 5:8]

    def pad(x):
        return torch.cat([x, x.new_zeros((cap - n,) + x.shape[1:])])

    return dict(
        xyz=pad(xyz),
        features_dc=pad(rgb2sh(rgb)[:, None, :]),
        features_rest=pad(0.05 * g[:, 4:4 + 3 * rest_k].reshape(n, rest_k, 3)),
        identity=torch.zeros((cap, 1), device=dev),
        scaling=pad(softplus_inverse(scale)),
        rotation=pad(g[:, :4]),
        opacity=pad(logit(opacity)),
        alive=torch.arange(cap, device=dev) < n)


def net_params(shapes: dict, gen: torch.Generator, dev,
               embed_bound: float, bias_bound: float) -> dict:
    """Weights for the named parameter shapes, in one draw: hash tables
    U(+-embed_bound), biases U(+-bias_bound), other weights
    U(+-sqrt(3 / fan_in)) (variance 1 / fan_in)."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=gen, device=dev) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        if name.endswith("embeddings"):
            bound = embed_bound
        elif name.endswith("bias"):
            bound = bias_bound
        else:
            bound = math.sqrt(3.0 / math.prod(shape[1:]))
        out[name] = (flat[at:at + size] * bound).reshape(shape)
        at += size
    return out


def projection_matrix(znear: float, zfar: float, tan_half: float) -> np.ndarray:
    """The program's perspective projection (z in [0, zfar/(zfar-znear)])
    for a square field of view."""
    P = np.zeros((4, 4), np.float64)
    P[0, 0] = P[1, 1] = 1.0 / tan_half
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def _rotation(yaw, pitch, roll) -> np.ndarray:
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return rz @ rx @ ry


def camera_track(rng: np.random.Generator, n_frames: int, size: int,
                 focal: float, distance: float, pose_amp: float) -> dict:
    """Per-frame cameras of a talking head: the head at the origin, the
    camera ``distance`` in front of it, and a head pose that sways by up to
    ``pose_amp`` radians (yaw, pitch, roll) and 1 % of the distance, on
    sinusoids of random period and phase. Returns the program's transposed
    row-vector matrices as float32 arrays."""
    tan_half = size / (2.0 * focal)
    P = projection_matrix(0.01, 100.0, tan_half)
    per = rng.uniform(40, 160, 6)
    ph = rng.uniform(0, 2 * np.pi, 6)
    view, full, center = [], [], []
    for i in range(n_frames):
        w = np.sin(2 * np.pi * i / per + ph)
        V = np.eye(4)
        V[:3, :3] = _rotation(*(pose_amp * w[:3]))
        V[:3, 3] = [0.01 * distance * w[3], 0.01 * distance * w[4],
                    distance * (1.0 + 0.01 * w[5])]
        view.append(V.T)
        full.append((P @ V).T)
        center.append(np.linalg.inv(V)[:3, 3])
    f32 = lambda x: np.ascontiguousarray(np.asarray(x, np.float32))
    return dict(view=f32(view), full=f32(full), center=f32(center),
                tan=np.float32(tan_half))


def audio_track(gen: torch.Generator, n_frames: int, window, dev):
    """Audio feature windows [F, *window]: a smooth random walk over the
    frames plus per-window noise, as consecutive windows of one track
    overlap."""
    walk = torch.randn((n_frames,) + tuple(window), generator=gen, device=dev)
    walk = torch.cumsum(walk, 0) / math.sqrt(8.0)
    walk = walk - walk.mean(0, keepdim=True)
    return 0.7 * walk / walk.std().clamp_min(1e-6) + 0.3 * torch.randn(
        walk.shape, generator=gen, device=dev)


def au_track(gen: torch.Generator, n_frames: int, dev):
    """AU vectors [F, 6] in [0, 1] (five expression units and the blink)."""
    return torch.rand((n_frames, 6), generator=gen, device=dev)


def torso(gen: torch.Generator, size: int, dev) -> torch.Tensor:
    """A smooth torso background [H, W, 3] uint8: random 8x8 colours,
    bilinearly widened."""
    low = torch.rand((1, 3, 8, 8), generator=gen, device=dev)
    img = torch.nn.functional.interpolate(low, size=(size, size),
                                          mode="bilinear", align_corners=True)
    return (img[0].permute(1, 2, 0) * 255.0).to(torch.uint8).contiguous()


def talking_frames(gen: torch.Generator, rng: np.random.Generator,
                   n_frames: int, size: int, dev) -> dict:
    """Training frames of a talking head at ``size``²: a textured head
    disc that sways over a torso background, a hair cap, a mouth ellipse
    that opens and closes, the masks a face parser gives them, the lips
    and lower-face rectangles of the landmarks, and the curriculum values
    (mouth openings, blinks, AU25) in float64 on the host."""
    f, s = n_frames, size
    i = np.arange(f, dtype=np.float64)
    per = rng.uniform(60, 140, 3)
    ph = rng.uniform(0, 2 * np.pi, 3)
    cx = s / 2 + 0.02 * s * np.sin(2 * np.pi * i / per[0] + ph[0])
    cy = s / 2 + 0.02 * s * np.sin(2 * np.pi * i / per[1] + ph[1])
    opening = 0.5 + 0.5 * np.sin(2 * np.pi * i / rng.uniform(6, 14) + ph[2])
    r = 0.28 * s
    mh = s * 0.012 * (1.0 + 2.0 * opening)
    mw = s * 0.07
    mcy = cy + 0.45 * r
    yy = torch.arange(s, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(s, device=dev, dtype=torch.float32)[None, None, :]
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)[:, None, None]
    d = torch.sqrt((xx - t(cx)) ** 2 + (yy - t(cy)) ** 2)
    head = d < r
    mouth = ((xx - t(cx)) / mw) ** 2 + ((yy - t(mcy)) / t(mh)) ** 2 < 1.0
    hair = (d < 1.15 * r) & (yy < t(cy) - 0.5 * r)
    tex = torch.nn.functional.interpolate(
        torch.rand((1, 3, 16, 16), generator=gen, device=dev), size=(s, s),
        mode="bilinear", align_corners=True)[0].permute(1, 2, 0)
    skin = (0.45 + 0.4 * tex) * 255.0
    bg = torso(gen, s, dev)
    img = bg[None].expand(f, s, s, 3).float().clone()
    img = torch.where(head[..., None], skin[None], img)
    img = torch.where(mouth[..., None], torch.tensor(
        [110.0, 35.0, 40.0], device=dev), img)
    img = torch.where(hair[..., None], torch.tensor(
        [30.0, 22.0, 12.0], device=dev), img)
    lips = np.stack([mcy - mh - 2, mcy + mh + 2, cx - mw - 0.01 * s,
                     cx + mw + 0.01 * s], 1).astype(np.int32)
    lhalf = np.stack([cy + 0.15 * r, np.maximum(cy + 0.8 * r, lips[:, 1]),
                      cx - r, cx + r], 1).astype(np.int32)
    mouth_px = np.round(np.pi * mw * mh).astype(np.int64)
    openings = np.round(2 * mh).astype(np.float64)
    blink = rng.uniform(0, 1, f)
    au25 = 1.2 + opening
    au = torch.rand((f, 6), generator=gen, device=dev)
    au[:, 5] = torch.tensor(blink, dtype=torch.float32, device=dev)
    return dict(
        image=img.to(torch.uint8), bg=bg[None].expand(f, s, s, 3),
        face_mask=head & ~hair & ~mouth, hair_mask=hair & ~mouth,
        mouth_mask=mouth,
        lips_rect=torch.from_numpy(lips).to(dev),
        lhalf_rect=torch.from_numpy(lhalf).to(dev),
        mouth_bound=torch.tensor(np.stack(
            [np.full(f, openings.min()), np.full(f, openings.max()),
             openings], 1), dtype=torch.float32, device=dev),
        blink=torch.tensor(blink, dtype=torch.float32, device=dev),
        au_exp=au,
        meta=dict(blink=blink, mouth=openings, mouth_lb=float(openings.min()),
                  mouth_ub=float(openings.max()), au25_raw=au25,
                  mouth_px=mouth_px))
