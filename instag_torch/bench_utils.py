"""In-memory synthetic model and camera builders (counterpart of
instag_tpu/bench_utils.py): point clouds from numpy seeds, network weights
from ``torch.Generator`` seeds. No dataset files needed."""

from __future__ import annotations

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
