"""Dataset helpers (the port's own numpy copy of two functions of
instag_tpu/data/dataset.py): the random initial cloud and the scene extent.
The on-disk reader is not ported yet; the trainers take an in-memory
``FrameBatch``."""

from __future__ import annotations

import numpy as np

from ..utils.sh import C0


def scene_extent(camera_centers) -> tuple[np.ndarray, float]:
    """NeRF++-style normalization of cameras at ``camera_centers`` [F, 3]:
    their mean and 1.1 x the largest distance from it."""
    centers = np.asarray(camera_centers, np.float64)
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
