"""Audio-feature windows (the port's own copy of
instag_tpu/data/audio.py::window_audio_features)."""

from __future__ import annotations

import numpy as np


def window_audio_features(features: np.ndarray, index: int,
                          half: int = 4) -> np.ndarray:
    """The frame-centred window [index - half, index + half) of
    ``features`` [T, ...], zero-padded past either end: [2 half, ...]."""
    left, right = index - half, index + half
    pad_left = max(0, -left)
    pad_right = max(0, right - features.shape[0])
    window = features[max(0, left): min(features.shape[0], right)]
    if pad_left:
        window = np.concatenate(
            [np.zeros((pad_left,) + window.shape[1:], window.dtype), window], 0)
    if pad_right:
        window = np.concatenate(
            [window, np.zeros((pad_right,) + window.shape[1:], window.dtype)], 0)
    return window
