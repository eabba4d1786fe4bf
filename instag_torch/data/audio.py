"""Audio on the host (the port's own copy of instag_tpu/data/audio.py), in
numpy and scipy:

  * ``melspectrogram``: pre-emphasis 0.97, STFT n_fft=800 hop=200 win=800
    (hann, centred, reflect-padded), Slaney mel filterbank of 80 bands over
    55-7600 Hz at 16 kHz, amplitude to dB with a -100 dB floor and -20 dB
    reference, normalized to [-4, 4];
  * ``AudioWindows``: the 16-step mel crops aligned to 25 fps frames that
    the AVE encoder (``models.nets.AudioEncoder``) reads;
  * ``window_audio_features``: the [8, ...] window of per-frame audio
    features around a frame, zero-padded at the clip's ends.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sps
from scipy.io import wavfile


def load_wav(path: str, sr: int = 16000) -> np.ndarray:
    """Load a wav as float32 mono at the given sample rate."""
    in_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if in_sr != sr:
        g = np.gcd(in_sr, sr)
        data = sps.resample_poly(data, sr // g, in_sr // g).astype(np.float32)
    return data


def _hz_to_mel(f):
    """Slaney mel scale (librosa default)."""
    f = np.asanyarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def _mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr=16000, n_fft=800, n_mels=80, fmin=55.0, fmax=7600.0):
    """Slaney-normalized triangular mel filterbank (librosa.filters.mel)."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                     n_mels + 2))
    weights = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _stft_mag(y, n_fft=800, hop=200, win=800):
    """Magnitude STFT matching librosa defaults (centered, reflect pad,
    hann window)."""
    pad = n_fft // 2
    y = np.pad(y, pad, mode="reflect")
    window = sps.get_window("hann", win, fftbins=True)
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * window[None, :]
    return np.abs(np.fft.rfft(frames, n=n_fft, axis=1)).T  # [freq, time]


def melspectrogram(wav: np.ndarray) -> np.ndarray:
    """[80, T] normalized mel (reference utils/audio_utils.py:90-117)."""
    pre = sps.lfilter([1, -0.97], [1], wav)
    mag = _stft_mag(pre)
    mel = mel_filterbank() @ mag
    min_level = np.exp(-5 * np.log(10))
    db = 20 * np.log10(np.maximum(min_level, mel)) - 20
    return np.clip((2 * 4.0) * ((db + 100.0) / 100.0) - 4.0, -4.0, 4.0)


class AudioWindows:
    """Serve 16-step mel crops aligned to 25 fps video frames
    (reference AudDataset, utils/audio_utils.py:120-155)."""

    def __init__(self, wav: np.ndarray, fps: float = 25.0):
        self.orig_mel = melspectrogram(wav).T  # [T, 80]
        self.fps = fps
        self.data_len = int((self.orig_mel.shape[0] - 16) / 80.0 * fps) + 2

    def __len__(self):
        return self.data_len

    def __getitem__(self, idx: int) -> np.ndarray:
        start = int(80.0 * (idx / self.fps))
        end = start + 16
        if end > self.orig_mel.shape[0]:
            end = self.orig_mel.shape[0]
            start = end - 16
        return self.orig_mel[start:end].T[None].astype(np.float32)  # [1,80,16]




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
