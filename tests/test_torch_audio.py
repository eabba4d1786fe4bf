"""The port's mel path (wav loading, mel filterbank, mel spectrogram, the
AVE encoder's crops) and its AVE mel encoder against the JAX package's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn as tnn
from scipy.io import wavfile

from instag_tpu.data import audio as JA
from instag_tpu.models.nets import AudioEncoder as JAudioEncoder
from instag_torch.data import audio as TA
from instag_torch.io.from_jax import load_audio_encoder
from instag_torch.io.reference_convert import convert_ave_encoder
from instag_torch.models.nets import AUDIO_ENCODER_SPECS, AudioEncoder
from tests.torch_cpu import one_torch_thread  # noqa: F401

RTOL = 1e-5


def _speech(seconds: float, sr: int, seed: int = 0) -> np.ndarray:
    """A voiced-speech stand-in in [-1, 1]: two formant-like tones with a
    syllable envelope, plus noise."""
    t = np.arange(int(seconds * sr)) / sr
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t) ** 2
    sig = env * (0.5 * np.sin(2 * np.pi * 220 * t)
                 + 0.3 * np.sin(2 * np.pi * 1250 * t))
    sig += 0.05 * np.random.default_rng(seed).normal(size=t.shape)
    return sig / np.abs(sig).max()


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """A 16 kHz int16 mono wav and a 44.1 kHz float32 stereo wav."""
    d = tmp_path_factory.mktemp("wav")
    a = str(d / "a16k.wav")
    wavfile.write(a, 16000, (_speech(1.6, 16000) * 32767).astype(np.int16))
    b = str(d / "b44k.wav")
    s = _speech(1.2, 44100, seed=1)
    wavfile.write(b, 44100, np.stack([s, 0.5 * s], 1).astype(np.float32))
    return a, b


def test_load_wav_matches_jax(wavs):
    for path in wavs:
        ref = JA.load_wav(path)
        out = TA.load_wav(path)
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=1e-7)
    assert len(TA.load_wav(wavs[1])) == int(1.2 * 16000)


def test_mel_filterbank_matches_jax():
    for kw in ({}, {"n_mels": 40, "fmin": 0.0, "fmax": 8000.0}):
        np.testing.assert_allclose(TA.mel_filterbank(**kw),
                                   JA.mel_filterbank(**kw), rtol=RTOL)


def test_melspectrogram_and_windows_match_jax(wavs):
    wav = JA.load_wav(wavs[0])
    mel = TA.melspectrogram(wav)
    assert mel.shape[0] == 80
    np.testing.assert_allclose(mel, JA.melspectrogram(wav), rtol=RTOL,
                               atol=1e-6)
    ours, ref = TA.AudioWindows(wav), JA.AudioWindows(wav)
    assert len(ours) == len(ref) > 30
    for i in (0, 1, len(ref) // 2, len(ref) - 1):      # the last one clamps
        np.testing.assert_allclose(ours[i], ref[i], rtol=RTOL, atol=1e-6)
        assert ours[i].shape == (1, 80, 16)


class _Wav2LipConv(tnn.Module):
    """The reference AVE encoder's block: Conv2d + BatchNorm2d under
    ``conv_block``, ReLU, with an optional residual."""

    def __init__(self, cin, cout, k, s, p, residual=False):
        super().__init__()
        self.conv_block = tnn.Sequential(tnn.Conv2d(cin, cout, k, s, p),
                                         tnn.BatchNorm2d(cout))
        self.residual = residual

    def forward(self, x):
        out = self.conv_block(x)
        return torch.relu(out + x if self.residual else out)


def reference_ave_state_dict(seed: int = 5) -> dict:
    """A reference-layout AVE encoder with random weights and batch-norm
    statistics, as its ``audio_encoder.<i>.conv_block.<j>`` state dict."""
    torch.manual_seed(seed)
    blocks, cin = [], 1
    for cout, k, s, p, res in AUDIO_ENCODER_SPECS:
        b = _Wav2LipConv(cin, cout, k, s, p, res)
        b.conv_block[1].running_mean.normal_(0, 0.1)
        b.conv_block[1].running_var.uniform_(0.5, 1.5)
        b.conv_block[1].weight.data.uniform_(0.5, 1.5)
        b.conv_block[1].bias.data.normal_(0, 0.1)
        blocks.append(b)
        cin = cout
    enc = tnn.Sequential(*blocks).eval()
    return {f"audio_encoder.{k}": v for k, v in enc.state_dict().items()}


def test_audio_encoder_matches_jax(wavs, tmp_path):
    import flax

    path = convert_ave_encoder(reference_ave_state_dict(),
                               str(tmp_path / "ave.npz"))
    data = dict(np.load(path))
    windows = TA.AudioWindows(TA.load_wav(wavs[0]))
    mel = np.stack([windows[i] for i in range(0, len(windows), 5)])
    x = jnp.asarray(mel.transpose(0, 2, 3, 1))            # NCHW -> NHWC
    enc = JAudioEncoder()
    flat = flax.traverse_util.flatten_dict(
        flax.core.unfreeze(jax.eval_shape(enc.init, jax.random.key(0), x)),
        sep="/")
    assert set(flat) == set(data)
    variables = flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in data.items()}, sep="/")
    ref = np.asarray(jax.jit(enc.apply)(variables, x))

    net = load_audio_encoder(AudioEncoder(), data, device="cpu")
    assert not net.training
    with torch.no_grad():
        out = net(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (len(mel), 512)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
