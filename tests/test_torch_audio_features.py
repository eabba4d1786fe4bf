"""The port's audio features (``instag_torch.data_utils.audio_features``
and ``wav2vec_stream``) against the JAX package's, on the CPU: the frame
windows, the DeepSpeech surrogate, its MFCC and input vector and the
written ``aud_ds.npy`` bit for bit; the AVE embeddings from one
JAX-written weights file within 1e-5 of their scale; the HuggingFace
extractors refusing without a local cache; and the streaming front end's
windows equal under the JAX test's surrogate CTC."""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.io import wavfile

from instag_tpu.data_utils import audio_features as JA
from instag_tpu.data_utils.wav2vec_stream import ASRStreamer as JStreamer
from instag_tpu.models.nets import AudioEncoder as JAudioEncoder
from instag_torch.data_utils import audio_features as TA
from instag_torch.data_utils.wav2vec_stream import ASRStreamer
from tests.torch_cpu import one_torch_thread  # noqa: F401

SR = 16000


def _speech(seconds=2.0, seed=0):
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.default_rng(seed)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)
    wav = env * (0.3 * np.sin(2 * np.pi * 220 * t)
                 + 0.1 * np.sin(2 * np.pi * 880 * t)) \
        + 0.02 * rng.normal(size=t.shape)
    return wav.astype(np.float32)


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("aud")
    path = str(d / "aud.wav")
    wavfile.write(path, SR, (_speech() * 32767).astype(np.int16))
    return path


def test_windows_surrogate_and_mfcc_are_bit_equal():
    feats = np.random.default_rng(0).normal(size=(203, 29)).astype(np.float32)
    assert np.array_equal(TA.make_frame_windows(feats, 50),
                          JA.make_frame_windows(feats, 50))
    wav = _speech()
    a, b = (TA.deepspeech_surrogate_features(wav),
            JA.deepspeech_surrogate_features(wav))
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(TA._psf_mfcc(wav), JA._psf_mfcc(wav))
    pcm = (wav * 32767).astype(np.int16)
    a, b = TA._deepspeech_input_vector(pcm), JA._deepspeech_input_vector(pcm)
    assert a.shape == b.shape and np.array_equal(a, b)


def test_extract_deepspeech_writes_jax_file(wav_file, tmp_path, monkeypatch):
    monkeypatch.delenv("DEEPSPEECH_PB", raising=False)
    ref, ours = str(tmp_path / "j.npy"), str(tmp_path / "t.npy")
    JA.extract_deepspeech(wav_file, ref)
    TA.extract_deepspeech(wav_file, ours)
    want, got = np.load(ref), np.load(ours)
    assert got.shape == (50, 16, 29) and got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_extract_ave_matches_jax(wav_file, tmp_path, monkeypatch):
    variables = JAudioEncoder().init(jax.random.key(7),
                                     jnp.zeros((1, 80, 16, 1)))
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables),
                                           sep="/")
    # non-trivial statistics, so the eval-mode batch norm is exercised
    rng = np.random.default_rng(3)
    for k in flat:
        if k.endswith("/mean"):
            flat[k] = 0.1 * rng.normal(size=flat[k].shape)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape)
    weights = str(tmp_path / "ave.npz")
    np.savez(weights, **{k: np.asarray(v, np.float32)
                         for k, v in flat.items()})
    monkeypatch.setenv("INSTAG_AVE_WEIGHTS", weights)
    ref, ours = str(tmp_path / "j.npy"), str(tmp_path / "t.npy")
    JA.extract_ave(wav_file, ref)
    TA.extract_ave(wav_file, ours, device="cpu")
    want, got = np.load(ref), np.load(ours)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert want.shape[1:] == (512, 1)
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= 1e-5 * scale


def test_extract_ave_without_weights_warns(wav_file, tmp_path, monkeypatch,
                                           capsys):
    monkeypatch.setenv("INSTAG_AVE_WEIGHTS", str(tmp_path / "absent.npz"))
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    TA.extract_ave(wav_file, a, device="cpu")
    TA.extract_ave(wav_file, b, device="cpu")
    assert "AVE weights not found" in capsys.readouterr().out
    assert np.array_equal(np.load(a), np.load(b))     # seeded init


@pytest.mark.parametrize("which", ["wav2vec", "hubert"])
def test_hf_extractors_refuse_without_a_local_cache(wav_file, tmp_path,
                                                    which):
    name = "instag-tests/no-such-checkpoint"
    fn = {"wav2vec": TA.extract_wav2vec, "hubert": TA.extract_hubert}[which]
    jfn = {"wav2vec": JA.extract_wav2vec, "hubert": JA.extract_hubert}[which]
    with pytest.raises(RuntimeError, match="local cache") as got:
        fn(wav_file, str(tmp_path / "o.npy"), model_name=name, device="cpu")
    with pytest.raises(RuntimeError, match="local cache") as want:
        jfn(wav_file, str(tmp_path / "o.npy"), model_name=name)
    assert str(got.value) == str(want.value)


def _surrogate_logits(x):
    """tests/test_data_utils.py's CTC stand-in: one frame per 20 ms chunk,
    deterministic in the audio content."""
    n = len(x) // 320
    t = x[: n * 320].reshape(n, 320)
    return np.stack([t.mean(1), t.std(1), np.abs(t).max(1)], 1).repeat(
        15, axis=1)[:, :44]


def test_asr_streamer_matches_jax(tmp_path):
    wav = (0.2 * np.sin(np.linspace(0, 600, 2 * SR))).astype(np.float32)
    path = str(tmp_path / "a.wav")
    wavfile.write(path, SR, (wav * 32767).astype(np.int16))
    out = []
    for cls in (JStreamer, ASRStreamer):
        s = cls(path, logits_fn=_surrogate_logits, audio_dim=44,
                save_feats=True)
        feats = []
        for _ in range(120):
            s.run_step()
            feats.append(s.get_next_feat())
            if s.terminated:
                break
        assert s.terminated
        out.append((np.stack(feats), s.saved_windows()))
    (jf, jw), (tf, tw) = out
    assert tf.shape[1:] == (8, 44, 16) and np.abs(tf[20:]).max() > 0
    assert np.array_equal(tf, jf)
    assert tw.shape[1:] == (16, 44) and np.array_equal(tw, jw)
