"""Audio muxing against the JAX package (instag_tpu/io/avmux.py): the wav
reader and the tail alignment equal to JAX's, and the MJPEG + PCM AVI,
its frames encoded by PIL on the CPU, parsed as tests/test_avmux.py parses
the JAX package's."""

import os

import numpy as np
import pytest

from instag_tpu.io import avmux as JA
from instag_torch.io import avmux as TA
from tests.test_avmux import _parse_avi_pcm, _sine, _write_wav
from tests.torch_cpu import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n_frames", [50, 130])
def test_tail_audio_and_wav_match_jax(tmp_path, n_frames):
    _write_wav(tmp_path / "a.wav", _sine(16000 * 4), ch=1)
    ref, sr = JA.read_wav_mono(str(tmp_path / "a.wav"))
    out, sr2 = TA.read_wav_mono(str(tmp_path / "a.wav"))
    assert sr == sr2 and np.array_equal(ref, out)
    np.testing.assert_array_equal(TA.tail_audio(out, sr, n_frames, 25),
                                  JA.tail_audio(ref, sr, n_frames, 25))


def test_avi_container_parses_as_jax(tmp_path):
    import cv2
    t, h, w, fps, sr = 10, 48, 64, 25, 8000
    video = np.zeros((t, h, w, 3), np.uint8)
    for i in range(t):                       # solid colors survive JPEG
        video[i] = (20 * i, 128, 255 - 20 * i)
    pcm = _sine(int(t * sr / fps), sr)
    path = str(tmp_path / "out_audio.avi")
    TA.write_avi_mjpeg_pcm(path, video, fps, pcm, sr, device="cpu")
    ref = str(tmp_path / "ref_audio.avi")
    JA.write_avi_mjpeg_pcm(ref, video, fps, pcm, sr)
    # the same chunk layout (the JPEG payloads differ: PIL against cv2)
    np.testing.assert_array_equal(_parse_avi_pcm(path), pcm)
    np.testing.assert_array_equal(_parse_avi_pcm(path), _parse_avi_pcm(ref))

    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[:, :, ::-1])
    assert abs(cap.get(cv2.CAP_PROP_FPS) - fps) < 0.5
    cap.release()
    assert len(frames) == t
    err = np.abs(np.stack(frames).astype(int) - video.astype(int)).mean()
    assert err < 3.0


def test_mux_audio_fallback_on_the_cpu(tmp_path, capsys):
    video = np.full((5, 32, 32, 3), 80, np.uint8)
    out_mp4 = str(tmp_path / "out.mp4")
    assert TA.mux_audio(out_mp4, video, 25.0, str(tmp_path / "none.wav"),
                        device="cpu") is None
    assert "SKIPPED" in capsys.readouterr().out
    _write_wav(tmp_path / "aud.wav", _sine(16000))
    dst = TA.mux_audio(out_mp4, video, 25.0, str(tmp_path / "aud.wav"),
                       device="cpu")
    assert dst is not None and os.path.exists(dst)
    if dst.endswith(".avi"):
        assert len(_parse_avi_pcm(dst)) == int(round(5 * 16000 / 25))
