"""Audio muxing for synthesized clips (counterpart of
instag_tpu/io/avmux.py): the TAIL of the dataset WAV onto a rendered clip
(the val split is the video's last seconds).

Two paths, as in the JAX package:

1. ffmpeg or imageio-ffmpeg present: remux the silent mp4 with the
   tail-aligned wav, stream-copying the video (``-c:v copy``).
2. otherwise a pure-Python AVI (MJPEG video + PCM16 audio) next to it. The
   frames are JPEG-encoded by ``data/image_io.encode_jpeg``: nvJPEG on the
   card, PIL on the CPU (the JAX package uses cv2).

``read_avi_mjpeg`` reads such an AVI back (any RIFF AVI whose video stream
is MJPEG, as OpenCV's and FFmpeg's MJPG writers also write it): the frames'
JPEG bitstreams and the PCM16 audio, with no codec.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import wave

import numpy as np
import torch

from ..data.image_io import encode_jpeg
from ..device import resolve_device


def read_wav_mono(path: str) -> tuple[np.ndarray, int]:
    """PCM16 mono samples + sample rate from a WAV file (stdlib only;
    multi-channel input is averaged, 8/32-bit converted)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    dt = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    data = np.frombuffer(raw, dt).reshape(-1, ch).astype(np.float32)
    if width == 1:
        data = (data - 128.0) * 256.0
    elif width == 4:
        data = data / 65536.0
    mono = data.mean(axis=1)
    return np.clip(mono, -32768, 32767).astype(np.int16), sr


def tail_audio(samples: np.ndarray, sr: int, n_frames: int,
               fps: float) -> np.ndarray:
    """The LAST n_frames/fps seconds of the track (the notebook's
    tail-sync), zero-padded at the front if the track is shorter."""
    n = int(round(n_frames * sr / float(fps)))
    if len(samples) >= n:
        return samples[len(samples) - n:]
    return np.pad(samples, (n - len(samples), 0))


def _ffmpeg_exe() -> str | None:
    import shutil
    exe = shutil.which("ffmpeg")
    if exe:
        return exe
    try:
        import imageio_ffmpeg
        return imageio_ffmpeg.get_ffmpeg_exe()
    except Exception:
        return None


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    out = fourcc + struct.pack("<I", len(payload)) + payload
    if len(payload) % 2:
        out += b"\x00"
    return out


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def write_avi_mjpeg_pcm(path: str, video: np.ndarray, fps: float,
                        pcm: np.ndarray, sr: int,
                        jpeg_quality: int = 92,
                        device: str | torch.device = "cuda") -> None:
    """[T,H,W,3] uint8 RGB (an array, or a tensor on any device) + int16
    mono PCM -> interleaved AVI, the frames JPEG-encoded on ``device``.

    RIFF layout (OpenDML not needed at these sizes): hdrl{avih, strl vids
    MJPG, strl auds PCM} + movi{00dc/01wb per frame} + idx1. Audio chunk i
    carries samples [round(i*sr/fps), round((i+1)*sr/fps)).
    """
    t, h, w = video.shape[:3]
    frames = torch.as_tensor(video).to(resolve_device(device))
    jpegs = [encode_jpeg(f, jpeg_quality) for f in frames]
    pcm = np.ascontiguousarray(pcm, np.int16)

    # ---- headers ----
    avih = struct.pack(
        "<14I", int(round(1e6 / fps)), int(sr * 2 + np.mean(
            [len(j) for j in jpegs]) * fps), 0, 0x10, t, 0, 2,
        max(len(j) for j in jpegs), w, h, 0, 0, 0, 0)

    def strh(fcc, handler, scale, rate, length, sugg, sample_size):
        return struct.pack("<4s4sIHHIIIIIIiI4h", fcc, handler, 0, 0, 0, 0,
                           scale, rate, 0, length, sugg, -1, sample_size,
                           0, 0, w, h)

    strf_v = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                         w * h * 3, 0, 0, 0, 0)
    strl_v = _list(b"strl",
                   _chunk(b"strh", strh(b"vids", b"MJPG", 1000,
                                        int(round(fps * 1000)), t,
                                        max(len(j) for j in jpegs), 0))
                   + _chunk(b"strf", strf_v))
    strf_a = struct.pack("<HHIIHH", 1, 1, sr, sr * 2, 2, 16)
    strl_a = _list(b"strl",
                   _chunk(b"strh", strh(b"auds", b"\x00" * 4, 1, sr,
                                        len(pcm), sr * 2, 2))
                   + _chunk(b"strf", strf_a))
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl_v + strl_a)

    # ---- movi + idx1 ----
    bounds = [int(round(i * sr / float(fps))) for i in range(t + 1)]
    bounds[-1] = len(pcm)
    movi_payload = b""
    idx = b""
    for i in range(t):
        for fcc, payload in ((b"00dc", jpegs[i]),
                             (b"01wb", pcm[bounds[i]:bounds[i + 1]]
                              .tobytes())):
            idx += struct.pack("<4sII", fcc, 0x10,
                               4 + len(movi_payload)) \
                + struct.pack("<I", len(payload))
            movi_payload += _chunk(fcc, payload)
    movi = _list(b"movi", movi_payload)
    riff = hdrl + movi + _chunk(b"idx1", idx)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff) + 4) + b"AVI " + riff)


@dataclasses.dataclass
class AviClip:
    fps: float                   # the video stream's rate / scale
    frames: list[bytes]          # one JPEG bitstream a frame, in order
    pcm: np.ndarray | None       # int16 [samples] (channels averaged)
    sample_rate: int


def _riff_chunks(data: bytes, pos: int, end: int):
    """(fourcc, payload start, payload size) of each chunk in [pos, end)."""
    while pos + 8 <= end:
        fcc, size = struct.unpack("<4sI", data[pos:pos + 8])
        yield fcc, pos + 8, min(size, end - pos - 8)
        pos += 8 + size + (size & 1)


def read_avi_mjpeg(path: str) -> AviClip | None:
    """The frames and audio of an AVI whose video stream is MJPEG, or None
    for any other file (another container, or another video codec). Only
    the first RIFF segment is read (no OpenDML extension); empty video
    chunks (dropped frames) are skipped, as decoders skip them."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        return None
    streams = []                  # (fccType, handler, rate/scale, strf)
    frames, pcm = [], []
    end = min(len(data), 8 + struct.unpack("<I", data[4:8])[0])
    for fcc, p, n in _riff_chunks(data, 12, end):
        if fcc != b"LIST":
            continue
        kind = data[p:p + 4]
        if kind == b"hdrl":
            for sfcc, sp, sn in _riff_chunks(data, p + 4, p + n):
                if sfcc != b"LIST" or data[sp:sp + 4] != b"strl":
                    continue
                strh = strf = b""
                for cfcc, cp, cn in _riff_chunks(data, sp + 4, sp + sn):
                    if cfcc == b"strh":
                        strh = data[cp:cp + cn]
                    elif cfcc == b"strf":
                        strf = data[cp:cp + cn]
                scale, rate = struct.unpack("<II", strh[20:28])
                streams.append((strh[:4], strh[4:8],
                                rate / scale if scale else 0.0, strf))
        elif kind == b"movi":
            vid = next((i for i, st in enumerate(streams)
                        if st[0] == b"vids"), None)
            aud = next((i for i, st in enumerate(streams)
                        if st[0] == b"auds"), None)
            stack = [(p + 4, p + n)]
            while stack:
                lo, hi = stack.pop()
                for cfcc, cp, cn in _riff_chunks(data, lo, hi):
                    if cfcc == b"LIST":          # 'rec ' groups
                        stack.append((cp + 4, cp + cn))
                        continue
                    if not cfcc[:2].isdigit():
                        continue
                    sid = int(cfcc[:2])
                    if sid == vid and cfcc[2:] in (b"dc", b"db") and cn:
                        frames.append(data[cp:cp + cn])
                    elif sid == aud and cfcc[2:] == b"wb":
                        pcm.append(data[cp:cp + cn])
    video = next((st for st in streams if st[0] == b"vids"), None)
    if video is None or b"MJPG" not in (video[1].upper(),
                                        video[3][16:20].upper()):
        return None
    audio = next((st for st in streams if st[0] == b"auds"), None)
    samples, sr = None, 0
    if audio is not None and pcm:
        fmt, ch, sr, _, _, bits = struct.unpack("<HHIIHH", audio[3][:16])
        if fmt == 1 and bits == 16:
            samples = np.frombuffer(b"".join(pcm), "<i2").reshape(-1, ch)
            samples = samples.mean(axis=1).astype(np.int16) if ch > 1 \
                else samples[:, 0].copy()
    return AviClip(video[2], frames, samples, sr)


def mux_audio(out_mp4: str, video: np.ndarray, fps: float,
              wav_path: str, device: str | torch.device = "cuda"
              ) -> str | None:
    """Attach the tail-aligned dataset WAV to a rendered clip.

    Returns the written audio-bearing file, or None (with a loud message)
    when no wav exists. Prefers ffmpeg remux of ``out_mp4`` in place; falls
    back to the pure-Python AVI next to it, its frames encoded on
    ``device``.
    """
    if not os.path.exists(wav_path):
        print(f"[mux_audio] SKIPPED — no wav at {wav_path}", flush=True)
        return None
    samples, sr = read_wav_mono(wav_path)
    samples = tail_audio(samples, sr, len(video), fps)

    exe = _ffmpeg_exe()
    if exe and os.path.exists(out_mp4):
        import subprocess
        import tempfile
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tf:
            tmp = tf.name
        with wave.open(tmp, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(sr)
            f.writeframes(samples.tobytes())
        dst = out_mp4[:-4] + "_audio.mp4"
        try:
            subprocess.run([exe, "-y", "-loglevel", "error", "-i", out_mp4,
                            "-i", tmp, "-c:v", "copy", "-c:a", "aac",
                            "-shortest", dst], check=True)
            return dst
        except Exception as e:
            print(f"[mux_audio] ffmpeg remux failed ({e}); "
                  f"falling back to AVI", flush=True)
        finally:
            os.unlink(tmp)

    dst = (out_mp4[:-4] if out_mp4.endswith(".mp4") else out_mp4) \
        + "_audio.avi"
    write_avi_mjpeg_pcm(dst, video, fps, samples, sr, device=device)
    return dst
