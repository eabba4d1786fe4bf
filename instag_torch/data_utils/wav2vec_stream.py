"""Streaming ASR feature frontend (counterpart of
instag_tpu/data_utils/wav2vec_stream.py) — live-mic / file chunked Wav2Vec2
(reference data_utils/wav2vec.py ASR class).

Re-expression of the reference's real-time loop: 20 ms audio chunks are
accumulated with left/right stride context, run through a CTC model, and
the per-frame logits land in a ring buffer from which 16-step attention
windows ([8, D, 16], the renderer's audio input contract) are sliced with
stride 2 — exactly the layout ``make_frame_windows`` produces offline.

Hardware and weights gating:
  * live mode needs ``pyaudio`` — file mode works everywhere and exercises
    the same chunk loop;
  * the CTC model needs a local HF cache and runs on ``device`` — pass
    ``logits_fn`` to inject any frame-level feature producer (tests use a
    deterministic surrogate).

Ref: data_utils/wav2vec.py:16-260 (threads, ring buffer, get_next_feat,
unfold-based save path).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np
import torch

from ..data.audio import load_wav
from ..device import resolve_device


class ASRStreamer:
    SAMPLE_RATE = 16000

    def __init__(self, wav_path: str = "",
                 model_name: str = "cpierse/wav2vec2-large-xlsr-53-esperanto",
                 fps: int = 50, context_size: int = 10,
                 stride_left: int = 8, stride_right: int = 8,
                 audio_dim: int | None = None,
                 logits_fn: Callable[[np.ndarray], np.ndarray] | None = None,
                 save_feats: bool = False,
                 device: str | torch.device = "cuda"):
        self.chunk = self.SAMPLE_RATE // fps           # 320 samples / 20 ms
        self.mode = "live" if wav_path == "" else "file"
        self.context_size = context_size
        self.stride_left = stride_left
        self.stride_right = stride_right
        self.save_feats = save_feats
        self.terminated = False
        self.frames: list[np.ndarray] = []
        if stride_left > 0:
            self.frames.extend([np.zeros(self.chunk, np.float32)] * stride_left)

        if logits_fn is None:
            logits_fn = self._hf_logits_fn(model_name,
                                           resolve_device(device))
        self._logits_fn = logits_fn
        self.audio_dim = audio_dim or (
            44 if "esperanto" in model_name else 32)

        # ring buffer of per-frame feats + the 16-step window assembler
        # (reference :94-101: 4 context blocks, stride-2 window advance)
        self.feat_buffer_size = 4
        self.feat_buffer_idx = 0
        self.feat_queue = np.zeros(
            (self.feat_buffer_size * context_size, self.audio_dim),
            np.float32)
        self.front = self.feat_buffer_size * context_size - 8
        self.tail = 8
        self.att_feats = [np.zeros((self.audio_dim, 16), np.float32)] * 4
        self.all_feats: list[np.ndarray] = []

        if self.mode == "file":
            self._file_stream = self._load_file(wav_path)
            self._file_pos = 0
        else:
            import pyaudio  # gated: live mode only (reference :8)
            self._pa = pyaudio.PyAudio()
            self._in = self._pa.open(format=pyaudio.paInt16, channels=1,
                                     rate=self.SAMPLE_RATE, input=True,
                                     frames_per_buffer=self.chunk)
            self._queue: queue.Queue = queue.Queue()
            self._exit = threading.Event()
            self._reader = threading.Thread(target=self._read_loop,
                                            daemon=True)
            self._reader.start()

    # -- inputs -------------------------------------------------------------

    @staticmethod
    def _hf_logits_fn(model_name, dev: torch.device):
        def fn(wav: np.ndarray) -> np.ndarray:
            from transformers import AutoModelForCTC, AutoProcessor
            proc = AutoProcessor.from_pretrained(model_name,
                                                 local_files_only=True)
            model = AutoModelForCTC.from_pretrained(model_name,
                                                    local_files_only=True)
            inp = proc(wav, sampling_rate=16000, return_tensors="pt")
            with torch.no_grad():
                return model.to(dev).eval()(inp.input_values.to(dev)
                                            ).logits[0].cpu().numpy()
        return fn

    def _load_file(self, path):
        return load_wav(path, self.SAMPLE_RATE)

    def _read_loop(self):
        while not self._exit.is_set():
            raw = self._in.read(self.chunk, exception_on_overflow=False)
            frame = np.frombuffer(raw, np.int16).astype(np.float32) / 32767
            self._queue.put(frame)

    def _next_audio_frame(self):
        if self.mode == "file":
            s = self._file_pos
            if s >= len(self._file_stream):
                return None
            self._file_pos += self.chunk
            frame = self._file_stream[s: s + self.chunk]
            if len(frame) < self.chunk:
                frame = np.pad(frame, (0, self.chunk - len(frame)))
            return frame.astype(np.float32)
        return self._queue.get()

    # -- the chunked inference loop (reference run_step, :164-218) ----------

    def run_step(self) -> None:
        if self.terminated:
            return
        frame = self._next_audio_frame()
        if frame is None:
            self.terminated = True
        else:
            self.frames.append(frame)
            need = self.stride_left + self.context_size + self.stride_right
            if len(self.frames) < need:
                return
        inputs = np.concatenate(self.frames)
        if not self.terminated:
            self.frames = self.frames[-(self.stride_left
                                        + self.stride_right):]
        logits = np.asarray(self._logits_fn(inputs), np.float32)
        # center frames only (strip stride context), context_size of them
        left = max((logits.shape[0] - self.context_size) // 2, 0)
        feats = logits[left: left + self.context_size]
        if feats.shape[0] < self.context_size:
            feats = np.pad(feats, ((0, self.context_size - feats.shape[0]),
                                   (0, 0)))
        if self.save_feats:
            self.all_feats.append(feats)
        if not self.terminated:
            start = self.feat_buffer_idx * self.context_size
            self.feat_queue[start: start + self.context_size] = feats
            self.feat_buffer_idx = (self.feat_buffer_idx
                                    + 1) % self.feat_buffer_size

    def get_next_feat(self) -> np.ndarray:
        """[8, D, 16] attention window for the current frame
        (reference get_next_feat, :144-161)."""
        n = self.feat_queue.shape[0]
        while len(self.att_feats) < 8:
            if self.front < self.tail:
                feat = self.feat_queue[self.front: self.tail]
            else:
                feat = np.concatenate([self.feat_queue[self.front:],
                                       self.feat_queue[: self.tail]], axis=0)
            self.front = (self.front + 2) % n
            self.tail = (self.tail + 2) % n
            self.att_feats.append(feat.T)          # [D, 16]
        out = np.stack(self.att_feats)             # [8, D, 16]
        self.att_feats = self.att_feats[1:]
        return out

    def saved_windows(self) -> np.ndarray:
        """Offline-contract windows from all collected feats
        (reference save path :199-213: 16-window, stride 2, half padding)."""
        feats = np.concatenate(self.all_feats, axis=0)   # [M, D]
        pad = np.zeros((8, feats.shape[1]), feats.dtype)
        padded = np.concatenate([pad, feats, pad], axis=0)
        wins = [padded[s: s + 16]
                for s in range(0, padded.shape[0] - 16 + 1, 2)]
        return np.stack(wins)                            # [M/2+1, 16, D]

    def stop(self) -> None:
        if self.mode == "live":
            self._exit.set()
            self._in.stop_stream()
            self._in.close()
            self._pa.terminate()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
