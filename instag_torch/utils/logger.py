"""Training metrics (counterpart of instag_tpu/utils/logger.py): scalars
and histogram summaries as lines of ``metrics.jsonl``, and TensorBoard
through ``torch.utils.tensorboard`` when it imports (the card's machine has
no tensorboard: the log then says so once). The port's traces are
``torch.profiler``'s, with the layers' named spans of ``utils/spans.py``
in them, so the JAX profiler window is not here."""

from __future__ import annotations

import json
import os
import time

import numpy as np

_said_no_tensorboard = False


class MetricsLogger:
    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except ImportError as e:
                global _said_no_tensorboard
                if not _said_no_tensorboard:
                    _said_no_tensorboard = True
                    print(f"[logger] no TensorBoard ({e}); metrics go to "
                          f"{log_dir}/metrics.jsonl only", flush=True)

    def _write(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write({"tag": tag, "value": float(value), "step": int(step),
                     "t": time.time()})
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        """``img``: [3, H, W] float in [0, 1]; TensorBoard only."""
        if self._tb is not None:
            self._tb.add_image(tag, img, step)

    def histogram(self, tag: str, values, step: int) -> None:
        """The values' mean and 5th, 50th and 95th percentiles to
        ``metrics.jsonl``, the histogram to TensorBoard."""
        v = np.asarray(values).reshape(-1)
        self._write({"tag": tag, "step": int(step), "t": time.time(),
                     "mean": float(v.mean()),
                     "p5": float(np.percentile(v, 5)),
                     "p50": float(np.percentile(v, 50)),
                     "p95": float(np.percentile(v, 95))})
        if self._tb is not None:
            self._tb.add_histogram(tag, v, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
