"""Offline evaluation (counterpart of instag_tpu/metrics.py): PSNR and
LPIPS over frame sequences, the mouth landmark distance (LMD) from
landmark arrays, and the AU error of two OpenFace CSVs.

The LMD of rendered frames comes from the FAN landmark tracker
(``data_utils/landmarks.py``), which needs its weights
(``INSTAG_FAN_WEIGHTS``); without them ``track_video_landmarks`` says so
and returns None, as the JAX one does. The ground truth's landmarks are
the dataset's ``.lms`` files.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .data.dataset import read_au_csv
from .device import resolve_device
from .models.lpips import load_lpips_params


def _unit(frames: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(frames)).to(dev, torch.float32)


def video_psnr(frames_a: np.ndarray, frames_b: np.ndarray,
               device: str | torch.device = "cuda") -> float:
    """Mean per-frame PSNR of two [T, H, W, 3] uint8 sequences."""
    dev = resolve_device(device)
    a, b = _unit(frames_a, dev) / 255.0, _unit(frames_b, dev) / 255.0
    mse = torch.mean((a - b) ** 2, dim=(1, 2, 3))
    return float(torch.mean(20 * torch.log10(1.0 / torch.sqrt(mse))))


@torch.no_grad()
def video_lpips(frames_a: np.ndarray, frames_b: np.ndarray, batch: int = 8,
                device: str | torch.device = "cuda") -> float:
    """Mean LPIPS (AlexNet; random features unless converted weights are
    present, see ``models.lpips``) of two [T, H, W, 3] uint8 sequences,
    ``batch`` frames at a time."""
    dev = resolve_device(device)
    model, _ = load_lpips_params(device=dev)
    vals = []
    for s in range(0, len(frames_a), batch):
        a = _unit(frames_a[s:s + batch], dev) / 127.5 - 1.0
        b = _unit(frames_b[s:s + batch], dev) / 127.5 - 1.0
        vals.append(model(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)))
    return float(torch.cat(vals).mean())


def load_gt_landmarks(source_path: str, img_ids: list[int]
                      ) -> np.ndarray | None:
    """The dataset's ``ori_imgs/<id>.lms`` landmarks of the frames [T, 68,
    2]; None when one is missing."""
    out = []
    for i in img_ids:
        p = os.path.join(source_path, "ori_imgs", f"{i}.lms")
        if not os.path.exists(p):
            return None
        out.append(np.loadtxt(p, dtype=np.float32))
    return np.stack(out)


def track_video_landmarks(frames: np.ndarray,
                          device: str | torch.device = "cuda"
                          ) -> np.ndarray | None:
    """The FAN tracker's landmarks [T, 68, 2] of frames [T, H, W, 3] uint8
    (the reference metrics.py LMDMeter protocol, which tracks both
    videos), on ``device``; None, with a message, when the FAN weights are
    not found."""
    from .data_utils.landmarks import LandmarkTracker
    dev = resolve_device(device)
    try:
        tracker = LandmarkTracker(device=dev)
    except RuntimeError as e:           # no weights
        print(f"[metrics] LMD SKIPPED — FAN landmark tracker unavailable: "
              f"{e}", flush=True)
        return None
    return np.stack([tracker(np.asarray(f)) for f in frames])


def lmd_from_landmarks(lms_a: np.ndarray, lms_b: np.ndarray) -> float:
    """Mean distance of the mouth landmarks (48:68), each face centred on
    its landmarks' mean: lms [T, 68, 2]."""
    def norm(lms):
        return lms[:, 48:68] - lms.mean(axis=1, keepdims=True)
    return float(np.linalg.norm(norm(lms_a) - norm(lms_b), axis=-1).mean())


AU_COLS = [1, 2, 4, 5, 6, 7, 9, 10, 12, 14, 15, 17, 20, 23, 25, 26, 45]
AU_LOWER = [10, 12, 14, 15, 17, 20, 23, 25, 26]
AU_UPPER = [1, 2, 4, 5, 6, 7, 9, 45]


def au_error(csv_a: str, csv_b: str) -> dict:
    """The mean squared error of the AU intensities of two OpenFace CSVs
    over their common length: all 17, the lower face and the upper face."""
    a, b = ({k.strip(): v for k, v in read_au_csv(p).items()}
            for p in (csv_a, csv_b))
    t = min(len(next(iter(a.values()))), len(next(iter(b.values()))))

    def mse(cols):
        return float(np.mean([np.mean((a[f"AU{i:02d}_r"][:t]
                                       - b[f"AU{i:02d}_r"][:t]) ** 2)
                              for i in cols]))
    return {"au_all": mse(AU_COLS), "au_lower": mse(AU_LOWER),
            "au_upper": mse(AU_UPPER)}


def evaluate_frames(pred: np.ndarray, gt: np.ndarray,
                    lms_pred: np.ndarray | None = None,
                    lms_gt: np.ndarray | None = None,
                    device: str | torch.device = "cuda") -> dict:
    """PSNR, LPIPS and whether LPIPS had converted weights
    (``lpips_real``) of [T, H, W, 3] uint8 frames against the ground truth,
    and the LMD when both landmark arrays are given."""
    dev = resolve_device(device)
    out = {"psnr": video_psnr(pred, gt, dev),
           "lpips": video_lpips(pred, gt, device=dev),
           "lpips_real": load_lpips_params(device=dev)[1]}
    if lms_pred is not None and lms_gt is not None:
        out["lmd"] = lmd_from_landmarks(lms_pred, lms_gt)
    return out
