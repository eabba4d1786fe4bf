"""CLI: video-against-video evaluation (counterpart of
instag_tpu/cli/metrics.py): PSNR and LPIPS, and the LMD when landmark
files are given.

    python -m instag_torch.cli.metrics --pred out.mp4.frames.npz \
        --gt gt.npz [--lms_pred pred_lms_dir --lms_gt gt_lms_dir] \
        [--track] [--device cuda]

A ``.npz`` input holds the frames [T, H, W, 3] uint8 under ``video`` (as
``synthesize.write_video`` writes them without OpenCV); any other path is
decoded with OpenCV, which must be installed. ``--track`` tracks both
videos' landmarks with the FAN tracker (``metrics.track_video_landmarks``,
weights from ``INSTAG_FAN_WEIGHTS``; without them it says so and the LMD
is left out). Prints
``metrics.evaluate_frames``'s JSON.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from ..device import resolve_device
from ..metrics import evaluate_frames, track_video_landmarks


def _load_video(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        return np.load(path)["video"]
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[:, :, ::-1])  # BGR -> RGB
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def _load_lms_dir(path: str) -> np.ndarray:
    files = sorted(glob.glob(os.path.join(path, "*.lms")),
                   key=lambda p: int(os.path.basename(p).split(".")[0]))
    return np.stack([np.loadtxt(f) for f in files])


def build_parser():
    parser = argparse.ArgumentParser("metrics")
    parser.add_argument("--pred", required=True)
    parser.add_argument("--gt", required=True)
    parser.add_argument("--lms_pred", default="")
    parser.add_argument("--lms_gt", default="")
    parser.add_argument("--track", action="store_true",
                        help="track landmarks on both videos for the LMD "
                             "with the FAN tracker (INSTAG_FAN_WEIGHTS)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    dev = resolve_device(args.device)
    pred = _load_video(args.pred)
    gt = _load_video(args.gt)
    t = min(len(pred), len(gt))
    lp = _load_lms_dir(args.lms_pred) if args.lms_pred else None
    lg = _load_lms_dir(args.lms_gt) if args.lms_gt else None
    if args.track and lp is None:
        lp = track_video_landmarks(pred[:t], dev)
        lg = track_video_landmarks(gt[:t], dev) if lp is not None else None
    if lp is not None and lg is not None:
        tl = min(len(lp), len(lg))
        lp, lg = lp[:tl], lg[:tl]
    out = evaluate_frames(pred[:t], gt[:t], lp, lg, device=dev)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
