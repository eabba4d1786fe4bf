"""The preprocessing tasks (counterpart of
instag_tpu/data_utils/process.py):

    python -m instag_torch.data_utils.process <video> [--task N] [--asr X]
        [--synthetic_gt <stub>] [--device cpu]

Tasks: 1 extract audio, 2 audio features, 3 frames, 4 semantic parsing,
5 background, 6 torso + gt, 7 landmarks, 8 head tracking, 9 transforms
json (10: the split.py variant, the last 12 s as val), 11 teeth masks,
12 geometry priors.

JPEGs decode and encode on ``--device`` (nvJPEG on the card, PIL on the
CPU; ``data/image_io.py``) and PNGs through ``image_io``'s own codec; the
background plate, the torso columns and the blur are numpy and scipy on the
host; the pose solve, the photometric 3DMM fit, the AVE encoder and the
learned extractors (BiSeNet for task 4, FAN for task 7, the EasyPortrait
FPN or a TorchScript segmentor for task 11, sapiens for task 12) run on the
device, with OpenCV's resizes done by ``cv_ops``. Each extractor names the
environment variable of its weights and raises without them;
``--synthetic_gt`` takes tasks 4, 7 and 11 from a generator's stub
instead. An MJPEG AVI (what ``data.synthetic_hard.render_hard_video`` and
OpenCV's MJPG writer write) is demuxed by ``io.avmux.read_avi_mjpeg``;
another container needs OpenCV.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import time

import numpy as np
import torch
from scipy.io import wavfile
from scipy.ndimage import binary_dilation
from scipy.spatial import cKDTree

from ..data.audio import load_wav
from ..data.image_io import (decode_jpegs, jpeg_size, read_jpegs, read_png,
                             write_jpeg, write_png)
from ..device import resolve_device
from ..io.avmux import read_avi_mjpeg
from .face_parsing import run_parsing
from .landmarks import extract_landmarks_fan
from .priors import create_teeth_masks, run_sapiens

FRAME_CHUNK = 32        # frames a task decodes on the device at a time
ORI_QUALITY = 98        # ori_imgs/*.jpg, as the JAX package writes them
JPEG_QUALITY = 95       # bc.jpg and gt_imgs/*.jpg (OpenCV's default)

# parsing colours in RGB (the JAX package reads them as OpenCV's BGR)
HEAD = (0, 0, 255)
NECK = (0, 255, 0)
TORSO = (255, 0, 0)
WHITE = (255, 255, 255)


def _by_index(paths: list[str]) -> list[str]:
    return sorted(paths, key=lambda p: int(os.path.basename(p).split(".")[0]))


def _chunks(seq, n: int = FRAME_CHUNK):
    for s in range(0, len(seq), n):
        yield seq[s:s + n]


def extract_audio(path: str, out_path: str, sample_rate: int = 16000) -> None:
    """Task 1: video -> 16 kHz wav. A wav input is resampled here; a video
    needs ffmpeg, or else a pre-extracted ``aud.wav`` beside it."""
    print(f"[INFO] extract audio {path} -> {out_path}")
    if path.endswith(".wav"):
        wav = load_wav(path, sample_rate)
        wavfile.write(out_path, sample_rate, (wav * 32767).astype(np.int16))
        return
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        if os.path.exists(out_path):
            print(f"[INFO] no ffmpeg; using pre-extracted {out_path}")
            return
        raise RuntimeError(
            "ffmpeg is not available in this environment; provide a "
            "pre-extracted aud.wav next to the video instead")
    subprocess.run([ffmpeg, "-y", "-i", path, "-f", "wav",
                    "-ar", str(sample_rate), out_path], check=True)


def extract_audio_features(wav_path: str, mode: str = "deepspeech",
                           device: str | torch.device = "cuda") -> None:
    """Task 2: wav -> per-frame feature windows."""
    from .audio_features import extract_features
    extract_features(wav_path, mode, device)


def resample_indices(n_src: int, src_fps: float, fps: int) -> list[int]:
    """The source frames a ``fps`` video keeps from ``n_src`` frames at
    ``src_fps``: the first frame at or after each 1/fps step."""
    step = src_fps / fps
    nxt, keep = 0.0, []
    for i in range(n_src):
        if i >= nxt - 1e-6:
            keep.append(i)
            nxt += step
    return keep


def extract_images(path: str, out_dir: str, fps: int = 25,
                   device: str | torch.device = "cuda") -> None:
    """Task 3: video -> ``{i}.jpg`` at ``fps`` (quality 98). An MJPEG AVI is
    demuxed here and its frames decode and re-encode on ``device``; any
    other container goes through OpenCV, which must then be installed."""
    dev = resolve_device(device)
    print(f"[INFO] extract images {path} -> {out_dir}")
    os.makedirs(out_dir, exist_ok=True)
    clip = read_avi_mjpeg(path)
    if clip is None:
        _extract_images_cv2(path, out_dir, fps)
        return
    keep = resample_indices(len(clip.frames), clip.fps or fps, fps)
    out_idx = 0
    for chunk in _chunks(keep):
        for img in decode_jpegs([clip.frames[i] for i in chunk], dev):
            write_jpeg(os.path.join(out_dir, f"{out_idx}.jpg"), img,
                       ORI_QUALITY)
            out_idx += 1
    print(f"[INFO] extracted {out_idx} frames")


def _extract_images_cv2(path: str, out_dir: str, fps: int) -> None:
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{path} is not an MJPEG AVI, and reading other containers needs "
            "OpenCV, which is not installed; convert the video to an MJPEG "
            "AVI (e.g. io.avmux.write_avi_mjpeg_pcm, or ffmpeg -c:v mjpeg) "
            "to read it without OpenCV") from e
    cap = cv2.VideoCapture(path)
    src_fps = cap.get(cv2.CAP_PROP_FPS) or fps
    step = src_fps / fps
    nxt, src_idx, out_idx = 0.0, 0, 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if src_idx >= nxt - 1e-6:
            cv2.imwrite(os.path.join(out_dir, f"{out_idx}.jpg"), frame,
                        [cv2.IMWRITE_JPEG_QUALITY, ORI_QUALITY])
            out_idx += 1
            nxt += step
        src_idx += 1
    cap.release()
    print(f"[INFO] extracted {out_idx} frames")


def _parsing_path(image_path: str) -> str:
    return image_path.replace("ori_imgs", "parsing").replace(".jpg", ".png")


def _is(seg: np.ndarray, rgb) -> np.ndarray:
    return ((seg[..., 0] == rgb[0]) & (seg[..., 1] == rgb[1])
            & (seg[..., 2] == rgb[2]))


def gaussian_blur5(img: np.ndarray) -> np.ndarray:
    """OpenCV's ``GaussianBlur(img, (5, 5), 0)`` on uint8 [H, W, C], bit
    for bit: the binomial kernel [1, 4, 6, 4, 1] / 16 along each axis in
    integers, rounded once, with the border reflected about its edge
    pixel (BORDER_REFLECT_101)."""
    k = (1, 4, 6, 4, 1)
    p = np.pad(img.astype(np.int32), ((2, 2), (2, 2), (0, 0)),
               mode="reflect")
    h, w = img.shape[:2]
    rows = sum(k[i] * p[i:i + h] for i in range(5))
    out = sum(k[j] * rows[:, j:j + w] for j in range(5))
    return ((out + 128) >> 8).astype(np.uint8)


def background_plate(imgs: np.ndarray, parses: np.ndarray) -> np.ndarray:
    """The background plate [H, W, 3] of sampled frames [S, H, W, 3] and
    their parsings: per pixel the frame where it lies farthest from any
    foreground, then a nearest-neighbour fill of the pixels never more than
    5 px from one."""
    s, h, w = imgs.shape[:3]
    all_xys = np.mgrid[0:h, 0:w].reshape(2, -1).T
    dists = []
    for parse in parses:
        fg_xys = np.stack(np.nonzero(~_is(parse, WHITE))).T
        d, _ = cKDTree(fg_xys).query(all_xys, k=1)
        dists.append(d)
    dists = np.stack(dists)                      # [S, h*w]
    max_dist = dists.max(0)
    max_id = dists.argmax(0)

    flat = imgs.reshape(s, -1, 3)
    bc = np.zeros((h * w, 3), np.uint8)
    far_idx = np.nonzero(max_dist > 5)[0]
    bc[far_idx] = flat[max_id[far_idx], far_idx]
    bc = bc.reshape(h, w, 3)

    # fill pixels that were never clearly background from their nearest
    # background pixel
    far2 = (max_dist > 5).reshape(h, w)
    fg_xys = np.stack(np.nonzero(far2)).T
    bg_xys = np.stack(np.nonzero(~far2)).T
    if len(bg_xys) and len(fg_xys):
        _, idx = cKDTree(fg_xys).query(bg_xys, k=1)
        src = fg_xys[idx]
        bc[bg_xys[:, 0], bg_xys[:, 1]] = bc[src[:, 0], src[:, 1]]
    return bc


def extract_background(base_dir: str, ori_imgs_dir: str,
                       device: str | torch.device = "cuda") -> None:
    """Task 5: ``bc.jpg`` from every 20th frame, decoded and encoded on
    ``device``."""
    dev = resolve_device(device)
    print("[INFO] extract background")
    paths = _by_index(glob.glob(os.path.join(ori_imgs_dir, "*.jpg")))[::20]
    imgs = read_jpegs(paths, dev).cpu().numpy()
    parses = np.stack([read_png(_parsing_path(p), 3) for p in paths])
    write_jpeg(os.path.join(base_dir, "bc.jpg"),
               torch.from_numpy(background_plate(imgs, parses)).to(dev),
               JPEG_QUALITY)


def _column_tops(part: np.ndarray):
    """The topmost pixel (row, col) of each column of ``part`` that has
    one, left to right, and each such column's pixel count."""
    coords = np.stack(np.nonzero(part), -1)
    if len(coords) == 0:
        return None, None
    coords = coords[np.lexsort((coords[:, 0], coords[:, 1]))]
    _, uid, ucnt = np.unique(coords[:, 1], return_index=True,
                             return_counts=True)
    return coords[uid], ucnt


def _paint_up(torso_img, mask, tops, gt, length):
    """Paint ``length`` pixels up from each top (row, col) in its colour in
    ``gt``, fading by 0.98 a pixel, and mark them in ``mask``."""
    colors = gt[tuple(tops.T)]
    coords = tops[None].repeat(length, 0)
    coords = coords + np.stack(
        [-np.arange(length), np.zeros(length, np.int64)], -1)[:, None]
    coords = coords.reshape(-1, 2).clip(0, None)
    cols = (colors[None].repeat(length, 0)
            * (0.98 ** np.arange(length)).reshape(length, 1, 1)
            ).reshape(-1, 3)
    torso_img[tuple(coords.T)] = cols
    mask[tuple(coords.T)] = True


def torso_and_gt(ori: np.ndarray, seg: np.ndarray,
                 bg_image: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One frame's ground truth (the frame with its background replaced by
    the plate) [H, W, 3] and torso RGBA [H, W, 4] (head removed, the torso
    and neck painted up into the head's hole, the neck's painted pixels
    blurred), from the frame, its parsing and the plate, all RGB uint8."""
    head, neck = _is(seg, HEAD), _is(seg, NECK)
    torso, bg = _is(seg, TORSO), _is(seg, WHITE)

    gt = ori.copy()
    gt[bg] = bg_image[bg]
    torso_img = gt.copy()
    torso_img[head] = bg_image[head]
    alpha = 255 * np.ones(gt.shape[:2] + (1,), np.uint8)

    inpaint_torso_mask = None
    tops, _ = _column_tops(torso)
    if tops is not None:
        ok = head[tuple((tops - np.array([1, 0])).T)]
        if ok.any():
            inpaint_torso_mask = np.zeros(gt.shape[:2], bool)
            _paint_up(torso_img, inpaint_torso_mask, tops[ok], gt, 9)

    push_down = 4
    neck_d = binary_dilation(
        neck, structure=np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0]], bool),
        iterations=3)
    tops, ucnt = _column_tops(neck_d)
    inpaint_mask = np.zeros(gt.shape[:2], bool)
    if tops is not None:
        ok = head[tuple((tops - np.array([1, 0])).clip(0, None).T)]
        tops = tops[ok]
        if len(tops):
            off = np.minimum(ucnt[ok] - 1, push_down)
            tops = tops + np.stack([off, np.zeros_like(off)], -1)
            _paint_up(torso_img, inpaint_mask, tops, gt, 48 + push_down + 1)
            blur = gaussian_blur5(torso_img)
            torso_img[inpaint_mask] = blur[inpaint_mask]

    mask = neck_d | torso | inpaint_mask
    if inpaint_torso_mask is not None:
        mask |= inpaint_torso_mask
    torso_img[~mask] = 0
    alpha[~mask] = 0
    return gt, np.concatenate([torso_img, alpha], -1)


def extract_torso_and_gt(base_dir: str, ori_imgs_dir: str,
                         device: str | torch.device = "cuda") -> None:
    """Task 6: ``gt_imgs/{i}.jpg`` and ``torso_imgs/{i}.png`` of every
    frame, the JPEGs decoded and encoded on ``device``."""
    dev = resolve_device(device)
    print("[INFO] extract torso + gt")
    bg_image = read_jpegs([os.path.join(base_dir, "bc.jpg")],
                          dev)[0].cpu().numpy()
    os.makedirs(os.path.join(base_dir, "gt_imgs"), exist_ok=True)
    os.makedirs(os.path.join(base_dir, "torso_imgs"), exist_ok=True)
    paths = sorted(glob.glob(os.path.join(ori_imgs_dir, "*.jpg")))
    for chunk in _chunks(paths):
        for path, ori in zip(chunk, read_jpegs(chunk, dev).cpu().numpy()):
            gt, torso = torso_and_gt(ori, read_png(_parsing_path(path), 3),
                                     bg_image)
            write_jpeg(path.replace("ori_imgs", "gt_imgs"),
                       torch.from_numpy(gt).to(dev), JPEG_QUALITY)
            write_png(path.replace("ori_imgs", "torso_imgs")
                      .replace(".jpg", ".png"), torso)


def face_tracking(base_dir: str, ori_imgs_dir: str,
                  device: str | torch.device = "cuda") -> None:
    """Task 8: head pose from the landmarks, and the photometric 3DMM fit
    where a morphable model is found (``tracker.track_poses``)."""
    from .tracker import track_poses
    track_poses(base_dir, ori_imgs_dir, device=device)


def euler2rot(euler: np.ndarray) -> np.ndarray:
    """XYZ euler -> rotation matrices, R = Rx(theta) Ry(phi) Rz(psi)."""
    theta, phi, psi = euler[:, 0], euler[:, 1], euler[:, 2]
    one = np.ones_like(theta)
    zero = np.zeros_like(theta)
    rx = np.stack([one, zero, zero,
                   zero, np.cos(theta), np.sin(theta),
                   zero, -np.sin(theta), np.cos(theta)], -1).reshape(-1, 3, 3)
    ry = np.stack([np.cos(phi), zero, -np.sin(phi),
                   zero, one, zero,
                   np.sin(phi), zero, np.cos(phi)], -1).reshape(-1, 3, 3)
    rz = np.stack([np.cos(psi), -np.sin(psi), zero,
                   np.sin(psi), np.cos(psi), zero,
                   zero, zero, one], -1).reshape(-1, 3, 3)
    return rx @ ry @ rz


def save_transforms(base_dir: str, ori_imgs_dir: str,
                    last_seconds_val: float | None = None,
                    fps: int = 25) -> None:
    """Task 9: ``transforms_{train,val}.json`` from ``track_params``. By
    default the last 1/11 of the frames are val; ``last_seconds_val``
    takes the split.py rule (the last N seconds as val)."""
    print("[INFO] save transforms")
    with open(glob.glob(os.path.join(ori_imgs_dir, "*.jpg"))[0], "rb") as f:
        h, w = jpeg_size(f.read())

    params = load_track_params(base_dir)
    focal = params["focal"]
    euler = params["euler"]
    trans = params["trans"] / 10.0
    n = euler.shape[0]

    rot = euler2rot(euler)
    rot_inv = rot.transpose(0, 2, 1)
    trans_inv = -(rot_inv @ trans[:, :, None])[:, :, 0]

    if last_seconds_val is not None:
        split_at = n - int(fps * last_seconds_val) - 1   # split.py:53
    else:
        split_at = int(n * 10 / 11)
    splits = {"train": range(0, split_at), "val": range(split_at, n)}

    for name, ids in splits.items():
        out = {"focal_len": float(np.ravel(focal)[0]),
               "cx": w / 2.0, "cy": h / 2.0, "frames": []}
        for i in ids:
            pose = np.eye(4)
            pose[:3, :3] = rot_inv[i]
            pose[:3, 3] = trans_inv[i]
            out["frames"].append({"img_id": int(i), "aud_id": int(i),
                                  "transform_matrix": pose.tolist()})
        with open(os.path.join(base_dir, f"transforms_{name}.json"), "w") as f:
            json.dump(out, f, indent=2, separators=(",", ": "))


def load_track_params(base_dir: str) -> dict:
    """``track_params`` from ``.npz`` (this tracker) or ``.pt`` (the
    reference's)."""
    npz = os.path.join(base_dir, "track_params.npz")
    if os.path.exists(npz):
        return dict(np.load(npz))
    d = torch.load(os.path.join(base_dir, "track_params.pt"),
                   map_location="cpu", weights_only=False)
    return {k: np.asarray(v) for k, v in d.items()}


def _copy_synthetic_gt(gt_dir: str, base_dir: str, ori_imgs_dir: str,
                       parsing_dir: str, what: str) -> None:
    """Satisfy a task of a learned extractor from a synthetic-GT stub
    (``data.synthetic_hard.render_hard_video``), whose generator knows the
    exact parsing masks, landmarks and teeth masks. Its file count must be
    the extracted frame count."""
    n_frames = len(glob.glob(os.path.join(ori_imgs_dir, "*.jpg")))
    if what == "parsing":
        srcs = sorted(glob.glob(os.path.join(gt_dir, "parsing", "*.png")))
        dst = parsing_dir
    elif what == "landmarks":
        srcs = sorted(glob.glob(os.path.join(gt_dir, "ori_imgs", "*.lms")))
        dst = ori_imgs_dir
    elif what == "teeth":
        srcs = sorted(glob.glob(os.path.join(gt_dir, "teeth_mask", "*.npy")))
        dst = os.path.join(base_dir, "teeth_mask")
        os.makedirs(dst, exist_ok=True)
    else:
        raise ValueError(what)
    if len(srcs) != n_frames:
        raise RuntimeError(
            f"synthetic GT stub has {len(srcs)} {what} files but the video "
            f"extracted {n_frames} frames — regenerate the stub at the "
            f"video's frame count")
    print(f"[INFO] synthetic GT: copying {len(srcs)} {what} files")
    for s in srcs:
        shutil.copy(s, os.path.join(dst, os.path.basename(s)))


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str, help="path to video file")
    parser.add_argument("--task", type=int, default=-1, help="-1 = all")
    parser.add_argument("--asr", type=str, default="deepspeech")
    parser.add_argument("--synthetic_gt", type=str, default=None,
                        help="synthetic-GT stub dir (render_hard_video): "
                             "satisfies tasks 4/7/11 (parsing/landmarks/"
                             "teeth) and au.csv by copying the generator's "
                             "exact masks")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where JPEGs, the pose solve, the fit, the AVE "
                             "encoder and the extractors run (cuda or cpu)")
    return parser


def main(argv=None) -> dict:
    """Run the tasks; returns each task's wall time in seconds."""
    opt = build_parser().parse_args(argv)
    dev = resolve_device(opt.device)

    base_dir = os.path.dirname(opt.path)
    wav_path = os.path.join(base_dir, "aud.wav")
    ori_imgs_dir = os.path.join(base_dir, "ori_imgs")
    parsing_dir = os.path.join(base_dir, "parsing")
    os.makedirs(ori_imgs_dir, exist_ok=True)
    os.makedirs(parsing_dir, exist_ok=True)

    t, gt = opt.task, opt.synthetic_gt
    walls = {}

    def run(task, fn, *args):
        if t in (-1, task):
            t0 = time.perf_counter()
            fn(*args)
            walls[task] = time.perf_counter() - t0
            print(f"[process] task {task}: {walls[task]:.3f} s", flush=True)

    run(1, extract_audio, opt.path, wav_path)
    run(2, extract_audio_features, wav_path, opt.asr, dev)
    run(3, extract_images, opt.path, ori_imgs_dir, 25, dev)
    if gt:
        run(4, _copy_synthetic_gt, gt, base_dir, ori_imgs_dir, parsing_dir,
            "parsing")
    else:
        run(4, run_parsing, ori_imgs_dir, parsing_dir, dev)
    run(5, extract_background, base_dir, ori_imgs_dir, dev)
    run(6, extract_torso_and_gt, base_dir, ori_imgs_dir, dev)
    if gt:
        run(7, _copy_synthetic_gt, gt, base_dir, ori_imgs_dir, parsing_dir,
            "landmarks")
    else:
        run(7, extract_landmarks_fan, ori_imgs_dir, dev)
    run(8, face_tracking, base_dir, ori_imgs_dir, dev)

    def transforms():
        save_transforms(base_dir, ori_imgs_dir)
        if gt and os.path.exists(os.path.join(gt, "au.csv")):
            shutil.copy(os.path.join(gt, "au.csv"),
                        os.path.join(base_dir, "au.csv"))
    run(9, transforms)
    if t == 10:
        run(10, save_transforms, base_dir, ori_imgs_dir, 12)
    if gt:
        run(11, _copy_synthetic_gt, gt, base_dir, ori_imgs_dir, parsing_dir,
            "teeth")
    else:
        run(11, create_teeth_masks, base_dir, ori_imgs_dir, True, dev)
    if t == 12:
        run(12, run_sapiens, base_dir, 500, dev)
    return walls


if __name__ == "__main__":
    main()
