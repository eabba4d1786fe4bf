"""The raw capture -> preprocessing -> training seam in the port, against
the JAX package's, on the CPU (the counterpart of tests/test_e2e_seam.py).

* ``render_hard_video``: the port's stub is byte for byte the JAX
  package's (96x96, 10 + 2 frames) and its ``aud.wav`` equal.
* Both packages' ``process --task -1 --synthetic_gt`` on the port's MJPEG
  AVI, each in its own directory: the copied files byte for byte,
  ``aud_ds.npy`` bit for bit, the focal equal and the poses within
  ``POSE_ATOL`` (OpenCV's refinement stops short of the minimum that the
  port's PnP reaches, which a test shows), and the images within ``LEVELS`` (the JAX package
  reads the AVI through OpenCV's FFmpeg, the port through PIL; the bound
  is what that decode difference leaves after the q98 and q95 re-encodes).
* The port's reader and a short ``train_face`` run on the port's output:
  finite losses that fall.
* Streaming: a host read of the split (in chunks of 3 frames) equals the
  device read bit for bit, its frames on the CPU, and is not memoized.
"""

import glob
import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from instag_tpu.data.synthetic_hard import render_hard_video as j_render
from instag_tpu.data_utils.process import main as j_process
from instag_torch.config import ModelConfig, OptimizationConfig
from instag_torch.data import dataset as TD
from instag_torch.data.image_io import read_png
from instag_torch.data.synthetic_hard import render_hard_video
from instag_torch.data_utils.process import main as t_process
from instag_torch.data_utils.tracker import (_RIGID, canonical_landmarks_3d,
                                             solve_pnp)
from instag_torch.train.common import (FrameMeta, HostFrameStore,
                                       build_frame_batch, frame_source,
                                       load_training_frames,
                                       streams_training_frames)
from instag_torch.train.face import train_face
from tests.torch_cpu import one_torch_thread  # noqa: F401

ARGS = dict(n_frames=10, size=96, seed=4, n_val=2, supersample=1)
COPIED = ["au.csv"] + [f"{d}/{i}.{ext}" for i in range(12)
                       for d, ext in (("parsing", "png"), ("ori_imgs", "lms"),
                                      ("teeth_mask", "npy"))]
# the poses against the JAX package's (OpenCV's refinement stops short of
# the minimum in a flat valley here; measured 4.9e-5 in the rotations and
# Euler angles; 1.8e-6 and 4.9e-5 of the largest in track_params'
# translations and in the cameras' positions)
POSE_ATOL = 1e-4
TRANS_RTOL = 1e-5
# max and mean |level| against the JAX package's files, per kind (measured
# 15 / 1.29, 16 / 1.46, 8 / 1.25 and 7 / 0.11)
LEVELS = {"ori_imgs": (20, 2.0), "gt_imgs": (20, 2.0), "bc.jpg": (12, 2.0),
          "torso_imgs": (12, 0.5)}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


@pytest.fixture(scope="module")
def seam(tmp_path_factory):
    root = tmp_path_factory.mktemp("seam")
    j_video, j_stub = j_render(str(root / "jax_capture"), **ARGS)
    video, stub = render_hard_video(str(root / "capture"), **ARGS,
                                    device="cpu")
    dirs = {}
    for name, run in (("jax", lambda v: j_process(
            [v, "--task", "-1", "--synthetic_gt", stub])),
                      ("port", lambda v: t_process(
            [v, "--task", "-1", "--synthetic_gt", stub, "--device", "cpu"]))):
        d = root / name
        d.mkdir()
        for f in ("video.avi", "aud.wav"):
            shutil.copy(os.path.join(os.path.dirname(video), f), d / f)
        run(str(d / "video.avi"))
        dirs[name] = str(d)
    return dict(root=str(root), j_video=j_video, j_stub=j_stub, video=video,
                stub=stub, **dirs)


def test_capture_matches_jax(seam):
    j_stub, stub = seam["j_stub"], seam["stub"]
    names = _files(j_stub)
    assert names == _files(stub) and len(names) == 5 * 12 + 6
    for name in names:
        assert _same_bytes(os.path.join(j_stub, name),
                           os.path.join(stub, name)), name
    assert _same_bytes(os.path.join(os.path.dirname(seam["j_video"]),
                                    "aud.wav"),
                       os.path.join(os.path.dirname(seam["video"]),
                                    "aud.wav"))
    assert os.path.basename(seam["video"]) == "video.avi"


def test_process_writes_the_jax_files(seam):
    ref, ours = seam["jax"], seam["port"]
    assert _files(ref) == _files(ours)
    for name in COPIED:
        assert _same_bytes(os.path.join(ref, name),
                           os.path.join(ours, name)), name
    want = np.load(os.path.join(ref, "aud_ds.npy"))
    got = np.load(os.path.join(ours, "aud_ds.npy"))
    assert got.shape == (12, 16, 29) and np.array_equal(got, want)
    jp = dict(np.load(os.path.join(ref, "track_params.npz")))
    tp = dict(np.load(os.path.join(ours, "track_params.npz")))
    assert sorted(tp) == sorted(jp) and tp["focal"][0] == jp["focal"][0]
    for k in ("id", "exp", "light"):
        assert np.array_equal(tp[k], jp[k]), k
    np.testing.assert_allclose(tp["euler"], jp["euler"], rtol=0,
                               atol=POSE_ATOL)
    np.testing.assert_allclose(tp["trans"], jp["trans"], rtol=0,
                               atol=TRANS_RTOL * np.abs(jp["trans"]).max())
    for split in ("train", "val"):
        with open(os.path.join(ref, f"transforms_{split}.json")) as f:
            a = json.load(f)
        with open(os.path.join(ours, f"transforms_{split}.json")) as f:
            b = json.load(f)
        assert [k for k in a if k != "frames"] == [k for k in b
                                                   if k != "frames"]
        assert all(a[k] == b[k] for k in a if k != "frames")
        assert [fr["img_id"] for fr in a["frames"]] == [
            fr["img_id"] for fr in b["frames"]]
        want = np.array([fr["transform_matrix"] for fr in a["frames"]])
        got = np.array([fr["transform_matrix"] for fr in b["frames"]])
        np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], rtol=0,
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(
            got[:, :3, 3], want[:, :3, 3], rtol=0,
            atol=POSE_ATOL * np.abs(want[:, :3, 3]).max())
        assert np.array_equal(got[:, 3], want[:, 3])


def test_port_pnp_is_at_least_as_low_as_opencvs(seam):
    """Why the poses differ from the JAX package's by more than 1e-5: on
    the hard identity's landmarks (not the template's shape: 1.75 px of
    residual) the minimum lies in a flat valley, where OpenCV's refinement
    stops (at any iteration count) a little short of the port's point;
    at the tracker's focal the port's squared error is at or below
    OpenCV's on every frame."""
    d = seam["port"]
    focal = float(np.load(os.path.join(d, "track_params.npz"))["focal"][0])
    lms = np.stack([np.loadtxt(os.path.join(d, "ori_imgs", f"{i}.lms"))
                    for i in range(12)])
    obj = canonical_landmarks_3d()[_RIGID].astype(np.float64)
    pts = np.ascontiguousarray(lms[:, _RIGID])
    c = ARGS["size"] / 2.0
    R, t, _ = solve_pnp(obj, pts, np.full(12, focal), c, c, device="cpu")
    K = np.array([[focal, 0, c], [0, focal, c], [0, 0, 1]])
    for i in range(12):
        _, rvec, tvec = cv2.solvePnP(obj, pts[i], K, None,
                                     flags=cv2.SOLVEPNP_EPNP)
        rvec, tvec = cv2.solvePnPRefineLM(obj, pts[i], K, None, rvec, tvec)
        cv_proj = cv2.projectPoints(obj, rvec, tvec, K, None)[0][:, 0]
        ours = cv2.projectPoints(obj, cv2.Rodrigues(R[i])[0], t[i], K,
                                 None)[0][:, 0]
        assert ((ours - pts[i]) ** 2).sum() <= ((cv_proj - pts[i]) ** 2
                                                ).sum() + 1e-9, i


@pytest.mark.parametrize("kind", sorted(LEVELS))
def test_images_within_the_decode_bound(seam, kind):
    ref, ours = seam["jax"], seam["port"]
    if kind == "bc.jpg":
        names = ["bc.jpg"]
    else:
        ext = "png" if kind == "torso_imgs" else "jpg"
        names = sorted(os.path.relpath(p, ref) for p in glob.glob(
            os.path.join(ref, kind, f"*.{ext}")))
        assert len(names) == 12
    diffs = []
    for name in names:
        if name.endswith(".png"):
            want = cv2.imread(os.path.join(ref, name), cv2.IMREAD_UNCHANGED
                              )[..., [2, 1, 0, 3]]
            got = read_png(os.path.join(ours, name), 4)
        else:
            want = cv2.imread(os.path.join(ref, name))
            got = cv2.imread(os.path.join(ours, name))
        diffs.append(np.abs(want.astype(int) - got.astype(int)))
    diffs = np.stack(diffs)
    assert diffs.max() <= LEVELS[kind][0], (kind, diffs.max())
    assert diffs.mean() <= LEVELS[kind][1], (kind, diffs.mean())


def test_port_trains_on_its_output(seam):
    d = seam["port"]
    records = TD.load_frames(d, "train", device="cpu")
    assert len(records) == int(12 * 10 / 11)
    assert records[0].face_mask.sum() > 200
    assert np.isfinite(records[0].full_proj_transform).all()
    mc = ModelConfig(source_path=d, init_num=200, capacity=1024,
                     max_per_tile=64)
    oc = OptimizationConfig(iterations=60, densify_from_iter=20,
                            densification_interval=25,
                            opacity_reset_interval=100000,
                            position_lr_max_steps=60)
    res = train_face(mc, oc, build_frame_batch(records, device="cpu"),
                     FrameMeta.from_records(records), warm_step=20,
                     log_every=30, lpips_enabled=False, device="cpu")
    losses = np.asarray(res["losses"])
    assert len(losses) == 60 and np.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()


def test_streamed_read_stays_on_the_host(seam, monkeypatch):
    d = seam["port"]
    monkeypatch.setattr(TD, "DECODE_CHUNK", 3)
    mc = ModelConfig(source_path=d, all_for_train=True)
    assert streams_training_frames(mc, stream_threshold=11)
    assert not streams_training_frames(mc, stream_threshold=12)
    assert not streams_training_frames(ModelConfig(source_path=d))
    memo = dict(TD._FRAMES_CACHE)
    host = load_training_frames(mc, "cpu", stream=True)
    assert TD._FRAMES_CACHE == memo           # the host read is not memoized
    dev = load_training_frames(mc, "cpu")
    assert [r.img_id for r in host] == [r.img_id for r in dev] == list(
        range(12))
    for a, b in zip(host, dev):
        for field in ("image", "bg"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.device.type == "cpu" and x.dtype == torch.uint8
            assert torch.equal(x, y), (a.img_id, field)
    store = frame_source(host, with_priors=True, stream=True, device="cpu")
    assert isinstance(store, HostFrameStore)
    batch = build_frame_batch(dev, with_priors=True, device="cpu")
    sub = store.gather([11, 0, 5])
    assert torch.equal(sub.image, batch.image[[11, 0, 5]])
    assert torch.equal(sub.bg, batch.bg[[11, 0, 5]])
