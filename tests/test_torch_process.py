"""The port's preprocessing tasks (``instag_torch.data_utils.process``)
against the JAX package's on the same inputs, on the CPU: the Euler
conversions to 1e-12, the transforms files byte for byte under both split
rules, the background plate and the gt frames byte for byte and the torso
frames pixel for pixel (the JPEG codecs of OpenCV and PIL write the same
bytes and decode the same pixels; the port's PNG writer is PIL's, whose
bytes differ from OpenCV's), the exact blur bit for bit against OpenCV's,
and the frames of an MJPEG AVI within ``AVI_LEVELS`` of OpenCV's FFmpeg
decode (PIL's libjpeg and FFmpeg's MJPEG decoder upsample and convert the
chroma differently)."""

import glob
import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest

from instag_tpu.data_utils import process as JP
from instag_tpu.data_utils.tracker import rot2euler as j_rot2euler
from instag_torch.data.image_io import read_png
from instag_torch.data_utils import process as TP
from instag_torch.data_utils.tracker import rot2euler
from instag_torch.io.avmux import read_avi_mjpeg, write_avi_mjpeg_pcm
from tests.torch_cpu import one_torch_thread  # noqa: F401

# max and mean |level| of the port's ori_imgs against OpenCV's, both q98
# re-encodes of one AVI (measured 21 and 1.32; FFmpeg's decode of the AVI's
# frames is up to 59 levels, 2.44 on average, from PIL's)
AVI_LEVELS = (24, 1.5)


def test_euler_conversions_match_jax():
    euler = np.random.default_rng(0).uniform(-0.5, 0.5, (16, 3))
    R = TP.euler2rot(euler)
    np.testing.assert_allclose(R, JP.euler2rot(euler), rtol=0, atol=1e-12)
    np.testing.assert_allclose(rot2euler(R), j_rot2euler(R), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(rot2euler(R), euler, rtol=0, atol=1e-12)


@pytest.mark.parametrize("last_seconds_val", [None, 12])
def test_save_transforms_is_byte_equal(tmp_path, last_seconds_val):
    rng = np.random.default_rng(1)
    n = 330
    params = dict(euler=rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
                  trans=rng.normal(0, 3, (n, 3)).astype(np.float32),
                  focal=np.array([1100.0], np.float32))
    dirs = []
    for name in ("jax", "port"):
        d = tmp_path / name
        (d / "ori_imgs").mkdir(parents=True)
        cv2.imwrite(str(d / "ori_imgs" / "0.jpg"),
                    np.zeros((80, 96, 3), np.uint8))
        np.savez(d / "track_params.npz", **params)
        dirs.append(str(d))
    JP.save_transforms(dirs[0], os.path.join(dirs[0], "ori_imgs"),
                       last_seconds_val)
    TP.save_transforms(dirs[1], os.path.join(dirs[1], "ori_imgs"),
                       last_seconds_val)
    for split in ("train", "val"):
        name = f"transforms_{split}.json"
        with open(os.path.join(dirs[0], name), "rb") as f, \
                open(os.path.join(dirs[1], name), "rb") as g:
            assert f.read() == g.read(), name
    with open(os.path.join(dirs[1], "transforms_val.json")) as f:
        n_val = len(json.load(f)["frames"])
    assert n_val == (n - int(n * 10 / 11) if last_seconds_val is None
                     else 25 * 12 + 1)


def _tasks_5_6_inputs(d):
    """tests/test_data_utils.py's 96x96 inputs: three frames of a moving
    head over a neck and a torso, with their parsings (OpenCV's BGR)."""
    ori, parsing = os.path.join(d, "ori_imgs"), os.path.join(d, "parsing")
    os.makedirs(ori)
    os.makedirs(parsing)
    h = w = 96
    for i in range(3):
        img = np.full((h, w, 3), 60, np.uint8)
        img[20:70, 30 + i:66 + i] = (180, 150, 140)
        cv2.imwrite(os.path.join(ori, f"{i}.jpg"), img)
        seg = np.full((h, w, 3), 255, np.uint8)   # bg white
        seg[20:55, 30 + i:66 + i] = (255, 0, 0)   # head (blue in BGR)
        seg[55:62, 40:60] = (0, 255, 0)           # neck
        seg[62:90, 25:75] = (0, 0, 255)           # torso
        cv2.imwrite(os.path.join(parsing, f"{i}.png"), seg)
    return ori


def test_background_and_torso_match_jax(tmp_path):
    ref, ours = str(tmp_path / "jax"), str(tmp_path / "port")
    j_ori = _tasks_5_6_inputs(ref)
    shutil.copytree(ref, ours)
    t_ori = os.path.join(ours, "ori_imgs")
    JP.extract_background(ref, j_ori)
    JP.extract_torso_and_gt(ref, j_ori)
    TP.extract_background(ours, t_ori, device="cpu")
    TP.extract_torso_and_gt(ours, t_ori, device="cpu")
    names = ["bc.jpg"] + [f"gt_imgs/{i}.jpg" for i in range(3)]
    for name in names:
        with open(os.path.join(ref, name), "rb") as f, \
                open(os.path.join(ours, name), "rb") as g:
            assert f.read() == g.read(), name
    painted = 0
    for i in range(3):
        want = cv2.imread(os.path.join(ref, "torso_imgs", f"{i}.png"),
                          cv2.IMREAD_UNCHANGED)[..., [2, 1, 0, 3]]
        got = read_png(os.path.join(ours, "torso_imgs", f"{i}.png"), 4)
        assert np.array_equal(got, want), i
        painted += int((got[:55, ..., 3] > 0).sum())
    assert painted > 0           # the neck was painted up into the head


@pytest.mark.parametrize("shape", [(64, 48, 3), (33, 17, 3), (96, 96, 3),
                                   (7, 5, 4)])
def test_exact_blur_equals_opencv(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    assert np.array_equal(TP.gaussian_blur5(img),
                          cv2.GaussianBlur(img, (5, 5), 0))


def _frames(n, h=64, w=80):
    """Smooth moving colour fields with an edge, as a camera gives."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        r = 128 + 90 * np.sin((xx + 3 * i) / 9.0)
        g = 128 + 90 * np.cos((yy - 2 * i) / 11.0)
        b = np.where(xx + yy > 60 + 4 * i, 200.0, 40.0)
        out.append(np.stack([r, g, b], -1).clip(0, 255).astype(np.uint8))
    return np.stack(out)


@pytest.mark.parametrize("src_fps", [25, 30])
def test_extract_images_from_mjpeg_avi(tmp_path, src_fps):
    video = str(tmp_path / "clip.avi")
    pcm = np.zeros(16000 * 12 // src_fps, np.int16)
    write_avi_mjpeg_pcm(video, _frames(12), src_fps, pcm, 16000,
                        jpeg_quality=95, device="cpu")
    assert read_avi_mjpeg(video).fps == src_fps
    ref, ours = str(tmp_path / "jax"), str(tmp_path / "port")
    JP.extract_images(video, ref)
    TP.extract_images(video, ours, device="cpu")
    n = len(glob.glob(os.path.join(ref, "*.jpg")))
    assert n == len(glob.glob(os.path.join(ours, "*.jpg")))
    assert n == len(TP.resample_indices(12, src_fps, 25))
    assert n == (12 if src_fps == 25 else 10)
    diffs = []
    for i in range(n):
        want = cv2.imread(os.path.join(ref, f"{i}.jpg"))[..., ::-1]
        got = cv2.imread(os.path.join(ours, f"{i}.jpg"))[..., ::-1]
        diffs.append(np.abs(want.astype(int) - got.astype(int)))
    diffs = np.stack(diffs)
    assert diffs.max() <= AVI_LEVELS[0], diffs.max()
    assert diffs.mean() <= AVI_LEVELS[1], diffs.mean()


def test_refusals_name_the_roadmap(tmp_path, monkeypatch):
    """Without their weights the learned extractors' tasks raise the JAX
    package's messages, which name the weights to provide."""
    for var in ("INSTAG_BISENET_WEIGHTS", "INSTAG_FAN_WEIGHTS",
                "INSTAG_SAPIENS_DEPTH", "INSTAG_SAPIENS_NORMAL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)          # no weights/ directory
    video = str(tmp_path / "v.avi")
    for argv, match in (([video, "--task", "4", "--device", "cpu"],
                         "INSTAG_BISENET_WEIGHTS"),
                        ([video, "--task", "7", "--device", "cpu"],
                         "INSTAG_FAN_WEIGHTS"),
                        ([video, "--task", "12", "--device", "cpu"],
                         "INSTAG_SAPIENS_DEPTH")):
        with pytest.raises(RuntimeError, match=match):
            TP.main(argv)
    # a container other than an MJPEG AVI, with OpenCV missing
    monkeypatch.setitem(sys.modules, "cv2", None)
    (tmp_path / "v.mp4").write_bytes(b"\x00" * 64)
    with pytest.raises(RuntimeError, match="MJPEG AVI"):
        TP.extract_images(str(tmp_path / "v.mp4"), str(tmp_path / "o"),
                          device="cpu")


def test_every_task_runs_without_a_stub(tmp_path, monkeypatch):
    """``process --task -1`` on the CPU runs tasks 1-11 with no
    ``--synthetic_gt``: the extractors from random-weight checkpoints
    named by their environment variables, the photometric fit from a
    synthetic model under ``3DMM/``; ``track_params.npz`` then holds
    non-zero id, exp and light."""
    import torch

    from instag_torch.data.synthetic_hard import render_hard_video
    from instag_torch.data_utils.easyportrait_fpn import EasyPortraitFPN
    from instag_torch.data_utils.face_model import save_model, synthetic_model
    from instag_torch.data_utils.face_parsing import BiSeNet
    from instag_torch.data_utils.landmarks import build_fan

    torch.manual_seed(0)
    for var, net in (("INSTAG_FAN_WEIGHTS", build_fan(1)),
                     ("INSTAG_BISENET_WEIGHTS", BiSeNet()),
                     ("INSTAG_EASYPORTRAIT_FPN", EasyPortraitFPN())):
        path = str(tmp_path / f"{var}.pth")
        torch.save(net.state_dict(), path)
        monkeypatch.setenv(var, path)
    monkeypatch.setenv("INSTAG_TEETH_MODEL", str(tmp_path / "absent.pt"))
    video, _ = render_hard_video(str(tmp_path / "cap"), n_frames=4, size=64,
                                 n_val=1, supersample=1, device="cpu")
    base = os.path.dirname(video)
    os.makedirs(os.path.join(base, "3DMM"))
    save_model(os.path.join(base, "3DMM", "3dmm_model.npz"),
               synthetic_model())
    walls = TP.main([video, "--task", "-1", "--device", "cpu"])
    assert sorted(walls) == list(range(1, 10)) + [11]
    d = np.load(os.path.join(base, "track_params.npz"))
    assert d["exp"].shape == (5, 79)
    for k in ("id", "exp", "light"):
        assert np.abs(d[k]).max() > 0 and np.isfinite(d[k]).all(), k
    for i in range(5):
        for rel in (f"parsing/{i}.png", f"ori_imgs/{i}.lms",
                    f"teeth_mask/{i}.npy", f"gt_imgs/{i}.jpg",
                    f"torso_imgs/{i}.png"):
            assert os.path.exists(os.path.join(base, rel)), rel
    for f in ("transforms_train.json", "transforms_val.json", "bc.jpg"):
        assert os.path.exists(os.path.join(base, f)), f
