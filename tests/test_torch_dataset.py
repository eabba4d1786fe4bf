"""The dataset reader, the scene writer and the PNG codec against the JAX
package and PIL, on one generated 64x64 scene (6 train and 4 val frames):
every FrameRecord field of ``load_frames`` equal to JAX's (images too: PIL
and the JAX package's loader decode these JPEGs alike), the frame batch
and its float64 meta, and the writer's files byte for byte."""

import dataclasses
import filecmp
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from instag_tpu.data import dataset as JD
from instag_tpu.data.synthetic import generate_scene as j_generate_scene
from instag_tpu.train.common import build_frame_batch as j_build_batch
from instag_torch.data import dataset as TD
from instag_torch.data import image_io
from instag_torch.data.synthetic import generate_scene
from instag_torch.io.from_jax import frame_batch, frame_meta
from instag_torch.train.common import (FrameMeta, build_frame_batch,
                                       load_training_frames)
from instag_torch.config import ModelConfig
from tests.torch_cpu import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    path = str(root / "jax")
    j_generate_scene(path, n_frames=6, size=64, n_val=4)
    # a driving clip of 13 frames of features: the frames loop twice
    aud = np.random.default_rng(5).normal(size=(13, 16, 29))
    np.save(str(root / "drive.npy"), aud.astype(np.float32))
    return path, str(root / "drive.npy")


def _assert_records_equal(ref, out):
    assert len(ref) == len(out) > 0
    for r, t in zip(ref, out):
        for f in dataclasses.fields(r):
            a, b = getattr(r, f.name), getattr(t, f.name)
            if f.name in ("image", "bg"):
                assert b.dtype == torch.uint8 and b.device.type == "cpu"
                b = b.numpy()
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            elif a is None:
                assert b is None, f.name
            else:
                assert type(a) is type(b) and a == b, (f.name, a, b)


@pytest.mark.parametrize("split,kw", [
    ("train", {}), ("val", {}), ("train", {"n_views": 3}),
    ("val", {"audio_file": "drive"})], ids=["train", "val", "n_views3",
                                            "audio_file"])
def test_load_frames_matches_jax(scene, split, kw):
    path, drive = scene
    if "audio_file" in kw:
        kw = {"audio_file": drive}
    ref = JD.load_frames(path, split, **kw)
    out = TD.load_frames(path, split, device="cpu", **kw)
    _assert_records_equal(ref, out)
    if "audio_file" in kw:
        assert len(out) == 13                  # 4 val frames looped, cut at 13
    assert TD.load_frames(path, split, device="cpu", **kw) is out   # memo
    (c0, r0), (c1, r1) = JD.scene_extent(ref), TD.scene_extent(out)
    assert r0 == r1 and c0.dtype == c1.dtype and np.array_equal(c0, c1)


def test_frame_batch_and_meta_match_jax(scene):
    path, _ = scene
    ref = JD.load_frames(path, "train")
    out = TD.load_frames(path, "train", device="cpu")
    j_batch = j_build_batch(ref)
    want = frame_batch({f.name: (None if getattr(j_batch, f.name) is None
                                 else np.asarray(getattr(j_batch, f.name)))
                        for f in dataclasses.fields(j_batch)}, device="cpu")
    got = build_frame_batch(out, device="cpu")
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if a is None:
            assert b is None, f.name
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
    want_meta, got_meta = frame_meta(ref), FrameMeta.from_records(out)
    for f in dataclasses.fields(want_meta):
        a, b = getattr(want_meta, f.name), getattr(got_meta, f.name)
        assert np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(
            b).dtype, f.name
    cfg = ModelConfig(source_path=path, all_for_train=True)
    both = load_training_frames(cfg, device="cpu")
    assert [r.img_id for r in both] == list(range(10))


def test_generate_scene_files_equal_jax(scene, tmp_path):
    path, _ = scene
    generate_scene(str(tmp_path), n_frames=6, size=64, n_val=4, device="cpu")
    cmp = filecmp.dircmp(path, str(tmp_path))
    names = []

    def walk(c, rel=""):
        assert not c.left_only and not c.right_only, (rel, c.left_only,
                                                      c.right_only)
        for name in c.common_files:
            names.append(os.path.join(rel, name))
        for sub, cc in c.subdirs.items():
            walk(cc, os.path.join(rel, sub))
    walk(cmp)
    # two transforms, au.csv, aud_ds.npy, bc.jpg, points3d.ply; 5 per frame
    assert len(names) == 6 + 5 * 10
    for name in names:
        assert filecmp.cmp(os.path.join(path, name),
                           os.path.join(str(tmp_path), name),
                           shallow=False), name


def _pil_png(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", **kw)
    return buf.getvalue()


def _png_cases():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:50, 0:70]
    smooth = (np.sin(xx / 7.0 + yy / 5.0) * 100 + 120).astype(np.uint8)
    return {"rgb_noise": rng.integers(0, 256, (90, 120, 3), dtype=np.uint8),
            "rgba_noise": rng.integers(0, 256, (33, 70, 4), dtype=np.uint8),
            "gray": rng.integers(0, 256, (40, 50), dtype=np.uint8),
            "rgb_smooth": np.repeat(smooth[..., None], 3, -1),
            "rgba_ramp": np.repeat(((xx + 3 * yy) % 256).astype(
                np.uint8)[..., None], 4, -1)}


@pytest.mark.parametrize("name", sorted(_png_cases()))
def test_png_codec_matches_pil(name):
    img = _png_cases()[name]
    ref = _pil_png(img)
    assert image_io.encode_png(img) == ref
    np.testing.assert_array_equal(image_io.decode_png(ref), img)
    # PIL's optimize mode also tries the average filter (type 3)
    opt = _pil_png(img, optimize=True)
    np.testing.assert_array_equal(image_io.decode_png(opt),
                                  np.asarray(Image.open(io.BytesIO(opt))))


def test_png_reader_converts_as_pil(tmp_path):
    rgb = _png_cases()["rgb_smooth"]
    p = str(tmp_path / "a.png")
    image_io.write_png(p, rgb)
    np.testing.assert_array_equal(image_io.read_png(p, channels=4),
                                  np.asarray(Image.open(p).convert("RGBA")))
    gray = _png_cases()["gray"]
    image_io.write_png(p, gray)
    np.testing.assert_array_equal(image_io.read_png(p, channels=3),
                                  np.asarray(Image.open(p).convert("RGB")))


def test_jpeg_on_the_cpu_is_pil(scene):
    path, _ = scene
    frame = os.path.join(path, "gt_imgs", "0.jpg")
    with open(frame, "rb") as f:
        blob = f.read()
    assert image_io.jpeg_size(blob) == (64, 64)
    out = image_io.read_jpegs([frame], "cpu")
    np.testing.assert_array_equal(
        out[0].numpy(), np.asarray(Image.open(frame).convert("RGB")))
    img = out[0].numpy()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    assert image_io.encode_jpeg(torch.from_numpy(img), 90) == buf.getvalue()
