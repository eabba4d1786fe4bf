"""The port's offline metrics (``instag_torch/metrics.py``) and depth
normals (``instag_torch/utils/normals.py``) against the JAX package's.

``evaluate_frames`` runs on 5 seeded 64x64 frames against a noisy copy,
with both packages' LPIPS reading one ``.npz`` of the JAX package's
seed-0 random-feature parameters; the depth normals on a seeded depth map
seen by the synthetic camera; the AU error on two seeded OpenFace-style
CSVs (headers with OpenFace's leading spaces); the LMD on seeded landmarks.

Tolerances: PSNR, LPIPS, the AU errors and the LMD within rtol 1e-5; the
normals within 1e-5.
"""

import csv
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import instag_tpu.metrics as JMet
import instag_tpu.models.lpips as JL
from instag_tpu.data.synthetic import generate_scene
from instag_tpu.utils import normals as JN
from instag_torch import metrics as TMet
from instag_torch.bench_utils import synthetic_camera
from instag_torch.utils import normals as TN
from tests.torch_cpu import one_torch_thread  # noqa: F401


@pytest.fixture
def lpips_npz(tmp_path, monkeypatch):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        monkeypatch.setenv("INSTAG_LPIPS_WEIGHTS",
                           str(tmp_path / "absent.npz"))
        _, params, _ = JL.load_lpips_params()
    p = jax.device_get(params)["params"]
    path = str(tmp_path / "lpips_alex.npz")
    np.savez(path, **{k: np.asarray(v) for i in range(5) for k, v in (
        (f"conv_{i}_w", p["alex"][f"conv_{i}"]["kernel"]),
        (f"conv_{i}_b", p["alex"][f"conv_{i}"]["bias"]),
        (f"lin_{i}", p[f"lin_{i}"]))})
    monkeypatch.setenv("INSTAG_LPIPS_WEIGHTS", path)
    return path


def test_evaluate_frames_matches_jax(lpips_npz):
    rng = np.random.default_rng(0)
    gt = rng.integers(0, 256, (5, 64, 64, 3)).astype(np.uint8)
    pred = np.clip(gt.astype(int) + rng.integers(-40, 41, gt.shape), 0,
                   255).astype(np.uint8)
    lms = rng.normal(200, 30, (2, 5, 68, 2)).astype(np.float32)
    ref = JMet.evaluate_frames(pred, gt, *lms)
    ours = TMet.evaluate_frames(pred, gt, *lms, device="cpu")
    assert ours["lpips_real"] is ref["lpips_real"] is True
    assert set(ours) == set(ref) == {"psnr", "lpips", "lpips_real", "lmd"}
    for k in ("psnr", "lpips", "lmd"):
        assert ours[k] == pytest.approx(ref[k], rel=1e-5), k
    # an odd batch: the JAX side pads the last one
    assert TMet.video_lpips(pred, gt, batch=3, device="cpu") == \
        pytest.approx(JMet.video_lpips(pred, gt, batch=3), rel=1e-5)


def test_depth_to_normal_matches_jax():
    cam = synthetic_camera(48, device="cpu")
    depth = np.random.default_rng(1).uniform(2.0, 3.0, (1, 48, 48)).astype(
        np.float32)
    args = [cam.view_transform.numpy(), float(cam.tanfovx),
            float(cam.tanfovy)]
    ref = np.asarray(JN.depth_to_normal(jnp.asarray(args[0]), *args[1:],
                                        jnp.asarray(depth)))
    ours = TN.depth_to_normal(torch.from_numpy(args[0]), *args[1:],
                              torch.from_numpy(depth)).numpy()
    assert ours.shape == (48, 48, 3) and not ours[0].any()
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    np.testing.assert_allclose(
        TN.depths_to_points(torch.from_numpy(args[0]), *args[1:],
                            torch.from_numpy(depth)).numpy(),
        np.asarray(JN.depths_to_points(jnp.asarray(args[0]), *args[1:],
                                       jnp.asarray(depth))), atol=1e-5)


def test_au_error_and_landmarks_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    paths = []
    for name, n in (("a", 12), ("b", 10)):
        path = str(tmp_path / f"{name}.csv")
        cols = [f"AU{i:02d}_r" for i in JMet.AU_COLS]
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["frame"] + [" " + c for c in cols])
            for t in range(n):
                w.writerow([t] + [f"{v:.2f}" for v in rng.uniform(0, 5, 17)])
        paths.append(path)
    ref, ours = JMet.au_error(*paths), TMet.au_error(*paths)
    assert set(ours) == set(ref) == {"au_all", "au_lower", "au_upper"}
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=1e-5), k

    scene = str(tmp_path / "scene")
    generate_scene(scene, n_frames=4, size=32, n_val=1)
    ids = [0, 2, 3]
    np.testing.assert_array_equal(TMet.load_gt_landmarks(scene, ids),
                                  JMet.load_gt_landmarks(scene, ids))
    assert TMet.load_gt_landmarks(scene, [999]) is None
    assert TMet.track_video_landmarks(np.zeros((1, 8, 8, 3)),
                                      device="cpu") is None
