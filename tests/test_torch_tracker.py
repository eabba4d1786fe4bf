"""The port's landmark tracker (``instag_torch.data_utils.tracker``)
against OpenCV's PnP and the JAX package's tracker, on the CPU, on the
known-pose scene of tests/test_data_utils.py: the port's batched
Levenberg-Marquardt PnP reaches OpenCV's EPnP + ``solvePnPRefineLM``
minimum frame by frame at every focal tried (rotation to 1e-6 rad,
translation to 1e-6 relative, mean reprojection error to 1e-4 px), the
tracker picks the same focal and writes ``track_params.npz`` within 1e-5
of the JAX tracker's, and a 3D morphable model found under ``3DMM/``
starts the photometric fit."""

import os
import shutil

import cv2
import numpy as np
import pytest

from instag_tpu.data_utils.tracker import track_poses as j_track_poses
from instag_torch.data_utils.face_model import save_model, synthetic_model
from instag_torch.data_utils.tracker import (_RIGID, canonical_landmarks_3d,
                                             solve_pnp, track_poses)
from tests.torch_cpu import one_torch_thread  # noqa: F401

SIZE = 256
FOCAL = 800.0
N = 12


@pytest.fixture(scope="module")
def tracked(tmp_path_factory):
    """tests/test_data_utils.py's scene: the template projected through
    known orbiting cameras, written as .lms files (6 decimals) beside black
    frames; then both trackers, each in its own copy."""
    d = str(tmp_path_factory.mktemp("track"))
    ref = os.path.join(d, "jax")
    ori = os.path.join(ref, "ori_imgs")
    os.makedirs(ori)
    K = np.array([[FOCAL, 0, SIZE / 2], [0, FOCAL, SIZE / 2], [0, 0, 1]])
    obj = canonical_landmarks_3d()
    rng = np.random.default_rng(1)
    for i in range(N):
        yaw = 0.15 * np.sin(i / 3.0)
        pitch = 0.08 * np.cos(i / 4.0)
        Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                       [-np.sin(yaw), 0, np.cos(yaw)]])
        Rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)],
                       [0, np.sin(pitch), np.cos(pitch)]])
        R = np.diag([1.0, -1.0, -1.0]) @ (Rx @ Ry)
        t = np.array([0.01 * rng.normal(), 0.01 * rng.normal(), 3.0])
        pix = (obj @ R.T + t) @ K.T
        np.savetxt(os.path.join(ori, f"{i}.lms"), pix[:, :2] / pix[:, 2:],
                   "%f")
        cv2.imwrite(os.path.join(ori, f"{i}.jpg"),
                    np.zeros((SIZE, SIZE, 3), np.uint8))
    ours = os.path.join(d, "port")
    shutil.copytree(ref, ours)
    j_track_poses(ref, ori, smooth=1)
    track_poses(ours, os.path.join(ours, "ori_imgs"), smooth=1,
                device="cpu")
    lms = np.stack([np.loadtxt(os.path.join(ori, f"{i}.lms"))
                    for i in range(N)])
    return ref, ours, lms


def _angle(R):
    """The rotation angle of R [3, 3] near the identity, from its skew
    part (acos of the trace loses half the digits there)."""
    return 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                                 R[1, 0] - R[0, 1]])


@pytest.mark.parametrize("focal", [600.0, 800.0, 1400.0])
def test_pnp_reaches_opencvs_minimum(tracked, focal):
    _, _, lms = tracked
    obj = canonical_landmarks_3d()[_RIGID].astype(np.float64)
    pts = np.ascontiguousarray(lms[:, _RIGID])
    R, t, err = solve_pnp(obj, pts, np.full(N, focal), SIZE / 2, SIZE / 2,
                          device="cpu")
    K = np.array([[focal, 0, SIZE / 2], [0, focal, SIZE / 2], [0, 0, 1]])
    for i in range(N):
        ok, rvec, tvec = cv2.solvePnP(obj, pts[i], K, None,
                                      flags=cv2.SOLVEPNP_EPNP)
        assert ok
        rvec, tvec = cv2.solvePnPRefineLM(obj, pts[i], K, None, rvec, tvec)
        Rc, _ = cv2.Rodrigues(rvec)
        proj, _ = cv2.projectPoints(obj, rvec, tvec, K, None)
        e = np.linalg.norm(proj[:, 0] - pts[i], axis=-1).mean()
        assert _angle(R[i] @ Rc.T) <= 1e-6, i
        assert np.linalg.norm(t[i] - tvec[:, 0]) <= 1e-6 * np.linalg.norm(
            tvec), i
        assert abs(err[i] - e) <= 1e-4, i


def test_same_focal_and_params_as_jax(tracked):
    ref, ours, _ = tracked
    want = dict(np.load(os.path.join(ref, "track_params.npz")))
    got = dict(np.load(os.path.join(ours, "track_params.npz")))
    assert sorted(got) == sorted(want)
    assert got["focal"][0] == want["focal"][0] == FOCAL
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_a_morphable_model_is_refused(tracked, tmp_path):
    """A model at ``<base>/3DMM/3dmm_model.npz`` is found and fitted: id,
    exp and light come out non-zero (a few steps of each stage)."""
    _, ours, _ = tracked
    base = str(tmp_path / "scene")
    shutil.copytree(ours, base)
    os.makedirs(os.path.join(base, "3DMM"))
    save_model(os.path.join(base, "3DMM", "3dmm_model.npz"),
               synthetic_model())
    fit = track_poses(base, os.path.join(base, "ori_imgs"),
                      photometric_iters=(4, 4, 2, 2), device="cpu")
    d = np.load(os.path.join(base, "track_params.npz"))
    assert fit is not None and d["exp"].shape == (N, 79)
    for k in ("id", "exp", "light"):
        assert np.abs(d[k]).max() > 0, k
