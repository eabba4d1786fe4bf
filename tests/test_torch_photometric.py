"""The port's photometric fit (``instag_torch.data_utils.photometric`` and
the tracker's fit branch) against the JAX package's on the CPU, on the
8-frame 64x64 synthetic sequence of tests/test_tracker_photometric.py:

* one fit of both packages at ``iters=(20, 20, 4, 4)`` from the same rough
  start (compiled once, in a module fixture): each stage's last loss (A, B
  and C) within rtol 1e-4, every output (stage D's included) within 1e-3
  of its scale, the landmark error within 1e-4 relative;
* Euler rotations, point transforms and projections within 1e-6;
* the staircase schedule of ``_run_adam`` as optax counts it;
* the counterpart of ``test_track_poses_photometric_roundtrip``: the
  port's tracker with the model writes non-zero exp and light, and its
  saved landmark error is at most the PnP-only run's + 1e-3 px and below
  2 px."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instag_tpu.data_utils import face_model as JF
from instag_tpu.data_utils import photometric as JPh
from instag_torch.data.image_io import write_jpeg
from instag_torch.data_utils import face_model as TF
from instag_torch.data_utils import photometric as TPh
from instag_torch.data_utils.tracker import track_poses
from tests.test_tracker_photometric import (CX, CY, FOCAL, _gt_sequence,
                                            _render_frames)
from tests.torch_cpu import one_torch_thread  # noqa: F401

ITERS = (20, 20, 4, 4)
STAGE_RTOL = 1e-4
FIT_RTOL = 1e-3


@pytest.fixture(scope="module")
def sequence():
    model = JF.synthetic_model()
    gt = _gt_sequence(model, n_frames=8)
    frames, lms = _render_frames(model, gt)
    return model, frames, lms


@pytest.fixture(scope="module")
def fits(sequence):
    model, frames, lms = sequence
    T = lms.shape[0]
    kw = dict(euler_init=np.zeros((T, 3), np.float32),
              trans_init=np.tile(np.array([0, 0, 0.9], np.float32), (T, 1)),
              iters=ITERS)
    want = JPh.fit_photometric(model, lms, frames[..., :3], FOCAL, CX, CY,
                               **kw)
    got = TPh.fit_photometric(model, lms, frames[..., :3], FOCAL, CX, CY,
                              device="cpu", **kw)
    return want, got


@pytest.mark.parametrize("stage", ["a", "b", "c"])
def test_stage_losses_match_jax(fits, stage):
    want, got = fits
    assert got["stage_losses"][stage] == pytest.approx(
        want["stage_losses"][stage], rel=STAGE_RTOL)


@pytest.mark.parametrize("key", ["id", "exp", "tex", "euler", "trans",
                                 "light"])
def test_fit_matches_jax(fits, key):
    want, got = fits
    w = np.asarray(want[key])
    assert got[key].shape == w.shape and got[key].dtype == np.float32
    np.testing.assert_allclose(got[key], w, rtol=0,
                               atol=FIT_RTOL * np.abs(w).max())
    if key == "id":
        assert got["lan_err_px"] == pytest.approx(want["lan_err_px"],
                                                  rel=STAGE_RTOL)


def test_pose_math_matches_jax():
    rng = np.random.default_rng(0)
    euler = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    pts = rng.normal(size=(5, 7, 3)).astype(np.float32)
    trans = (rng.normal(size=(5, 3)) + [0, 0, 3]).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(TPh.euler2rot(t(euler)).numpy(),
                               np.asarray(JPh.euler2rot_jax(euler)),
                               atol=1e-6)
    cam = TPh.transform_points(t(pts), t(euler), t(trans))
    np.testing.assert_allclose(cam.numpy(), np.asarray(
        JPh.transform_points(jnp.asarray(pts), euler, trans)), atol=1e-6)
    np.testing.assert_allclose(
        TPh.project(cam, 150.0, 32.0, 30.0).numpy(),
        np.asarray(JPh.project(jnp.asarray(cam.numpy()), 150.0, 32.0,
                               30.0)), rtol=1e-6)


@pytest.mark.parametrize("decay_every", [0, 3])
def test_adam_schedule_is_optax_staircase(decay_every):
    """On loss = p (gradient 1) Adam's step is the rate (to eps): the
    steps are 0.1 x 0.2^(i // 3), from step 0, or constant without
    decay."""
    p, losses = TPh._run_adam(lambda q: q["p"].sum(),
                              {"p": torch.zeros(1)}, 0.1, 7, decay_every)
    steps = -np.diff(np.concatenate([[0.0], losses.numpy(),
                                     [p["p"].item()]]))[1:]
    want = [0.1 * (0.2 ** (i // decay_every) if decay_every else 1.0)
            for i in range(7)]
    np.testing.assert_allclose(steps, want, rtol=0, atol=1e-7)


def test_track_poses_photometric_roundtrip(sequence, tmp_path):
    model, frames, lms = sequence
    base = str(tmp_path)
    ori = os.path.join(base, "ori_imgs")
    os.makedirs(ori)
    for i in range(lms.shape[0]):
        img = (np.clip(frames[i, ..., :3], 0, 1) * 255).astype(np.uint8)
        write_jpeg(os.path.join(ori, f"{i}.jpg"), img)
        np.savetxt(os.path.join(ori, f"{i}.lms"), lms[i], "%f")

    def saved_lan_err():
        d = np.load(os.path.join(base, "track_params.npz"))
        F = np.diag([1.0, -1.0, -1.0])
        Rs = F @ TPh.euler2rot(torch.from_numpy(d["euler"])).numpy()
        ts = (d["trans"] / 10.0) @ F.T
        l3 = TF.landmarks3d(
            model, torch.from_numpy(d["id"][:model.n_id])[None].repeat(
                len(lms), 1), torch.from_numpy(d["exp"][:, :model.n_exp]))
        cam = np.einsum("tij,tnj->tni", Rs, l3.numpy()) + ts[:, None]
        proj = TPh.project(torch.from_numpy(cam), float(d["focal"][0]), CX,
                           CY).numpy()
        return float(np.mean(np.linalg.norm(proj - lms, axis=-1))), d

    track_poses(base, ori, focal_candidates=[FOCAL], smooth=1, device="cpu")
    err_pnp, d_pnp = saved_lan_err()
    assert np.abs(d_pnp["exp"]).max() == 0.0
    track_poses(base, ori, focal_candidates=[FOCAL], smooth=1, model=model,
                photometric_iters=(200, 250, 40, 30), downscale=1,
                device="cpu")
    err_p, d = saved_lan_err()
    assert d["exp"].shape == (8, 79) and d["light"].shape == (8, 27)
    assert d["id"].shape == (100,)
    assert np.abs(d["exp"]).max() > 1e-3
    assert np.abs(d["light"]).max() > 1e-3
    assert err_p <= err_pnp + 1e-3, (err_p, err_pnp)
    assert err_p < 2.0, f"photometric landmark err {err_p:.2f}px"
