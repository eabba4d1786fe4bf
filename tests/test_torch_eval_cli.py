"""The port's evaluation CLIs (``cli.metrics``, ``cli.auerror``) against
the JAX package's on the same files: two seeded ``.npz`` videos with
``.lms`` landmark directories, both packages' LPIPS reading one ``.npz``
of the JAX package's random-feature parameters, and the ``au.csv`` files
of two generated scenes.

Tolerances: the LMD exact (numpy on both sides); the PSNR within 1e-6
relative (a float32 mean over each frame, which XLA and PyTorch sum in
different orders: 2.5e-7 apart here); LPIPS within 1e-5; the AU errors'
printed JSON equal.
"""

import json
import os
import sys

import numpy as np
import pytest

from instag_tpu.cli import auerror as j_auerror
from instag_tpu.cli import metrics as j_metrics
from instag_tpu.data.synthetic import generate_scene
from instag_torch.cli import auerror as t_auerror
from instag_torch.cli import metrics as t_metrics
from tests.test_torch_metrics import lpips_npz  # noqa: F401
from tests.torch_cpu import one_torch_thread  # noqa: F401


@pytest.fixture
def videos(tmp_path):
    """pred / gt ``.npz`` videos (6 and 5 frames: the CLI takes the common
    length) and their landmark directories (5 and 6 files)."""
    rng = np.random.default_rng(7)
    gt = rng.integers(0, 256, (5, 64, 64, 3), dtype=np.uint8)
    noise = rng.integers(-12, 13, (6, 64, 64, 3))
    pred = np.clip(np.concatenate([gt, gt[:1]]) + noise, 0, 255).astype(
        np.uint8)
    paths = {}
    for name, video in (("pred", pred), ("gt", gt)):
        paths[name] = str(tmp_path / f"{name}.npz")
        np.savez_compressed(paths[name], video=video, fps=25)
        lms_dir = tmp_path / f"{name}_lms"
        lms_dir.mkdir()
        for i in range(11 - len(video)):
            lms = rng.uniform(0, 64, (68, 2))
            np.savetxt(lms_dir / f"{i}.lms", lms, "%.2f")
        paths[f"lms_{name}"] = str(lms_dir)
    return paths


def _run(main, argv, capsys) -> dict:
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_metrics_cli_matches_jax(videos, lpips_npz, capsys):  # noqa: F811
    argv = ["--pred", videos["pred"], "--gt", videos["gt"],
            "--lms_pred", videos["lms_pred"], "--lms_gt", videos["lms_gt"]]
    ref = _run(j_metrics.main, argv, capsys)
    ours = _run(t_metrics.main, argv + ["--device", "cpu"], capsys)
    assert set(ours) == set(ref) == {"psnr", "lpips", "lpips_real", "lmd"}
    assert ours["lpips_real"] is ref["lpips_real"] is True
    assert ours["psnr"] == pytest.approx(ref["psnr"], rel=1e-6)
    assert ours["lmd"] == ref["lmd"]
    assert ours["lpips"] == pytest.approx(ref["lpips"], rel=1e-5)


def test_metrics_cli_track_and_video_inputs(videos, lpips_npz,  # noqa: F811
                                            capsys, monkeypatch):
    """``--track`` without FAN weights says so and leaves the LMD out; a
    video path without OpenCV fails as the JAX CLI fails."""
    out = _run(t_metrics.main, ["--pred", videos["pred"], "--gt",
                                videos["gt"], "--track", "--device", "cpu"],
               capsys)
    assert set(out) == {"psnr", "lpips", "lpips_real"}
    monkeypatch.setitem(sys.modules, "cv2", None)
    argv = ["--pred", "clip.mp4", "--gt", videos["gt"]]
    for main, extra in ((j_metrics.main, []),
                        (t_metrics.main, ["--device", "cpu"])):
        with pytest.raises(ImportError, match="cv2"):
            main(argv + extra)


def test_auerror_cli_matches_jax(tmp_path, capsys):
    paths = []
    for seed, n in ((1, 12), (2, 9)):
        scene = str(tmp_path / f"s{seed}")
        generate_scene(scene, n_frames=n - 2, size=32, n_val=2, seed=seed)
        paths.append(os.path.join(scene, "au.csv"))
    argv = ["--pred", paths[0], "--gt", paths[1]]
    j_auerror.main(argv)
    ref = capsys.readouterr().out
    ours = t_auerror.main(argv)
    assert capsys.readouterr().out == ref
    assert set(ours) == {"au_all", "au_lower", "au_upper"}
