"""The port's learned extractors against the JAX package's on the CPU, with
random weights from a seed (no public checkpoint ships with the
repository):

* FAN (one hourglass), BiSeNet and the EasyPortrait FPN each load the JAX
  module's ``state_dict`` strictly and give its outputs within 1e-6 of
  their scale at small inputs (the JAX BiSeNet is built with an empty
  ``torchvision`` module in ``sys.modules``, which it imports unused);
* ``crop`` byte for byte and ``decode_heatmaps`` equal;
* ``process --task 4``, ``7`` and ``11`` without ``--synthetic_gt``, the
  checkpoints named by ``INSTAG_BISENET_WEIGHTS``, ``INSTAG_FAN_WEIGHTS``
  and ``INSTAG_EASYPORTRAIT_FPN``, on three frames: the parsing PNGs'
  pixels, the ``.lms`` files (a 3-frame ``LandmarkTracker`` run) and the
  teeth masks equal to the JAX package's;
* the two other teeth-mask routes (a TorchScript segmentor, the
  inner-mouth polygon) and ``run_sapiens`` with tiny scripted networks:
  masks equal, priors within 1e-5;
* ``metrics.track_video_landmarks`` equal to the JAX package's with the
  FAN checkpoint, and ``cli.metrics --track`` giving an LMD.
"""

import json
import os
import shutil
import sys
import types

import cv2
import numpy as np
import pytest
import torch

from instag_tpu import metrics as JMet
from instag_tpu.data_utils import easyportrait_fpn as JE
from instag_tpu.data_utils import face_parsing as JFP
from instag_tpu.data_utils import landmarks as JL
from instag_tpu.data_utils import priors as JPr
from instag_tpu.data_utils import process as JP
from instag_torch import metrics as TMet
from instag_torch.cli import metrics as t_metrics
from instag_torch.data.image_io import read_png
from instag_torch.data_utils import easyportrait_fpn as TE
from instag_torch.data_utils import face_parsing as TFP
from instag_torch.data_utils import landmarks as TL
from instag_torch.data_utils import priors as TPr
from instag_torch.data_utils import process as TP
from tests.torch_cpu import one_torch_thread  # noqa: F401

NET_TOL = 1e-6
PRIOR_TOL = 1e-5
SIZE = 64


def _jax_bisenet(monkeypatch):
    monkeypatch.setitem(sys.modules, "torchvision",
                        types.ModuleType("torchvision"))
    return JFP._build_bisenet()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Seeded random-weight JAX networks and their checkpoints (FAN under
    ``state_dict`` with a ``module.`` prefix, as 2DFAN releases were
    saved; the others plain)."""
    d = tmp_path_factory.mktemp("weights")
    torch.manual_seed(0)
    mp = pytest.MonkeyPatch()
    nets = {"fan": JL.build_fan(1).eval(),
            "bisenet": _jax_bisenet(mp).eval(),
            "fpn": JE.EasyPortraitFPN().eval()}
    mp.undo()
    paths = {k: str(d / f"{k}.pth") for k in nets}
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               nets["fan"].state_dict().items()}},
               paths["fan"])
    torch.save(nets["bisenet"].state_dict(), paths["bisenet"])
    torch.save({"state_dict": nets["fpn"].state_dict()}, paths["fpn"])
    return nets, paths


def _frames(n, size=SIZE, seed=0):
    """Smooth coloured frames with a face-like blob (uint8 RGB)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = []
    for i in range(n):
        blob = np.exp(-((xx - 0.5 - 0.02 * i) ** 2 + (yy - 0.45) ** 2) / 0.05)
        img = np.stack([120 + 100 * blob, 90 + 80 * blob * xx,
                        70 + 60 * yy], -1) + rng.normal(0, 3, (size, size, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


@pytest.mark.parametrize("name", ["fan", "bisenet", "fpn"])
def test_networks_load_jax_weights_strictly(checkpoints, name):
    nets, _ = checkpoints
    port = {"fan": lambda: TL.build_fan(1), "bisenet": TFP.BiSeNet,
            "fpn": TE.EasyPortraitFPN}[name]().eval()
    port.load_state_dict(nets[name].state_dict(), strict=True)
    x = torch.from_numpy(_frames(1)[0].transpose(2, 0, 1)[None] / 255.0
                         ).float()
    with torch.no_grad():
        want, got = nets[name](x), port(x)
    if name == "fan":
        want, got = want[-1], got[-1]
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= NET_TOL * scale


def test_crop_and_decode_match_jax(checkpoints):
    img = _frames(1, 96)[0]
    for center, scale in (((48.0, 50.0), 0.35), ((20.0, 70.0), 0.6),
                          ((48.0, 48.0), 0.2)):
        assert np.array_equal(TL.crop(img, center, scale),
                              JL.crop(img, center, scale))
    hm = np.random.default_rng(1).normal(size=(68, 64, 64)).astype(
        np.float32)
    np.testing.assert_array_equal(
        TL.decode_heatmaps(hm, np.array([40.0, 50.0]), 0.4),
        JL.decode_heatmaps(hm, np.array([40.0, 50.0]), 0.4))


@pytest.fixture
def extractor_env(checkpoints, monkeypatch, tmp_path):
    _, paths = checkpoints
    monkeypatch.setenv("INSTAG_BISENET_WEIGHTS", paths["bisenet"])
    monkeypatch.setenv("INSTAG_FAN_WEIGHTS", paths["fan"])
    monkeypatch.setenv("INSTAG_EASYPORTRAIT_FPN", paths["fpn"])
    monkeypatch.setenv("INSTAG_TEETH_MODEL", str(tmp_path / "absent.pt"))
    monkeypatch.setitem(sys.modules, "torchvision",
                        types.ModuleType("torchvision"))
    return paths


def _capture(root, frames):
    """Two copies of a capture directory holding the frames' JPEGs."""
    dirs = []
    for name in ("jax", "port"):
        ori = os.path.join(root, name, "ori_imgs")
        os.makedirs(ori)
        dirs.append(os.path.join(root, name))
    for i, img in enumerate(frames):
        cv2.imwrite(os.path.join(dirs[0], "ori_imgs", f"{i}.jpg"),
                    img[..., ::-1])
        shutil.copy(os.path.join(dirs[0], "ori_imgs", f"{i}.jpg"),
                    os.path.join(dirs[1], "ori_imgs"))
    return dirs


def test_process_extractor_tasks_match_jax(extractor_env, tmp_path):
    ref, ours = _capture(str(tmp_path), _frames(3))
    for task in ("4", "7", "11"):
        JP.main([os.path.join(ref, "v.avi"), "--task", task])
        TP.main([os.path.join(ours, "v.avi"), "--task", task,
                 "--device", "cpu"])
    colours = set()
    for i in range(3):
        want = cv2.imread(os.path.join(ref, "parsing", f"{i}.png"))[..., ::-1]
        got = read_png(os.path.join(ours, "parsing", f"{i}.png"), 3)
        assert np.array_equal(got, want), i
        colours |= set(map(tuple, got.reshape(-1, 3)))
        for rel in (f"ori_imgs/{i}.lms",):
            with open(os.path.join(ref, rel)) as f, \
                    open(os.path.join(ours, rel)) as g:
                assert f.read() == g.read(), rel
        want = np.load(os.path.join(ref, "teeth_mask", f"{i}.npy"))
        got = np.load(os.path.join(ours, "teeth_mask", f"{i}.npy"))
        assert got.dtype == want.dtype == bool
        assert np.array_equal(got, want), i
    assert len(colours) > 1       # the random network paints classes


class _Conv(torch.nn.Module):
    def __init__(self, cout):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, cout, 3, padding=1)

    def forward(self, x):
        return self.conv(x)


class _Teeth(torch.nn.Module):
    """8 class logits: class 7 (teeth) the normalized red, the others 0."""

    def forward(self, x):
        zero = torch.zeros_like(x[:, :1])
        return torch.cat([zero, zero, zero, zero, zero, zero, zero,
                          x[:, :1]], 1)


def test_teeth_routes_and_sapiens_match_jax(checkpoints, monkeypatch,
                                            tmp_path):
    torch.manual_seed(1)
    scripted = {}
    for name, net in (("teeth", _Teeth()), ("depth", _Conv(1)),
                      ("normal", _Conv(3))):
        scripted[name] = str(tmp_path / f"{name}.pt")
        torch.jit.save(torch.jit.script(net.eval()), scripted[name])
    ref, ours = _capture(str(tmp_path), _frames(2, seed=3))
    rng = np.random.default_rng(2)
    for base in (ref, ours):
        os.makedirs(os.path.join(base, "gt_imgs"))
        for i in range(2):
            shutil.copy(os.path.join(base, "ori_imgs", f"{i}.jpg"),
                        os.path.join(base, "gt_imgs"))
    for i in range(2):
        lms = rng.uniform(10, SIZE - 10, (68, 2))
        for base in (ref, ours):
            np.savetxt(os.path.join(base, "ori_imgs", f"{i}.lms"), lms, "%f")
    monkeypatch.setenv("INSTAG_EASYPORTRAIT_FPN", str(tmp_path / "no.pth"))
    for route in ("torchscript", "fallback"):
        monkeypatch.setenv("INSTAG_TEETH_MODEL", scripted["teeth"]
                           if route == "torchscript"
                           else str(tmp_path / "no.pt"))
        JPr.create_teeth_masks(ref, os.path.join(ref, "ori_imgs"))
        TPr.create_teeth_masks(ours, os.path.join(ours, "ori_imgs"),
                               device="cpu")
        masks = [np.load(os.path.join(ours, "teeth_mask", f"{i}.npy"))
                 for i in range(2)]
        for i in range(2):
            want = np.load(os.path.join(ref, "teeth_mask", f"{i}.npy"))
            assert np.array_equal(masks[i], want), (route, i)
        assert any(m.any() for m in masks), route
    monkeypatch.setenv("INSTAG_SAPIENS_DEPTH", scripted["depth"])
    monkeypatch.setenv("INSTAG_SAPIENS_NORMAL", scripted["normal"])
    JPr.run_sapiens(ref)
    TPr.run_sapiens(ours, device="cpu")
    for kind in ("depth", "normal"):
        for i in range(2):
            rel = f"sapiens/{kind}/sapiens_0.3b/{i}.npy"
            want = np.load(os.path.join(ref, rel))
            got = np.load(os.path.join(ours, rel))
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=0, atol=PRIOR_TOL)


def test_track_video_landmarks_reach_the_fan(checkpoints, monkeypatch,
                                             tmp_path, capsys):
    _, paths = checkpoints
    monkeypatch.setenv("INSTAG_FAN_WEIGHTS", paths["fan"])
    frames = _frames(2, 96, seed=5)
    want = JMet.track_video_landmarks(frames)
    got = TMet.track_video_landmarks(frames, device="cpu")
    assert got.shape == (2, 68, 2)
    np.testing.assert_array_equal(got, want)
    for name, video in (("pred", frames[:1]), ("gt", frames[1:])):
        np.savez(tmp_path / f"{name}.npz", video=video)
    t_metrics.main(["--pred", str(tmp_path / "pred.npz"), "--gt",
                    str(tmp_path / "gt.npz"), "--track", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["lmd"])
