"""The port's real-weights suite: the counterpart of
``tests/test_real_weights.py`` for every external-model loader of
``instag_torch``, with the same ``weights/`` file names and environment
variables. Without its file each test skips (no weights are in the
repository and none are fetched), so CI stays green everywhere, while a
machine where ``scripts/fetch_weights.sh`` has run proves the port's
real-checkpoint branches:

    python -m pytest tests/test_torch_real_weights.py -m realweights -v

Each test checks on the port what its JAX counterpart checks on the JAX
package (LPIPS of identical images below 1e-5, the parsing map's shape,
the feature shapes, ...), then holds the port's output against the JAX
loader's on the same input and file: the networks within 1e-6 of their
output's scale (``tests/test_torch_extractors.py``'s ``NET_TOL``), their
class maps and parsing images equal, LPIPS within rtol 1e-5
(``tests/test_torch_lpips.py``), the AVE features within 1e-5 of their
scale (``tests/test_torch_audio_features.py``), the sapiens priors within
1e-5 (``PRIOR_TOL``), the DeepSpeech graph's features equal (one graph
run by TensorFlow in both). The port runs on the CPU here."""

import os
import sys
import types

import numpy as np
import pytest
import torch
from tests.torch_cpu import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.realweights

W = os.path.join(os.path.dirname(__file__), "..", "weights")
NET_TOL = 1e-6
LPIPS_RTOL = 1e-5
AVE_TOL = 1e-5
PRIOR_TOL = 1e-5
CPU = torch.device("cpu")


def _need(path):
    p = os.path.join(W, path)
    if not os.path.exists(p):
        pytest.skip(f"weights/{path} not present (run scripts/fetch_weights.sh)")
    return p


def _within(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    assert scale > 0, name
    assert float(np.abs(got - want).max()) <= tol * scale, name


def _torchvision_stub(monkeypatch):
    """The JAX package's BiSeNet imports torchvision and uses nothing of
    it: an empty module where it is not installed."""
    try:
        import torchvision  # noqa: F401
    except ImportError:
        monkeypatch.setitem(sys.modules, "torchvision",
                            types.ModuleType("torchvision"))


def _wav(path, seconds):
    from scipy.io import wavfile
    wav = (0.1 * np.sin(np.linspace(0, 800 * seconds, 16000 * seconds))
           ).astype(np.float32)
    wavfile.write(path, 16000, (wav * 32767).astype(np.int16))


def test_lpips_real_weights(monkeypatch):
    monkeypatch.setenv("INSTAG_LPIPS_WEIGHTS", _need("lpips_alex.npz"))
    import jax
    import jax.numpy as jnp
    from instag_torch.models.lpips import load_lpips_params
    net, real = load_lpips_params(device=CPU)
    assert real, "loader fell back despite weights present"
    a = torch.zeros((1, 3, 64, 64))
    b = torch.ones((1, 3, 64, 64)) * 0.5
    with torch.no_grad():
        d_same, d_diff = float(net(a, a)[0]), float(net(a, b)[0])
    assert d_same < 1e-5 < d_diff  # identical -> ~0, different -> positive

    from instag_tpu.models.lpips import load_lpips_params as j_load
    model, params, j_real = j_load()
    assert j_real
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, x.shape), -1, 1).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x),
                                           jnp.asarray(y)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL)


def test_bisenet_real_checkpoint(tmp_path, monkeypatch):
    path = _need("79999_iter.pth")
    monkeypatch.setenv("INSTAG_BISENET_WEIGHTS", path)
    from instag_torch.data.image_io import read_png, write_jpeg
    from instag_torch.data_utils import face_parsing as TFP
    ori = tmp_path / "ori_imgs"
    ori.mkdir()
    img = (np.random.default_rng(0).uniform(0, 255, (128, 128, 3))
           ).astype(np.uint8)
    write_jpeg(str(ori / "0.jpg"), img)
    TFP.run_parsing(str(ori), str(tmp_path / "parsing"), device=CPU)
    seg = read_png(str(tmp_path / "parsing" / "0.png"), channels=3)
    assert seg is not None and seg.shape == (128, 128, 3)

    _torchvision_stub(monkeypatch)
    from instag_tpu.data_utils import face_parsing as JFP
    JFP.run_parsing(str(ori), str(tmp_path / "j_parsing"))
    np.testing.assert_array_equal(
        seg, read_png(str(tmp_path / "j_parsing" / "0.png"), channels=3))
    j_net = JFP._build_bisenet()
    j_net.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=False), strict=False)
    net = TFP.load_bisenet(path, CPU)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 3, 512, 512)).astype(np.float32))
    with torch.no_grad():
        _within(net(x)[0], j_net.eval()(x)[0], NET_TOL, "logits")


def test_ave_real_encoder(tmp_path, monkeypatch):
    monkeypatch.setenv("INSTAG_AVE_WEIGHTS", _need("ave_encoder.npz"))
    from instag_torch.data_utils.audio_features import extract_ave
    p = str(tmp_path / "aud.wav")
    _wav(p, 1)
    out = str(tmp_path / "aud_ave.npy")
    extract_ave(p, out, device=CPU)
    feats = np.load(out)
    assert feats.shape[1:] == (512, 1) and np.isfinite(feats).all()

    from instag_tpu.data_utils.audio_features import extract_ave as j_ave
    j_out = str(tmp_path / "j_aud_ave.npy")
    j_ave(p, j_out)
    _within(feats, np.load(j_out), AVE_TOL, "ave")


def test_deepspeech_real_graph(tmp_path):
    pb = os.path.join(W, "deepspeech-0.1.0", "output_graph.pb")
    if not os.path.exists(pb):
        pytest.skip("DeepSpeech graph not present")
    pytest.importorskip("tensorflow")
    from instag_torch.data_utils.audio_features import _extract_deepspeech_tf
    p = str(tmp_path / "aud.wav")
    _wav(p, 2)
    out = str(tmp_path / "aud_ds.npy")
    _extract_deepspeech_tf(p, out, pb)
    feats = np.load(out)
    assert feats.shape[1:] == (16, 29) and np.isfinite(feats).all()

    from instag_tpu.data_utils.audio_features import (
        _extract_deepspeech_tf as j_ds)
    j_out = str(tmp_path / "j_aud_ds.npy")
    j_ds(p, j_out, pb)
    np.testing.assert_array_equal(feats, np.load(j_out))


def test_sapiens_real_models(tmp_path, monkeypatch):
    monkeypatch.setenv("INSTAG_SAPIENS_DEPTH",
                       _need("sapiens_0.3b_depth.pt2"))
    monkeypatch.setenv("INSTAG_SAPIENS_NORMAL",
                       _need("sapiens_0.3b_normal.pt2"))
    from instag_torch.data.image_io import write_jpeg
    from instag_torch.data_utils.priors import run_sapiens
    img = (np.random.default_rng(0).uniform(0, 255, (256, 256, 3))
           ).astype(np.uint8)
    outs = {}
    for name in ("port", "jax"):
        base = tmp_path / name
        (base / "gt_imgs").mkdir(parents=True)
        write_jpeg(str(base / "gt_imgs" / "0.jpg"), img)
        outs[name] = base
    run_sapiens(str(outs["port"]), max_frames=1, device=CPU)
    depth = np.load(outs["port"] / "sapiens/depth/sapiens_0.3b/0.npy")
    normal = np.load(outs["port"] / "sapiens/normal/sapiens_0.3b/0.npy")
    assert depth.shape == (256, 256)
    assert normal.shape == (256, 256, 3)
    assert np.isfinite(depth).all() and np.isfinite(normal).all()

    from instag_tpu.data_utils.priors import run_sapiens as j_sapiens
    j_sapiens(str(outs["jax"]), max_frames=1)
    for kind, got in (("depth", depth), ("normal", normal)):
        want = np.load(outs["jax"] / f"sapiens/{kind}/sapiens_0.3b/0.npy")
        np.testing.assert_allclose(got, want, rtol=PRIOR_TOL,
                                   atol=PRIOR_TOL, err_msg=kind)


def test_bfm_real_basis():
    npz = os.path.join(W, "bfm2009.npz")
    if not os.path.exists(npz):
        pytest.skip("converted BFM basis not present (license-gated)")
    from instag_torch.data_utils.face_model import geometry, load_model
    model = load_model(npz)
    assert model.id_basis.shape[-1] == 100
    assert model.exp_basis.shape[-1] == 79
    geo = geometry(model, torch.zeros(100), torch.zeros(79)).numpy()
    # facemodel.py normalization: mean-centered, /1e5 -> head-sized units
    assert abs(geo.mean()) < 1e-3 and 0.01 < np.abs(geo).max() < 10.0

    from instag_tpu.data_utils import face_model as JF
    j_model = JF.load_model(npz)
    rng = np.random.default_rng(0)
    idp = rng.normal(size=100).astype(np.float32)
    exp = rng.normal(size=79).astype(np.float32)
    _within(geometry(model, torch.from_numpy(idp), torch.from_numpy(exp)),
            JF.geometry(j_model, idp, exp), NET_TOL, "geometry")


def test_easyportrait_fpn_real_checkpoint():
    """The public fpn-fp-512.pth must load STRICTLY into the from-scratch
    arch and segment a face-ish image without mmseg/mmcv."""
    p = _need("fpn-fp-512.pth")
    import cv2

    from instag_torch.data_utils.easyportrait_fpn import (load_fpn_fp,
                                                          segment,
                                                          segment_logits)
    model = load_fpn_fp(p, device=CPU)
    img = np.full((128, 128, 3), 128, np.uint8)
    cv2.circle(img, (64, 64), 40, (180, 160, 200), -1)   # skin-ish blob
    rgb = np.ascontiguousarray(img[:, :, ::-1])
    cls = segment(model, rgb)
    assert cls.shape == (128, 128)
    assert cls.max() < 8

    from instag_tpu.data_utils import easyportrait_fpn as JE
    j_model = JE.load_fpn_fp(p)
    np.testing.assert_array_equal(cls, JE.segment(j_model, img))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 3, 128, 128)).astype(np.float32))
    with torch.no_grad():
        _within(model(x), j_model(x), NET_TOL, "logits")
    assert segment_logits(model, rgb).shape == (8, 128, 128)


def test_fan_real_weights(monkeypatch):
    """The public 2DFAN-4 release (TorchScript zip or legacy state dict)
    must load and track landmarks on a synthetic face-ish frame."""
    monkeypatch.setenv("INSTAG_FAN_WEIGHTS", _need("2DFAN4-cd938726ad.zip"))
    import cv2

    from instag_torch.data_utils.landmarks import LandmarkTracker
    img = np.full((256, 256, 3), 90, np.uint8)
    cv2.ellipse(img, (128, 140), (70, 95), 0, 0, 360, (190, 160, 140), -1)
    cv2.circle(img, (100, 115), 10, (40, 30, 30), -1)   # eyes
    cv2.circle(img, (156, 115), 10, (40, 30, 30), -1)
    cv2.ellipse(img, (128, 185), (28, 12), 0, 0, 360, (120, 60, 60), -1)
    tracker = LandmarkTracker(device=CPU)
    lms = tracker(img)
    assert lms.shape == (68, 2)
    assert np.isfinite(lms).all()
    # second frame goes through the previous-landmark bbox path
    lms2 = tracker(img)
    assert np.abs(lms2 - lms).mean() < 20.0

    from instag_tpu.data_utils import landmarks as JL
    j_tracker = JL.LandmarkTracker()
    centre, scale = np.array([128.0, 140.0]), 1.0
    # the JAX tracker's crop and network, as its _run feeds them
    inp = JL.crop(img, centre, scale).astype(np.float32) / 255.0
    with torch.no_grad():
        out = j_tracker.net(torch.from_numpy(inp.transpose(2, 0, 1))[None])
    want = (out[-1] if isinstance(out, (list, tuple)) else out)[0]
    _within(tracker.heatmaps(img, centre, scale), want.float().numpy(),
            NET_TOL, "heatmaps")
    np.testing.assert_allclose(np.stack([lms, lms2]),
                               np.stack([j_tracker(img), j_tracker(img)]),
                               rtol=0, atol=1e-3)
