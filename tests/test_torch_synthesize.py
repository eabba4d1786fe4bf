"""Clip synthesis against the JAX package: ``synthesize`` in its three
selection modes, the deformed-PLY export and the ``synthesize_fuse`` CLI,
on one generated 64x64 scene (4 val frames) and one small fuse bundle of
seeded JAX networks and states written by the JAX package's
``save_bundle``.

The JAX ``synthesize`` builds ``RasterizeConfig(h, w, max_per_tile)`` with
its default ``approx_topk=True``; on the CPU, XLA lowers ``approx_max_k``
to the exact ``TopK`` (checked in ``test_jax_approx_top_k_is_exact_on_cpu``),
so the JAX reference selects exactly as the port does. Frames are uint8:
``(clip(x) * 255).astype(uint8)`` truncates, so a float difference of 1e-6
can flip a level; they are compared within 1 level, with the share of
pixels that differ bounded."""

import contextlib
import io
import os
import re
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.bench_utils import synthetic_state as j_state
from instag_tpu.config import ModelConfig as JModelConfig
from instag_tpu.config import save_cfg as j_save_cfg
from instag_tpu.data.dataset import load_frames as j_load_frames
from instag_tpu.data.synthetic import generate_scene
from instag_tpu.io.checkpoints import load_bundle as j_load_bundle
from instag_tpu.io.checkpoints import save_bundle as j_save_bundle
from instag_tpu.io.checkpoints import state_from_dict as j_state_from_dict
from instag_tpu.io.checkpoints import state_to_dict as j_state_to_dict
from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
from instag_tpu.synthesize import export_deformed_plys as j_export
from instag_tpu.synthesize import synthesize as j_synthesize
from instag_tpu.train.common import build_frame_batch as j_build_batch
from instag_torch.cli import synthesize_fuse as cli
from instag_torch.config import load_cfg
from instag_torch.data.plyio import read_ply
from instag_torch.models import motion as TM
from instag_torch.ops.rasterize import RasterizeConfig
from instag_torch.synthesize import (export_deformed_plys,
                                     make_synthesis_chunk_fn, synthesize)
from instag_torch.train.common import build_frame_batch
from instag_torch.data.dataset import load_frames
from tests.test_torch_motion import flax_tree
from tests.torch_cpu import one_torch_thread  # noqa: F401

SIZE = 64
N_VAL = 4
MODES = {"exact": {}, "every2": {"select_every": 2},
         "auto4": {"select_auto": 4.0}}
# pixels whose level differs by one (uint8 truncation of float noise)
MAX_DIFF_SHARE = 1e-3


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The scene, the bundle directory, and each mode's JAX frames and
    printed refresh line."""
    root = tmp_path_factory.mktemp("clip")
    scene, model_dir = str(root / "scene"), str(root / "model")
    generate_scene(scene, n_frames=6, size=SIZE, n_val=N_VAL)
    face = j_state(200, 512, seed=0, spread=0.3, scale=0.03)
    mouth = j_state(80, 256, seed=1, spread=0.12, scale=0.02)
    nets = {"face_umf": TM.MotionNetwork(), "mouth_umf": TM.MouthMotionNetwork(),
            "face_pmf": TM.PersonalizedMotionNetwork("face"),
            "mouth_pmf": TM.PersonalizedMotionNetwork("mouth")}
    bundle = {f"{k}_params": flax_tree(net, np.random.default_rng(30 + i))
              for i, (k, net) in enumerate(nets.items())}
    bundle.update(face_state=j_state_to_dict(face),
                  mouth_state=j_state_to_dict(mouth), iteration=10)
    path = os.path.join(model_dir, "chkpnt_fuse_latest.pkl")
    j_save_bundle(path, bundle)
    mc = JModelConfig(source_path=scene, model_path=model_dir,
                      max_per_tile=256)
    j_save_cfg(model_dir, mc)

    jb = j_load_bundle(path)
    jb["face_state"] = j_state_from_dict(jb["face_state"])
    jb["mouth_state"] = j_state_from_dict(jb["mouth_state"])
    ref = {}
    for mode, kw in MODES.items():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            video, _ = j_synthesize(mc, jb, split="val", out_path=None, **kw)
        ref[mode] = (np.asarray(video), out.getvalue())
    return dict(scene=scene, model_dir=model_dir, path=path, jax=ref,
                jax_bundle=jb, jax_cfg=mc)


def _port_clip(clip, **kw):
    mc = load_cfg(clip["model_dir"])
    model = cli.load_fuse_model(clip["path"], mc.audio_extractor, "cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        video, fps = synthesize(mc, model, split="val", out_path=None,
                                device="cpu", **kw)
    return video, out.getvalue()


def test_jax_approx_top_k_is_exact_on_cpu():
    x = np.random.default_rng(0).normal(size=(16, 600)).astype(np.float32)
    x[x < -0.5] = -np.inf
    approx = jax.lax.approx_max_k(jnp.asarray(x), 256, recall_target=0.9)
    exact = jax.lax.top_k(jnp.asarray(x), 256)
    for a, b in zip(approx, exact):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_cfg_with_approx_topk_loads(clip):
    mc = load_cfg(clip["model_dir"])
    assert mc.approx_topk is True and mc.max_per_tile == 256
    assert mc.source_path == clip["scene"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_synthesize_matches_jax(clip, mode):
    ref, ref_log = clip["jax"][mode]
    video, log = _port_clip(clip, **MODES[mode])
    assert video.dtype == np.uint8 and video.shape == ref.shape
    assert video.shape == (N_VAL, SIZE, SIZE, 3)
    diff = np.abs(video.astype(np.int32) - ref.astype(np.int32))
    share = float((diff > 0).mean())
    print(f"{mode}: max level diff {diff.max()}, differing share {share:.2e}")
    assert diff.max() <= 1 and share <= MAX_DIFF_SHARE
    # the frames are not empty: both branches and the torso show
    assert 5 < video.mean() < 250
    if "select_auto" in MODES[mode]:
        pat = r"face (\d+)/(\d+), mouth (\d+)/(\d+) selection refreshes"
        counts = re.search(pat, log).groups()
        print(f"{mode}: refreshes {counts}")
        assert counts == re.search(pat, ref_log).groups()


def test_select_every_reuses_between_refreshes(clip):
    """select_every 2 on frames (0, 1): frame 1 composites with frame 0's
    tile lists, so it differs from the exact frame 1 only where splats
    crossed tiles; frame 0 is the exact frame."""
    mc = load_cfg(clip["model_dir"])
    model = cli.load_fuse_model(clip["path"], mc.audio_extractor, "cpu")
    batch = build_frame_batch(load_frames(clip["scene"], "val", device="cpu"),
                              device="cpu")
    cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=256)
    exact = make_synthesis_chunk_fn(cfg, device="cpu")(model, batch, [0, 1])
    reuse = make_synthesis_chunk_fn(cfg, select_every=2, device="cpu")(
        model, batch, [0, 1])
    assert torch.equal(exact[0], reuse[0])
    err = (exact[1].float() - reuse[1].float()) / 255.0
    assert -10 * np.log10(float((err ** 2).mean()) + 1e-12) > 40.0


def test_export_deformed_plys_matches_jax(clip, tmp_path):
    jb, mc = clip["jax_bundle"], clip["jax_cfg"]
    j_batch = j_build_batch(j_load_frames(clip["scene"], "val"))
    j_export(JConfig(SIZE, SIZE), mc, jb, j_batch, str(tmp_path / "jax"),
             n_frames=3, personalized=True)
    model = cli.load_fuse_model(clip["path"], "deepspeech", "cpu")
    batch = build_frame_batch(load_frames(clip["scene"], "val", device="cpu"),
                              device="cpu")
    export_deformed_plys(model, batch, str(tmp_path / "torch"), n_frames=3,
                         personalized=True)
    for i in range(3):
        a = read_ply(str(tmp_path / "jax" / f"deformed_{i}.ply"))
        b = read_ply(str(tmp_path / "torch" / f"deformed_{i}.ply"))
        assert list(a) == list(b) and a["x"].shape == (200,)
        for name in a:
            np.testing.assert_allclose(b[name], a[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def test_cli_writes_the_library_frames(clip, monkeypatch, capsys):
    """``main([..., "--device", "cpu"])`` without OpenCV writes the
    ``.frames.npz`` dump, equal to the library call's frames."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    cli.main(["-m", clip["model_dir"], "--fast", "--device", "cpu"])
    log = capsys.readouterr().out
    path = os.path.join(clip["model_dir"], "out.mp4.frames.npz")
    assert f"wrote {path}" in log
    video, _ = _port_clip(clip)
    np.testing.assert_array_equal(np.load(path)["video"], video)
