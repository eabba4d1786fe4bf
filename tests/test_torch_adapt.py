"""The port's single-process chain (``instag_torch/cli/adapt.py``), its
host-memory frame streaming (``train.common.HostFrameStore``) and the
adaptation CLIs' refusals, on a generated scene (8 train and 2 val frames
at 64x64; 200 initial splats in a capacity of 1024, K=256).

Streaming: the face and mouth loops over 12 steps (densification interval
5: three blocks, each uploaded on its own) give the same losses with the
frames in host memory as with the frames on the device, within 1e-6, and
the same alive masks.
"""

import json

import numpy as np
import pytest
import torch

from instag_tpu.data.synthetic import generate_scene
from instag_torch.cli import adapt, train_face, train_fuse_con, train_mouth
from instag_torch.config import ModelConfig, OptimizationConfig
from instag_torch.data.dataset import load_frames
from instag_torch.io.checkpoints import load_bundle
from instag_torch.train.common import (FrameMeta, HostFrameStore,
                                       build_frame_batch, frame_source)
from instag_torch.train.face import train_face as t_train_face
from instag_torch.train.mouth import train_mouth as t_train_mouth
from tests.test_torch_cli import KEYS, key_paths
from tests.torch_cpu import one_torch_thread  # noqa: F401

COMMON = ["--init_num", "200", "--capacity", "1024", "--max_per_tile", "256"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("adapt") / "scene")
    generate_scene(path, n_frames=8, size=64, n_val=2)
    return path


def test_host_frame_store_gathers_the_frames(scene):
    records = load_frames(scene, device="cpu")
    batch = build_frame_batch(records, with_priors=True, device="cpu")
    store = frame_source(records, with_priors=True, stream=True,
                         device="cpu")
    assert isinstance(store, HostFrameStore) and store.num_frames == 8
    assert isinstance(frame_source(records, device="cpu"), type(batch))
    assert isinstance(frame_source(records, stream_threshold=7,
                                   device="cpu"), HostFrameStore)
    idx = [5, 1, 1, 7]
    sub = store.gather(idx)
    for k, v in vars(batch).items():
        if v is None:
            assert getattr(sub, k) is None, k
        else:
            assert torch.equal(getattr(sub, k), v[idx]), k


def test_streaming_equals_in_memory(scene):
    records = load_frames(scene, device="cpu")
    meta = FrameMeta.from_records(records)
    mc = ModelConfig(init_num=200, capacity=1024, max_per_tile=256)
    oc = OptimizationConfig(iterations=12, densification_interval=5)
    res = {}
    for stream in (False, True):
        batch = frame_source(records, with_priors=True, stream=stream,
                             device="cpu")
        face = t_train_face(mc, oc, batch, meta, warm_step=6, seed=1,
                            lpips_enabled=False, device="cpu")
        mouth = t_train_mouth(mc, oc, batch, meta, face, warm_step=6,
                              seed=1, device="cpu")
        res[stream] = (face, mouth)
    for a, b in zip(res[False], res[True]):
        assert len(a["losses"]) == 12
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-6,
                                   atol=1e-6)
        assert torch.equal(a["state"].alive, b["state"].alive)


def test_adapt_fast_skip_synthesis_writes_the_bundles(scene, tmp_path):
    run = tmp_path / "run"
    res = adapt.main(["-s", scene, "-m", str(run), *COMMON, "--iterations",
                      "6", "--densification_interval", "3",
                      "--fuse_iterations", "4", "--mouth_init_num", "100",
                      "--fast", "--skip_synthesis", "--no_lpips",
                      "--device", "cpu"])
    keys = json.loads(KEYS.read_text())
    for which, it in (("face", 6), ("mouth", 6), ("fuse", 4)):
        b = load_bundle(str(run / f"chkpnt_{which}_latest.pkl"))
        assert key_paths(b) == keys[which], which
        assert b["iteration"] == it
    assert len(res["face"]["losses"]) == len(res["mouth"]["losses"]) == 6
    assert len(res["fuse"]["losses"]) == 4
    assert int(res["mouth"]["state"].num_alive()) <= 100
    assert (run / "point_cloud" / "iteration_6_face" /
            "point_cloud.ply").exists()
    assert not (run / "out.mp4").exists() and "video" not in res
    assert json.loads((run / "cfg_args.json").read_text())["init_num"] == 200


@pytest.mark.parametrize("cli", [train_face, train_mouth, train_fuse_con,
                                 adapt])
def test_data_parallel_is_refused(cli, tmp_path):
    with pytest.raises(SystemExit, match="queue 1, item 7"):
        cli.main(["-s", str(tmp_path), "-m", str(tmp_path),
                  "--data_parallel", "2", "--device", "cpu"])
