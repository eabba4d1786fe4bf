"""The port's fusion fine-tune (``instag_torch/train/fuse.py``) against the
JAX package's ``train_fuse``.

Both run 10 steps on a generated scene (8 frames at 64x64, K=256) from the
same face and mouth bundles, built directly (200 face splats in a capacity
of 4096, so that the snug pack runs, and 150 mouth splats in 512, each
below K per tile), with LPIPS from step 6: both packages read the JAX
package's random-feature LPIPS parameters from one ``.npz``. Frames and
patch sides come from one seed, drawn per block of 100 steps.

Tolerances: per-step losses within rtol 1e-3 (see
tests/test_torch_train_face.py); the frozen geometry (xyz, scaling and
rotation of both clouds, the mouth's opacity) bit-equal to the packed
input on both sides.
"""

import re
import warnings

import numpy as np
import jax
import pytest
import torch

import instag_tpu.models.lpips as JL
import instag_tpu.train.common as j_common
from instag_tpu.bench_utils import synthetic_state as j_state
from instag_tpu.config import ModelConfig as JModelConfig
from instag_tpu.config import OptimizationConfig as JOptConfig
from instag_tpu.data.synthetic import generate_scene
from instag_tpu.train import fuse as JFu
from instag_torch.config import ModelConfig, OptimizationConfig
from instag_torch.io.from_jax import frame_batch, load_motion_net, state_from_jax
from instag_torch.models import motion as TM
from instag_torch.train import fuse as TFu
from tests.test_torch_motion import flax_tree
from tests.torch_cpu import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-3
FROZEN = {"face": ("xyz", "scaling", "rotation"),
          "mouth": ("xyz", "scaling", "rotation", "opacity")}


def test_fuse_patch_sizes_match_jax():
    for h, w in ((64, 64), (80, 100), (512, 512), (36, 64), (16, 16)):
        assert TFu.fuse_patch_sizes(h, w) == JFu.fuse_patch_sizes(h, w)


@pytest.fixture
def lpips_npz(tmp_path, monkeypatch):
    """The JAX package's random-feature LPIPS written where both packages
    look for converted weights."""
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


def test_train_fuse_matches_jax(tmp_path, lpips_npz, monkeypatch, capsys):
    scene = str(tmp_path / "scene")
    generate_scene(scene, n_frames=8, size=64)
    records = j_common.load_training_frames(JModelConfig(source_path=scene))
    monkeypatch.setattr(j_common, "load_training_frames",
                        lambda model_cfg: records)
    j_batch = j_common.build_frame_batch(records)

    nets = dict(face_umf=TM.MotionNetwork(), mouth_umf=TM.MouthMotionNetwork(),
                face_pmf=TM.PersonalizedMotionNetwork("face"),
                mouth_pmf=TM.PersonalizedMotionNetwork("mouth"))
    params = {k: flax_tree(n, np.random.default_rng(80 + i))
              for i, (k, n) in enumerate(nets.items())}
    states = dict(face=j_state(200, 4096, seed=6, spread=0.1, scale=0.02),
                  mouth=j_state(150, 512, seed=7, max_sh_degree=2,
                                spread=0.04, scale=0.01))
    t_bundles = {
        b: dict(state=state_from_jax(states[b], device="cpu"),
                umf_net=load_motion_net(nets[f"{b}_umf"],
                                        params[f"{b}_umf"], device="cpu"),
                pmf_net=load_motion_net(nets[f"{b}_pmf"],
                                        params[f"{b}_pmf"], device="cpu"))
        for b in ("face", "mouth")}
    before = {b: {f: getattr(t_bundles[b]["state"].params, f).clone()
                  for f in FROZEN[b]} for b in FROZEN}
    t_batch = frame_batch({k: None if v is None else np.asarray(v)
                           for k, v in vars(j_batch).items()}, device="cpu")

    oc = dict(iterations=10)
    model = dict(max_per_tile=256)
    ref = JFu.train_fuse(
        JModelConfig(source_path=scene, approx_topk=False, **model),
        JOptConfig(**oc),
        *(dict(state=states[b], umf_params=params[f"{b}_umf"],
               pmf_params=params[f"{b}_pmf"]) for b in ("face", "mouth")),
        log_every=5, seed=3)
    j_log = capsys.readouterr().out
    res = TFu.train_fuse(ModelConfig(**model), OptimizationConfig(**oc),
                         t_batch, t_bundles["face"], t_bundles["mouth"],
                         log_every=5, seed=3, device="cpu")
    t_log = capsys.readouterr().out

    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=LOSS_RTOL)
    assert len(res["losses"]) == 10 and np.isfinite(res["losses"]).all()
    # the snug pack: the face to 2048 slots, the mouth kept at 512
    assert res["face_state"].capacity == ref["face_state"].capacity == 2048
    assert res["mouth_state"].capacity == ref["mouth_state"].capacity == 512
    pack = re.findall(r"\[fuse\] (\w+) capacity (\d+) -> (\d+)", t_log)
    assert pack == re.findall(r"\[fuse\] (\w+) capacity (\d+) -> (\d+)",
                              j_log) == [("face", "4096", "2048")]
    for b in FROZEN:
        st, j_st = res[f"{b}_state"], ref[f"{b}_state"]
        cap = st.capacity
        for f in FROZEN[b]:
            got = getattr(st.params, f)
            assert torch.equal(got, before[b][f][:cap]), (b, f)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(getattr(j_st.params, f)))
        # appearance trained, and the input bundle was left as it was
        assert not torch.equal(st.params.features_dc,
                               t_bundles[b]["state"].params.features_dc[:cap])
    assert not torch.equal(res["face_state"].params.opacity,
                           t_bundles["face"]["state"].params.opacity[:2048])

    def logged(log):
        return re.findall(r"\[fuse (\d+)/10\] loss=", log)
    assert logged(t_log) == logged(j_log) == ["10"]


def test_fuse_lpips_term_in_second_half(lpips_npz):
    """The LPIPS term is added from ``iterations // 2 + 1``: the port's step
    with the flag on exceeds the same step with it off."""
    from instag_torch.bench_utils import (synthetic_frame_batch,
                                          synthetic_motion_params,
                                          synthetic_state)
    from instag_torch.models.lpips import load_lpips_params
    from instag_torch.ops.rasterize import RasterizeConfig

    nets = synthetic_motion_params(seed=2, device="cpu")
    face = synthetic_state(200, 512, seed=1, scale=0.02, device="cpu")
    mouth = synthetic_state(100, 512, seed=2, spread=0.04, device="cpu")
    batch = synthetic_frame_batch(64, n_frames=1, device="cpu")
    lpips, real = load_lpips_params(device="cpu")
    assert real
    step = TFu.make_fuse_step(RasterizeConfig(64, 64), OptimizationConfig(),
                              nets["face_umf"], nets["mouth_umf"],
                              nets["face_pmf"], nets["mouth_pmf"], 1.0,
                              device="cpu", lpips=lpips,
                              lpips_patches=TFu.fuse_patch_sizes(64, 64))
    with torch.no_grad():
        on, img = step.loss(face, mouth, batch, 0, 2, 1.0)
        off, _ = step.loss(face, mouth, batch, 0, 2, 0.0)
    assert img.shape == (3, 64, 64) and torch.isfinite(img).all()
    assert float(on) > float(off) + 1e-5


def test_train_fuse_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TFu.train_fuse(ModelConfig(), OptimizationConfig(), None, {}, {})
