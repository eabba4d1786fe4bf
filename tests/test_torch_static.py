"""The port's static 3DGS trainer against the JAX package's
``train/static.py`` on a generated 64x64 scene (8 frames), with 200 initial
splats in a capacity of 1024 and K=256, so that no tile is cut.

  * one ``make_train_step`` step on the same cloud and frame: the loss
    within 1e-5, and the new parameters, Adam moments and densification
    statistics within the face step's tolerances;
  * a 30-step ``train()`` of each, densification set to start after the
    run (JAX's split draws cannot be replayed, and
    tests/test_torch_densify.py holds ``densify_and_prune`` with JAX's own
    draws): per-step losses within rtol 1e-3 (Adam with eps 1e-15 moves a
    parameter by its learning rate on the sign of a rounding-noise
    gradient, so the clouds drift apart in their last bits), the alive
    masks equal and the train-view PSNR within 0.05 dB;
  * ``main`` in process on the CPU: its ``point_cloud.ply`` reads back
    through the JAX package's ``load_gaussian_ply`` equal to the state.

On the CPU the port's kernel backend runs the kernels' plain versions.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.config import ModelConfig as JModelConfig
from instag_tpu.config import OptimizationConfig as JOptConfig
from instag_tpu.data.dataset import load_frames as j_load_frames
from instag_tpu.data.dataset import scene_extent as j_scene_extent
from instag_tpu.data.synthetic import generate_scene
from instag_tpu.io.checkpoints import load_gaussian_ply as j_load_ply
from instag_tpu.models import gaussians as JG
from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
from instag_tpu.train import common as j_common
from instag_tpu.train import static as JS
from instag_torch.config import ModelConfig, OptimizationConfig
from instag_torch.io.from_jax import frame_batch, state_from_jax
from instag_torch.models import gaussians as G
from instag_torch.ops.rasterize import RasterizeConfig
from instag_torch.train import static as TS
from tests.test_torch_face import _close
from tests.torch_cpu import one_torch_thread  # noqa: F401

SIZE, K, INIT, CAP = 64, 256, 200, 1024
STEPS = 30
LOSS_RTOL = 1e-3


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("static_scene"))
    generate_scene(path, n_frames=8, size=SIZE, n_val=2)
    return path


def test_train_step_matches_jax(scene_dir):
    records = j_load_frames(scene_dir, "train")
    j_batch = j_common.build_frame_batch(records)
    _, extent = j_scene_extent(records)
    # spread over the head, so that no pixel's transmittance ends near
    # the 1e-4 cut, whose last bits the two composites round differently
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-0.35, 0.35, (INIT, 3)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (INIT, 3)).astype(np.float32)
    state = JG.create_from_points(jnp.asarray(xyz), jnp.asarray(colors), CAP,
                                  2, extent)
    oc = OptimizationConfig()
    frame, step = 3, 7
    # the JAX step donates its carry: take the port's copies first
    t_state = state_from_jax(state, device="cpu")
    t_batch = frame_batch({k: None if v is None else np.asarray(v)
                           for k, v in vars(j_batch).items()}, device="cpu")
    j_step = JS.make_train_step(JConfig(SIZE, SIZE, max_per_tile=K,
                                        approx_topk=False),
                                JOptConfig(), extent)
    j_state1, j_opt, j_loss = jax.device_get(
        j_step(state, JG.adam_init(state.params), j_batch, frame, step))

    t_step = TS.make_train_step(RasterizeConfig(SIZE, SIZE, max_per_tile=K),
                                oc, extent)
    t_state1, t_opt, t_loss = t_step(t_state, G.adam_init(t_state.params),
                                     t_batch, frame, step)

    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    assert int((t_state1.denom > 0).sum()) > INIT // 2
    assert t_opt.step == int(j_opt.step) == 1
    for f in G.PARAM_FIELDS:
        _close(getattr(t_state1.params, f).numpy(),
               getattr(j_state1.params, f), f)
        _close(getattr(t_opt.mu, f).numpy(), getattr(j_opt.mu, f),
               f"mu {f}")
        _close(getattr(t_opt.nu, f).numpy(), getattr(j_opt.nu, f),
               f"nu {f}")
    for name in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(t_state1, name).numpy(),
                                   np.asarray(getattr(j_state1, name)),
                                   rtol=2e-4, atol=1e-7, err_msg=name)


def test_train_matches_jax(scene_dir, monkeypatch, capsys):
    oc = dict(iterations=STEPS, densify_from_iter=STEPS + 100)
    j_losses = []
    real = JS.make_train_step

    def recording(*args):
        step = real(*args)

        def run(*a):
            out = step(*a)
            j_losses.append(out[2])
            return out
        return run

    monkeypatch.setattr(JS, "make_train_step", recording)
    j_state, _, j_res = JS.train(
        JModelConfig(source_path=scene_dir, init_num=INIT, capacity=CAP,
                     max_per_tile=K, approx_topk=False), JOptConfig(**oc))
    t_state, t_opt, t_res = TS.train(
        ModelConfig(source_path=scene_dir, init_num=INIT, capacity=CAP,
                    max_per_tile=K), OptimizationConfig(**oc),
        device="cpu")
    capsys.readouterr()

    j_losses = [float(x) for x in j_losses]
    assert len(t_res["losses"]) == len(j_losses) == STEPS
    np.testing.assert_allclose(t_res["losses"], j_losses, rtol=LOSS_RTOL)
    np.testing.assert_array_equal(t_state.alive.numpy(),
                                  np.asarray(j_state.alive))
    assert t_res["num_points"] == j_res["num_points"] == INIT
    assert t_res["train_psnr"] == pytest.approx(j_res["train_psnr"],
                                                abs=0.05)
    assert t_res["final_loss"] == pytest.approx(j_res["final_loss"],
                                                rel=LOSS_RTOL)
    assert t_res["initial_loss"] == pytest.approx(np.mean(t_res["losses"]))
    assert t_opt.step == STEPS and t_res["sh_degree"] == 0
    # on the CPU the plain versions run: no kernel launches
    assert set(t_res["kernel_launches"].values()) == {0}


def test_main_writes_cfg_and_ply(scene_dir, tmp_path, capsys):
    run = str(tmp_path / "run")
    state, _, res = TS.main([
        "--source_path", scene_dir, "--model_path", run, "--iterations", "4",
        "--init_num", str(INIT), "--capacity", str(CAP), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "'final_loss'" in printed and "'losses'" not in printed
    with open(os.path.join(run, "cfg_args.json")) as f:
        assert json.load(f)["init_num"] == INIT
    ply = j_load_ply(os.path.join(run, "point_cloud.ply"), CAP,
                     state.max_sh_degree)
    alive = state.alive.numpy()
    n = int(alive.sum())
    assert n == res["num_points"] and int(ply.num_alive()) == n
    for f in G.PARAM_FIELDS:
        if f == "identity":           # not in the PLY layout
            continue
        np.testing.assert_array_equal(
            np.asarray(getattr(ply.params, f))[:n],
            getattr(state.params, f).numpy()[alive], err_msg=f)
