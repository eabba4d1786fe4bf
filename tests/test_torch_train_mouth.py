"""The port's mouth adaptation (``instag_torch/train/mouth.py``) against the
JAX package's ``train/mouth.py``: the AU25 curriculum, the softening of
greenish splats, one mouth step, and a short ``train_mouth`` loop.

The step runs at 64x64 (300 live mouth splats in a capacity of 512, K=64,
under a frozen 300-splat face cloud and face UMF), as tests/test_torch_face
runs the face step. The loop runs on a generated scene (8 frames at 80x80,
200 initial mouth splats in a capacity of 1024, K=256 so that no tile is
cut) for 15 steps with a densification interval of 5 from step 2: three
blocks, a log point at each, the regularisers on from ``warm_step`` 7 and
the curriculum's windows at steps 10 and 15. The loop turns the PMF's
align on only after step 1000 (so the step test holds it on), and
densifies only before ``iterations - 1000`` (tests/test_torch_densify.py
holds densification). Both sides get the same frames, the JAX loop's own
starting nets and the same seed.

Tolerances: the curriculum and the softening masks equal, the softened
fields within rtol 1e-6; the step's loss within rtol 1e-5, its
gradients as tests/test_torch_face.py holds them; the loop's per-step
losses within rtol 1e-3 (see tests/test_torch_train_face.py) and its final
alive mask equal.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import instag_tpu.train.common as j_common
from instag_tpu.bench_utils import synthetic_state as j_state
from instag_tpu.config import ModelConfig as JModelConfig
from instag_tpu.config import OptimizationConfig as JOptConfig
from instag_tpu.data.synthetic import generate_scene
from instag_tpu.models import gaussians as JG
from instag_tpu.models import motion as JM
from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
from instag_tpu.train import mouth as JMo
from instag_tpu.train.optim import pmf_optimizer as j_pmf_opt
from instag_tpu.train.optim import umf_optimizer as j_umf_opt
from instag_torch.config import ModelConfig, OptimizationConfig
from instag_torch.io.from_jax import (frame_batch, frame_meta,
                                      load_motion_net, motion_state_dict,
                                      state_from_jax)
from instag_torch.models import gaussians as G
from instag_torch.models import motion as TM
from instag_torch.ops.rasterize import RasterizeConfig
from instag_torch.train import mouth as TMo
from instag_torch.train.common import FrameMeta
from tests.test_torch_face import B1, FIELDS, K, SIZE, _adam_mu, _close, _scene
from tests.test_torch_motion import flax_tree
from tests.torch_cpu import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-3


@pytest.mark.parametrize("select_interval", [5, 7])
def test_sample_mouth_curriculum_matches_jax_draw_for_draw(select_interval):
    """300 steps across warm_step 150 (the p75 gate, then the sliding
    window), on AU25 values with ties and frames under 20 mouth pixels."""
    rng = np.random.default_rng(select_interval)
    au25, pcts = FrameMeta.au25_stats(np.round(rng.uniform(0, 3, 16), 1))
    px = rng.integers(5, 60, 16)
    r_j, r_t = np.random.default_rng(1), np.random.default_rng(1)
    s_j, s_t = [], []
    picks = [(JMo.sample_mouth_curriculum(
                  r_j, [float(a) for a in au25], pcts, [int(p) for p in px],
                  s_j, it, 150, 300, select_interval),
              TMo.sample_mouth_curriculum(r_t, au25, pcts, px, s_t, it, 150,
                                          300, select_interval))
             for it in range(1, 301)]
    assert all(a == b for a, b in picks)
    assert s_j == s_t and r_j.integers(1 << 30) == r_t.integers(1 << 30)
    assert all(px[a] >= 20 for a, _ in picks)
    assert len({a for a, _ in picks}) > 4


def test_soften_green_matches_jax():
    state = j_state(400, 512, seed=3, max_sh_degree=2, spread=0.3)
    rng = np.random.default_rng(4)
    rgb = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    rgb[::7] = (0.2, 0.9, 0.1)                     # greenish
    dc = ((rgb - 0.5) / 0.28209479177387814)[:, None, :]
    rest = rng.normal(0, 0.02, (512, 8, 3)).astype(np.float32)
    state = state.replace(
        params=state.params.replace(features_dc=jnp.asarray(dc),
                                    features_rest=jnp.asarray(rest)),
        xyz_grad_accum=jnp.asarray(rng.uniform(0, 1, 512), jnp.float32))
    campos = np.array([0.1, -0.2, 3.3], np.float32)
    t_out = TMo._soften_green(state_from_jax(state, device="cpu"),
                              torch.from_numpy(campos))
    j_out = JMo._soften_green(state, jnp.asarray(campos))
    changed = t_out.params.opacity[:, 0] != torch.from_numpy(
        np.array(state.params.opacity))[:, 0]
    j_changed = np.asarray(j_out.params.opacity)[:, 0] != np.asarray(
        state.params.opacity)[:, 0]
    np.testing.assert_array_equal(changed.numpy(), j_changed)
    assert 30 < int(changed.sum()) < 400
    for name in ("opacity", "scaling"):
        np.testing.assert_allclose(
            getattr(t_out.params, name).numpy(),
            np.asarray(getattr(j_out.params, name)), rtol=1e-6)
    np.testing.assert_allclose(t_out.xyz_grad_accum.numpy(),
                               np.asarray(j_out.xyz_grad_accum), rtol=1e-6)


def _nets_and_params(seed):
    nets = [TM.MouthMotionNetwork(), TM.PersonalizedMotionNetwork("mouth"),
            TM.MotionNetwork()]
    return nets, [flax_tree(n, np.random.default_rng(seed + i))
                  for i, n in enumerate(nets)]


@pytest.fixture(scope="module")
def jax_mouth_block():
    """The JAX mouth block and its optimizers, built once: ``align`` is
    traced, so both cases of the step test run one compiled program."""
    _, params = _nets_and_params(60)
    cfg = JConfig(SIZE, SIZE, max_per_tile=K, tile_chunk=8,
                  approx_topk=False, backend="xla")
    umf_tx, _ = j_umf_opt(params[0])
    pmf_tx, _ = j_pmf_opt(params[1])
    block = JMo.make_mouth_block(cfg, JOptConfig(), JM.MouthMotionNetwork(),
                                 JM.PersonalizedMotionNetwork("mouth"),
                                 JM.MotionNetwork(), 1.0, umf_tx, pmf_tx)
    return block, umf_tx, pmf_tx


@pytest.mark.parametrize("align", [0.0, 1.0])
def test_mouth_step_matches_jax(jax_mouth_block, align):
    """One mouth step with the regularisers on, the PMF's align off (its
    ``p_xyz`` still feeds the regulariser) or on, at k = 20."""
    state, batch = _scene(has_priors=False)
    face = j_state(300, 512, seed=4, spread=0.1, scale=0.02)
    nets, params = _nets_and_params(60)
    t_state = state_from_jax(state, device="cpu")
    t_face = state_from_jax(face, device="cpu")

    block, umf_tx, pmf_tx = jax_mouth_block
    umf_opt = jax.jit(umf_tx.init)(params[0])
    pmf_opt = jax.jit(pmf_tx.init)(params[1])
    flags = JMo.MouthFlags(align=jnp.full((1,), align),
                           use_regs=jnp.ones((1,)), valid=jnp.ones((1,)))
    (j_state1, j_gopt, _, j_umf_state, _, j_pmf_state,
     j_losses) = jax.device_get(block(
         state, JG.adam_init(state.params), params[0], umf_opt, params[1],
         pmf_opt, face, params[2], batch, jnp.zeros((1, 1), jnp.int32),
         jnp.ones((1,), jnp.int32), jnp.full((1,), 20, jnp.int32), flags))

    t_batch = frame_batch({k: (None if v is None else np.asarray(v))
                           for k, v in vars(batch).items()}, device="cpu")
    umf, pmf, face_umf = (load_motion_net(n, p, device="cpu")
                          for n, p in zip(nets, params))
    step = TMo.make_mouth_step(RasterizeConfig(SIZE, SIZE, max_per_tile=K),
                               OptimizationConfig(), umf, pmf, t_face,
                               face_umf, 1.0, device="cpu")
    t_state1, t_gopt, loss = step(
        t_state, G.adam_init(t_state.params), t_batch, 0, 1, 20,
        TMo.MouthFlags(align=align, use_regs=1.0))

    np.testing.assert_allclose(float(loss), float(j_losses[0]), rtol=1e-5)
    assert int((t_state1.denom > 0).sum()) > 50
    for f in FIELDS:
        _close(getattr(t_gopt.mu, f) / (1 - B1),
               np.asarray(getattr(j_gopt.mu, f)) / (1 - B1), f)
    for name in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(t_state1, name).numpy(),
                                   np.asarray(getattr(j_state1, name)),
                                   rtol=2e-4, atol=1e-7, err_msg=name)
    # the PMF's audio_att adds its L2 decay 1e-4 p to the gradient before
    # Adam (see tests/test_torch_face.py)
    for net, p0, opt_state in ((umf, params[0], j_umf_state),
                               (pmf, params[1], j_pmf_state)):
        ref = motion_state_dict(_adam_mu(opt_state))
        start = motion_state_dict(p0)
        grads = {n: p.grad for n, p in net.named_parameters()}
        assert set(ref) == set(grads)
        for n, g in grads.items():
            if net is pmf and "audio_att_net" in n:
                g = g + 1e-4 * start[n]
            _close(g.numpy(), ref[n].numpy() / (1 - B1), n)
    # the frozen face UMF takes no gradient
    assert all(p.grad is None for p in face_umf.parameters())


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mouth_loop_scene"))
    generate_scene(path, n_frames=8, size=80)
    return path


def test_train_mouth_matches_jax(scene_dir, monkeypatch, capsys):
    iterations, warm_step, seed = 15, 7, 0
    oc = dict(iterations=iterations, densify_from_iter=2,
              densification_interval=5)
    records = j_common.load_training_frames(
        JModelConfig(source_path=scene_dir))
    monkeypatch.setattr(j_common, "load_training_frames",
                        lambda model_cfg: records)
    j_batch = j_common.build_frame_batch(records)

    # a face bundle built directly (a trained one is not needed: the mouth
    # reads the face cloud and UMF only through the move feature)
    face = j_state(300, 512, seed=5, spread=0.1, scale=0.02)
    face_umf_params = flax_tree(TM.MotionNetwork(),
                                np.random.default_rng(70))
    # the JAX loop's own starting mouth nets
    k1, k2, _ = jax.random.split(jax.random.key(seed), 3)
    x0, a0 = jnp.zeros((8, 3)), j_batch.auds[0]
    umf_params = jax.jit(JM.MouthMotionNetwork().init)(k1, x0, a0,
                                                        jnp.zeros((1, 3)))
    pmf_params = jax.jit(JM.PersonalizedMotionNetwork("mouth").init)(k2, x0,
                                                                     a0)
    t_face = dict(state=state_from_jax(face, device="cpu"),
                  umf_net=load_motion_net(TM.MotionNetwork(),
                                          face_umf_params, device="cpu"))
    umf = load_motion_net(TM.MouthMotionNetwork(),
                          jax.device_get(umf_params), device="cpu")
    pmf = load_motion_net(TM.PersonalizedMotionNetwork("mouth"),
                          jax.device_get(pmf_params), device="cpu")
    t_batch = frame_batch({k: None if v is None else np.asarray(v)
                           for k, v in vars(j_batch).items()}, device="cpu")

    model = dict(init_num=200, capacity=1024, max_per_tile=256)
    ref = JMo.train_mouth(
        JModelConfig(source_path=scene_dir, approx_topk=False, **model),
        JOptConfig(**oc), dict(state=face, umf_params=face_umf_params),
        log_every=5, warm_step=warm_step, seed=seed)
    j_log = capsys.readouterr().out
    res = TMo.train_mouth(
        ModelConfig(**model), OptimizationConfig(**oc), t_batch,
        frame_meta(records), t_face, umf_net=umf, pmf_net=pmf, log_every=5,
        warm_step=warm_step, seed=seed, device="cpu")
    t_log = capsys.readouterr().out

    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(res["state"].alive.numpy(),
                                  np.asarray(ref["state"].alive))
    assert res["state"].capacity == ref["state"].capacity == 1024
    assert res["state"].max_sh_degree == ref["state"].max_sh_degree == 2
    assert res["gopt"].step == iterations
    assert res["extent"] == pytest.approx(ref["extent"], rel=1e-6)
    np.testing.assert_allclose(res["state"].denom.numpy(),
                               np.asarray(ref["state"].denom))

    def counts(log):
        return re.findall(r"\[mouth (\d+)/15\] loss=\S+ pts=(\d+)", log)
    assert counts(t_log) == counts(j_log) and len(counts(t_log)) == 3


def test_train_mouth_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMo.train_mouth(ModelConfig(), OptimizationConfig(), None, None, {})
