"""The port's frame data parallelism (``--data_parallel``) against the JAX
package's ``dp=B`` blocks, at the sizes of ``tests/test_parallel.py``'s
``_dp_fixture``: 4 frames at 32x32 (``synthetic_frame_batch``), 64 splats
in 128 slots, exact selection and K=64 (no tile cut) on both sides, and
random nets (``tests/test_torch_face.py``'s ``flax_tree``: at flax's
initialisation the UMF's audio-attention gradients are rounding noise).
The face cloud is ``synthetic_state(64, 128, spread=1.0, scale=0.03)``
with anisotropic scales (an isotropic splat's rotation gradient is
rounding noise). On the fixture's own clustered cloud
(``random_init_points(64)``) the serial one-frame step already differs
from JAX on three splats by up to 3 % of the largest gradient (the loss
within 1e-6), a rounding edge of the serial step that every dp step would
inherit.

  * one dp=4 face step (``make_dp_face_step``, frames 0-3): loss within
    rtol 1e-5 of JAX's ``make_face_block(dp=4)``; the Gaussian, UMF and
    PMF gradients, read from the first Adam moments as
    ``tests/test_torch_face.py`` reads them, within its tolerances; the
    statistics within rtol 2e-4 with ``denom`` equal (JAX's
    ``test_dp_face_step_matches_serial`` tolerances);
  * the same step on 2 gloo ranks (one spawn for the file, joined under
    its own time limit) against the single process: loss, gradients and
    statistics within rtol 1e-6 of their scale, the updated Gaussian
    parameters and nets bit-identical on both ranks; in the same spawn
    ``cli.train_face --data_parallel 2`` on the 2 ranks (rank 0 alone
    writes the bundle) and ``--data_parallel 3`` refused;
  * dp=2 mouth and fusion steps against JAX's ``dp=2`` blocks;
  * ``train_face(data_parallel=2)`` for 10 steps on an 8-frame 32x32
    scene against JAX's: the frame draws equal, draw for draw, and the
    losses within rtol 1e-3 (``tests/test_torch_train_face.py``'s
    tolerance); ``cli.train_face --data_parallel 2`` in one process.

JAX is imported inside the fixtures, so that the spawned ranks, which
import this module, start without it.
"""

import json

import numpy as np
import pytest
import torch

from instag_torch.cli import train_face as face_cli
from instag_torch.config import OptimizationConfig
from instag_torch.io.checkpoints import load_bundle
from instag_torch.io.from_jax import (frame_batch, load_motion_net,
                                      state_from_jax)
from instag_torch.models import gaussians as G
from instag_torch.models import motion as TM
from instag_torch.ops.rasterize import RasterizeConfig
from instag_torch.parallel.comm import check_replicas
from instag_torch.parallel.data_parallel import dp_flags, make_dp_face_step
from instag_torch.parallel.launch import start
from instag_torch.train.common import replica_tensors
from tests.torch_cpu import one_torch_thread  # noqa: F401

SIZE, K, B1 = 32, 64, 0.9
SPAWN_TIMEOUT = 240.0
CLI = ["--init_num", "64", "--capacity", "128", "--max_per_tile", "64",
       "--iterations", "4", "--densification_interval", "2",
       "--device", "cpu"]


def _close(ours, ref, name, atol_frac=5e-4, rtol=2e-3):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert np.isfinite(ours).all(), name
    scale = max(1e-12, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, atol=atol_frac * scale, rtol=rtol,
                               err_msg=name)


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from instag_tpu.data.synthetic import generate_scene
    path = str(tmp_path_factory.mktemp("dp_scene") / "scene")
    generate_scene(path, n_frames=8, size=SIZE, n_val=2)
    return path


@pytest.fixture(scope="module")
def dp_case(scene, tmp_path_factory):
    """The JAX inputs and the port's (picklable for the spawned ranks);
    starts the file's 2 ranks, which run while the JAX references
    compute, and joins them at the end of the module."""
    import jax.numpy as jnp
    from instag_tpu.bench_utils import synthetic_frame_batch, synthetic_state
    from instag_tpu.config import OptimizationConfig as JOptConfig
    from tests.test_torch_motion import flax_tree

    oc, extent = JOptConfig(position_lr_max_steps=100), 1.0
    batch = synthetic_frame_batch(SIZE, n_frames=4, seed=1)
    # random nets as tests/test_torch_face.py's: at flax's initialisation
    # the UMF's audio attention gradients are rounding noise (~1e-12)
    umf_params, pmf_params = (
        flax_tree(n, np.random.default_rng(30 + i)) for i, n in enumerate(
            (TM.MotionNetwork(), TM.PersonalizedMotionNetwork("face"))))
    state = synthetic_state(64, 128, seed=0, spread=1.0, scale=0.03)
    # anisotropic, as a trained cloud's: an isotropic splat's rotation
    # gradient is rounding noise
    aniso = np.random.default_rng(7).normal(0.0, 0.4, (128, 3))
    state = state.replace(params=state.params.replace(
        scaling=state.params.scaling + jnp.asarray(aniso, jnp.float32)))
    inputs = dict(state=state_from_jax(state, device="cpu"),
                  batch={k: None if v is None else np.asarray(v)
                         for k, v in vars(batch).items()},
                  umf=_np(umf_params), pmf=_np(pmf_params),
                  extent=float(extent))
    run_dir = str(tmp_path_factory.mktemp("dp_cli") / "run")
    ranks = start(_rank_work, 2, (inputs, scene, run_dir), device="cpu",
                  timeout=SPAWN_TIMEOUT)
    yield dict(inputs=inputs, ranks=ranks, run_dir=run_dir, fixture=(
        oc, extent, batch, state, umf_params, pmf_params))
    ranks.join()


@pytest.fixture(scope="module")
def dp_ref(dp_case):
    """JAX's dp=4 face step on frames 0-3."""
    import jax
    import jax.numpy as jnp
    from instag_tpu.models import gaussians as JG
    from instag_tpu.models import motion as JM
    from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
    from instag_tpu.parallel.data_parallel import dp_flags as j_dp_flags
    from instag_tpu.train.face import make_face_block
    from instag_tpu.train.optim import pmf_optimizer, umf_optimizer

    oc, extent, batch, state, umf_params, pmf_params = dp_case["fixture"]
    umf_tx, umf_opt = umf_optimizer(umf_params, total_iters=100, warm_step=0)
    pmf_tx, pmf_opt = pmf_optimizer(pmf_params)
    cfg = JConfig(SIZE, SIZE, max_per_tile=K, tile_chunk=4,
                  approx_topk=False, backend="xla")
    blk = make_face_block(cfg, oc, JM.MotionNetwork(),
                          JM.PersonalizedMotionNetwork("face"), extent,
                          False, umf_tx, pmf_tx, dp=4)
    flags = jax.tree.map(lambda x: jnp.asarray(x)[None],
                         j_dp_flags(1, warm_step=0))
    copy = lambda t: jax.tree.map(jnp.array, t)        # noqa: E731
    return _np(blk(copy(state), JG.adam_init(state.params), copy(umf_params),
                   umf_opt, copy(pmf_params), pmf_opt, batch,
                   jnp.asarray([[0, 1, 2, 3]], jnp.int32),
                   jnp.ones((1,), jnp.int32), flags,
                   jnp.zeros((1,), jnp.int32), {}))


def _dp_face_step(inputs, group=None):
    """One dp=4 face step of the port on frames 0-3 (this rank's share);
    returns what the checks read."""
    state = inputs["state"]
    batch = frame_batch(inputs["batch"], device="cpu")
    umf = load_motion_net(TM.MotionNetwork(), inputs["umf"], device="cpu")
    pmf = load_motion_net(TM.PersonalizedMotionNetwork("face"),
                          inputs["pmf"], device="cpu")
    step = make_dp_face_step(
        RasterizeConfig(SIZE, SIZE, max_per_tile=K),
        OptimizationConfig(position_lr_max_steps=100), umf, pmf,
        inputs["extent"], 4, group, device="cpu")
    state1, gopt, loss = step(state, G.adam_init(state.params), batch,
                              [0, 1, 2, 3], 1, dp_flags(1, warm_step=0))
    check_replicas(replica_tensors(state1, umf=umf, pmf=pmf), group)
    return dict(
        loss=float(loss),
        mu={f: getattr(gopt.mu, f).numpy() / (1 - B1) for f in G.PARAM_FIELDS},
        nets={f"{t}.{n}": p.grad.numpy() for t, net in (("umf", umf),
                                                        ("pmf", pmf))
              for n, p in net.named_parameters()},
        stats={k: getattr(state1, k).numpy() for k in (
            "xyz_grad_accum", "denom", "max_radii2d")},
        params={f: getattr(state1.params, f).numpy() for f in G.PARAM_FIELDS},
        net_params={f"{t}.{n}": p.detach().numpy().copy()
                    for t, net in (("umf", umf), ("pmf", pmf))
                    for n, p in net.named_parameters()})


def _rank_work(rank, group, dev, inputs, scene, run_dir):
    """The spawned ranks' share: the dp=4 step, the CLI refusal and a CLI
    run of ``--data_parallel 2`` on the 2 ranks."""
    torch.set_num_threads(1)
    out = _dp_face_step(inputs, group)
    try:
        face_cli.main(["-s", scene, "-m", run_dir + "_refused",
                       "--data_parallel", "3", *CLI])
        out["refusal"] = None
    except SystemExit as e:
        out["refusal"] = str(e)
    res = face_cli.main(["-s", scene, "-m", run_dir, "--data_parallel", "2",
                         *CLI])
    out["cli_losses"] = res["losses"]
    return out


@pytest.fixture(scope="module")
def two_ranks(dp_case):
    return dp_case["ranks"].join(), dp_case["run_dir"]


def test_dp4_face_step_matches_jax(dp_case, dp_ref):
    from tests.test_torch_face import _adam_mu
    from instag_torch.io.from_jax import motion_state_dict
    ref = dp_ref
    ours = _dp_face_step(dp_case["inputs"])
    np.testing.assert_allclose(ours["loss"], float(ref[-1][0]), rtol=1e-5)
    for f in G.PARAM_FIELDS:
        _close(ours["mu"][f], getattr(ref[1].mu, f) / (1 - B1), f)
    np.testing.assert_allclose(ours["stats"]["xyz_grad_accum"],
                               ref[0].xyz_grad_accum, rtol=2e-4, atol=1e-7)
    np.testing.assert_array_equal(ours["stats"]["denom"], ref[0].denom)
    np.testing.assert_array_equal(ours["stats"]["max_radii2d"],
                                  ref[0].max_radii2d)
    assert ours["stats"]["denom"].max() > 1         # several frames added
    start = motion_state_dict(dp_case["inputs"]["pmf"])
    for tag, opt in (("umf", ref[3]), ("pmf", ref[5])):
        mu = motion_state_dict(_adam_mu(opt))
        for n, g in mu.items():
            ours_g = ours["nets"][f"{tag}.{n}"]
            if tag == "pmf" and "audio_att_net" in n:
                ours_g = ours_g + 1e-4 * start[n].numpy()
            _close(ours_g, g.numpy() / (1 - B1), f"{tag}.{n}")


def test_cli_data_parallel_in_one_process(scene, tmp_path):
    res = face_cli.main(["-s", scene, "-m", str(tmp_path / "run"),
                         "--data_parallel", "2", *CLI])
    assert len(res["losses"]) == 4 and np.isfinite(res["losses"]).all()
    assert float(res["state"].denom.max()) > 0
    cfg = json.loads((tmp_path / "run" / "cfg_args.json").read_text())
    assert cfg["init_num"] == 64


def _mouth_fuse_nets(fixture):
    """A mouth cloud of 48 splats in 128 slots (anisotropic, as the face
    cloud) and random mouth nets."""
    import jax.numpy as jnp
    from instag_tpu.bench_utils import synthetic_state
    from tests.test_torch_motion import flax_tree
    mouth_state = synthetic_state(48, 128, seed=3, spread=0.5, scale=0.03)
    aniso = np.random.default_rng(8).normal(0.0, 0.4, (128, 3))
    mouth_state = mouth_state.replace(params=mouth_state.params.replace(
        scaling=mouth_state.params.scaling + jnp.asarray(aniso,
                                                         jnp.float32)))
    m_umf, m_pmf = (flax_tree(n, np.random.default_rng(40 + i))
                    for i, n in enumerate((TM.MouthMotionNetwork(),
                                           TM.PersonalizedMotionNetwork(
                                               "mouth"))))
    return mouth_state, m_umf, m_pmf


def test_dp2_mouth_step_matches_jax(dp_case):
    import jax
    import jax.numpy as jnp
    from instag_tpu.models import gaussians as JG
    from instag_tpu.models.motion import (MotionNetwork, MouthMotionNetwork,
                                          PersonalizedMotionNetwork)
    from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
    from instag_tpu.train.mouth import MouthFlags, make_mouth_block
    from instag_tpu.train.optim import pmf_optimizer, umf_optimizer
    from instag_torch.train.mouth import MouthFlags as TFlags
    from instag_torch.train.mouth import make_mouth_step

    oc, extent, batch, face_state, face_umf, _ = dp_case["fixture"]
    mouth_state, m_umf, m_pmf = _mouth_fuse_nets(dp_case["fixture"])
    umf_tx, umf_opt = umf_optimizer(m_umf, total_iters=100, warm_step=0)
    pmf_tx, pmf_opt = pmf_optimizer(m_pmf)
    cfg = JConfig(SIZE, SIZE, max_per_tile=K, tile_chunk=4,
                  approx_topk=False, backend="xla")
    blk = make_mouth_block(cfg, oc, MouthMotionNetwork("deepspeech"),
                           PersonalizedMotionNetwork("mouth", "deepspeech"),
                           MotionNetwork("deepspeech"), extent, umf_tx,
                           pmf_tx, dp=2)
    one = jnp.ones((1,), jnp.float32)
    copy = lambda t: jax.tree.map(jnp.array, t)        # noqa: E731
    ref = _np(blk(copy(mouth_state), JG.adam_init(mouth_state.params),
                  copy(m_umf), umf_opt, copy(m_pmf), pmf_opt, face_state,
                  face_umf, batch, jnp.asarray([[1, 3]], jnp.int32),
                  jnp.ones((1,), jnp.int32), jnp.full((1,), 20, jnp.int32),
                  MouthFlags(align=one, use_regs=one, valid=one)))

    t_mouth = state_from_jax(mouth_state, device="cpu")
    t_face = state_from_jax(face_state, device="cpu")
    t_batch = frame_batch({k: None if v is None else np.asarray(v)
                           for k, v in vars(batch).items()}, device="cpu")
    step = make_mouth_step(
        RasterizeConfig(SIZE, SIZE, max_per_tile=K),
        OptimizationConfig(position_lr_max_steps=100),
        load_motion_net(TM.MouthMotionNetwork(), _np(m_umf), "cpu"),
        load_motion_net(TM.PersonalizedMotionNetwork("mouth"), _np(m_pmf),
                        "cpu"), t_face,
        load_motion_net(TM.MotionNetwork(), _np(face_umf), "cpu"), extent,
        "cpu", total_iters=100, warm_step=0, dp=2)
    st, gopt, loss = step(t_mouth, G.adam_init(t_mouth.params), t_batch,
                          [1, 3], 1, 20, TFlags(align=1.0, use_regs=1.0))
    np.testing.assert_allclose(float(loss), float(ref[-1][0]), rtol=1e-5)
    for f in G.PARAM_FIELDS:
        _close(getattr(gopt.mu, f).numpy(), getattr(ref[1].mu, f), f)
    np.testing.assert_allclose(st.xyz_grad_accum.numpy(),
                               ref[0].xyz_grad_accum, rtol=2e-4, atol=1e-7)
    np.testing.assert_array_equal(st.denom.numpy(), ref[0].denom)
    assert st.denom.max() == 2


def test_dp2_fuse_step_matches_jax(dp_case):
    import jax
    import jax.numpy as jnp
    from instag_tpu.models import gaussians as JG
    from instag_tpu.models.motion import (MotionNetwork, MouthMotionNetwork,
                                          PersonalizedMotionNetwork)
    from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
    from instag_tpu.train.fuse import make_fuse_block
    from instag_torch.train.fuse import make_fuse_step

    oc, extent, batch, face_state, face_umf, face_pmf = dp_case["fixture"]
    mouth_state, m_umf, m_pmf = _mouth_fuse_nets(dp_case["fixture"])
    cfg = JConfig(SIZE, SIZE, max_per_tile=K, tile_chunk=4,
                  approx_topk=False, backend="xla")
    blk = make_fuse_block(cfg, oc, MotionNetwork("deepspeech"),
                          MouthMotionNetwork("deepspeech"),
                          PersonalizedMotionNetwork("face", "deepspeech"),
                          PersonalizedMotionNetwork("mouth", "deepspeech"),
                          extent, dp=2)
    copy = lambda t: jax.tree.map(jnp.array, t)        # noqa: E731
    ref = _np(blk(copy(face_state), JG.adam_init(face_state.params),
                  copy(mouth_state), JG.adam_init(mouth_state.params),
                  face_umf, m_umf, face_pmf, m_pmf, batch,
                  jnp.asarray([[0, 2]], jnp.int32), jnp.ones((1,), jnp.int32),
                  jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.float32),
                  jnp.ones((1,), jnp.float32), {}))

    t_face = state_from_jax(face_state, device="cpu")
    t_mouth = state_from_jax(mouth_state, device="cpu")
    t_batch = frame_batch({k: None if v is None else np.asarray(v)
                           for k, v in vars(batch).items()}, device="cpu")
    step = make_fuse_step(
        RasterizeConfig(SIZE, SIZE, max_per_tile=K),
        OptimizationConfig(position_lr_max_steps=100),
        load_motion_net(TM.MotionNetwork(), _np(face_umf), "cpu"),
        load_motion_net(TM.MouthMotionNetwork(), _np(m_umf), "cpu"),
        load_motion_net(TM.PersonalizedMotionNetwork("face"), _np(face_pmf),
                        "cpu"),
        load_motion_net(TM.PersonalizedMotionNetwork("mouth"), _np(m_pmf),
                        "cpu"), extent, "cpu", dp=2)
    _, fg, _, mg, loss = step(t_face, G.adam_init(t_face.params), t_mouth,
                              G.adam_init(t_mouth.params), t_batch, [0, 2],
                              1, 0, 0.0)
    np.testing.assert_allclose(float(loss), float(ref[-1][0]), rtol=1e-5)
    for f in ("features_dc", "features_rest", "identity", "opacity"):
        _close(getattr(fg.mu, f).numpy(), getattr(ref[1].mu, f), f"face {f}")
    for f in ("features_dc", "features_rest", "identity"):
        _close(getattr(mg.mu, f).numpy(), getattr(ref[3].mu, f),
               f"mouth {f}")


def test_train_face_data_parallel_matches_jax(scene, monkeypatch, capsys):
    import jax
    import jax.numpy as jnp
    import instag_tpu.train.common as j_common
    from instag_tpu.config import ModelConfig as JModelConfig
    from instag_tpu.config import OptimizationConfig as JOptConfig
    from instag_tpu.models import motion as JM
    from instag_tpu.train import face as JF
    from instag_torch.config import ModelConfig
    from instag_torch.io.from_jax import frame_meta
    from instag_torch.train import face as TF

    iterations, warm_step, seed = 10, 4, 0
    oc = dict(iterations=iterations, densify_from_iter=2,
              densification_interval=5)
    records = j_common.load_training_frames(JModelConfig(source_path=scene))
    monkeypatch.setattr(j_common, "load_training_frames",
                        lambda model_cfg: records)
    j_batch = j_common.build_frame_batch(records)
    k1, k2, _ = jax.random.split(jax.random.key(seed), 3)
    x0 = jnp.zeros((8, 3))
    umf_params, pmf_params = (
        jax.jit(net.init)(k, x0, j_batch.auds[0], j_batch.au_exp[0])
        for net, k in ((JM.MotionNetwork(), k1),
                       (JM.PersonalizedMotionNetwork("face"), k2)))
    umf = load_motion_net(TM.MotionNetwork(), _np(umf_params), "cpu")
    pmf = load_motion_net(TM.PersonalizedMotionNetwork("face"),
                          _np(pmf_params), "cpu")
    t_batch = frame_batch({k: None if v is None else np.asarray(v)
                           for k, v in vars(j_batch).items()}, device="cpu")

    draws = {"jax": [], "port": []}

    def recording(mod, tag):
        fn = mod.sample_frame_curriculum

        def wrapped(*a, **kw):
            i = fn(*a, **kw)
            draws[tag].append(i)
            return i
        monkeypatch.setattr(mod, "sample_frame_curriculum", wrapped)
    recording(JF, "jax")
    recording(TF, "port")

    ref = JF.train_face(
        JModelConfig(source_path=scene, init_num=64, capacity=128,
                     max_per_tile=K, approx_topk=False),
        JOptConfig(**oc), log_every=5, warm_step=warm_step, seed=seed,
        lpips_enabled=False, data_parallel=2)
    res = TF.train_face(
        ModelConfig(init_num=64, capacity=128, max_per_tile=K),
        OptimizationConfig(**oc), t_batch, frame_meta(records), umf_net=umf,
        pmf_net=pmf, log_every=5, warm_step=warm_step, seed=seed,
        lpips_enabled=False, device="cpu", data_parallel=2)
    capsys.readouterr()
    assert len(draws["port"]) == 2 * iterations
    assert draws["port"] == draws["jax"]
    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=1e-3)
    np.testing.assert_array_equal(res["state"].alive.numpy(),
                                  np.asarray(ref["state"].alive))
    assert res["gopt"].step == iterations


def test_dp4_face_step_on_two_ranks(dp_case, two_ranks):
    outs, _ = two_ranks
    one = _dp_face_step(dp_case["inputs"])
    for o in outs:
        np.testing.assert_allclose(o["loss"], one["loss"], rtol=1e-6)
        for group in ("mu", "nets", "stats"):
            for k, v in one[group].items():
                _close(o[group][k], v, k, atol_frac=1e-6, rtol=1e-6)
    for group in ("params", "net_params", "stats"):
        for k in outs[0][group]:
            np.testing.assert_array_equal(outs[0][group][k],
                                          outs[1][group][k], err_msg=k)


def test_cli_data_parallel_on_two_ranks(two_ranks):
    outs, run_dir = two_ranks
    for o in outs:
        assert "the 2 ranks must divide" in o["refusal"]
        assert len(o["cli_losses"]) == 4
        assert np.isfinite(o["cli_losses"]).all()
    assert outs[0]["cli_losses"] == outs[1]["cli_losses"]
    b = load_bundle(run_dir + "/chkpnt_face_latest.pkl")
    assert b["iteration"] == 4
