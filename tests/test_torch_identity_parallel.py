"""The port's identity-parallel pre-training
(``instag_torch/parallel/identity_parallel.py``) on 2 gloo ranks, one
identity a rank (one spawn for the file, under its own time limit),
against the JAX package's identity-parallel steps (2 virtual CPU devices)
and the port's serial steps, at ``tests/test_parallel.py``'s
``_idp_fixture`` sizes: 4 frames of 32x32 an identity
(``synthetic_frame_batch``), 64 splats an identity, here in front of
``tests/test_torch_pretrain_face.py``'s backdrop of 64 wide splats (128
slots; over flat background green the SSIM is float32 noise that XLA and
PyTorch round differently), random nets (``flax_tree``):

  * the face and mouth step losses of both identities within rtol 2e-4,
    atol 2e-5 of JAX's idp steps and of the port's serial steps (JAX's
    ``test_identity_parallel_loss_matches_serial``);
  * the UMF and its EMA after each step bit-identical on both ranks;
  * ``make_idp_densify`` equal, bit for bit, to the serial densify of each
    identity on the same generator's draws;
  * ``pretrain_face(identity_parallel=True)`` over two generated scenes:
    every rank returns every identity's cloud, the same on both;
  * fewer ranks than identities refused with JAX's message.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from instag_torch.config import ModelConfig, OptimizationConfig
from instag_torch.data.synthetic import generate_scene
from instag_torch.io.from_jax import (frame_batch, load_motion_net,
                                      state_from_jax)
from instag_torch.models import gaussians as G
from instag_torch.models import motion as TM
from instag_torch.ops.rasterize import RasterizeConfig
from instag_torch.parallel.identity_parallel import (
    make_idp_densify, make_idp_pretrain_mouth_step, make_idp_pretrain_step)
from instag_torch.parallel.launch import start
from instag_torch.train import pretrain as TP
from tests.torch_cpu import one_torch_thread  # noqa: F401

SIZE, K, N_IDS = 32, 128, 2
IDS = ["id_a", "id_b"]
FLAGS = TP.PretrainFlags(use_regs=1.0, hair_paint=0.0)
DENSE = dict(densify_grad_threshold=1e-4, percent_dense=1.0)


def _nets(case, kind):
    """Fresh port nets: the UMF, one PMF an identity, the EMA."""
    import copy
    umf = load_motion_net(TM.MotionNetwork() if kind == "face"
                          else TM.MouthMotionNetwork(), case[kind]["umf"],
                          "cpu")
    pmfs = [load_motion_net(TM.PersonalizedMotionNetwork(kind), p, "cpu")
            for p in case[kind]["pmf"]]
    return umf, pmfs, copy.deepcopy(umf).requires_grad_(False)


def _face_step(case, umf, pmfs, ema):
    return TP.make_pretrain_face_step(
        RasterizeConfig(SIZE, SIZE, max_per_tile=K), OptimizationConfig(),
        umf, pmfs, ema, 1.0, 1, 60, device="cpu")


def _mouth_step(case, umf, pmfs, ema):
    face_net = load_motion_net(TM.MotionNetwork(), case["face"]["umf"],
                               "cpu")
    return TP.make_pretrain_mouth_step(
        RasterizeConfig(SIZE, SIZE, max_per_tile=K), OptimizationConfig(),
        umf, pmfs, ema, case["states"], face_net, 1.0, 1, 60, device="cpu")


def _replicas(motion):
    return {k: v.detach().clone() for k, v in
            TP.replica_tensors_of(motion).items()}


def _rank_work(rank, group, dev, case, root):
    torch.set_num_threads(1)
    out = {}
    state, batch = case["states"][rank], case["batches"][rank]
    motion = _face_step(case, *_nets(case, "face"))
    idp = make_idp_pretrain_step(motion, group)
    _, _, loss = idp(state, G.adam_init(state.params), batch, 0, 1, FLAGS)
    out["face_loss"], out["face_umf"] = float(loss), _replicas(motion)

    motion = _mouth_step(case, *_nets(case, "mouth"))
    idp = make_idp_pretrain_mouth_step(motion, group)
    _, _, loss = idp(state, G.adam_init(state.params), batch, 0, 1, FLAGS,
                     other=1 - rank)
    out["mouth_loss"], out["mouth_umf"] = float(loss), _replicas(motion)

    dense = make_idp_densify(dataclasses.replace(OptimizationConfig(),
                                                 **DENSE), 1.0, N_IDS, group)
    gen = torch.Generator().manual_seed(5)
    st, _ = dense(_hot(state), G.adam_init(state.params), gen, 0.005)
    out["densified"] = {k: getattr(st.params, k).numpy() for k in
                        G.PARAM_FIELDS}
    out["alive"] = st.alive.numpy()

    mc = ModelConfig(source_path=root, init_num=64, capacity=128,
                     max_per_tile=K)
    res = TP.pretrain_face(
        mc, OptimizationConfig(iterations=4, densification_interval=2),
        IDS, warm_per_id=3, log_every=2, seed=0, identity_parallel=True,
        group=group, device="cpu")
    out["loop"] = dict(losses=res["losses"], xyz=[
        s.params.xyz.numpy() for s in res["states"]],
        pmf=[{k: v.numpy() for k, v in p.state_dict().items()}
             for p in res["pmf_nets"]])
    return out


def _hot(state):
    """The state with its last 32 slots free and every live splat past the
    densification threshold."""
    alive = state.alive.clone()
    alive[-32:] = False
    return state.replace(alive=alive, xyz_grad_accum=torch.full_like(
        state.xyz_grad_accum, 10.0), denom=torch.ones_like(state.denom))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The identities' inputs (port objects and flax trees: picklable
    without JAX), the scenes of the loop; starts the 2 ranks."""
    from instag_tpu.bench_utils import synthetic_frame_batch
    from tests.test_torch_motion import flax_tree
    from tests.test_torch_pretrain_face import step_cloud
    rng = np.random.default_rng(21)
    j_states = [step_cloud(11 + k, n=64, capacity=128) for k in range(N_IDS)]
    j_batches = [synthetic_frame_batch(SIZE, n_frames=4, seed=k)
                 for k in range(N_IDS)]
    c = dict(
        face=dict(umf=flax_tree(TM.MotionNetwork(), rng),
                  pmf=[flax_tree(TM.PersonalizedMotionNetwork("face"), rng)
                       for _ in range(N_IDS)]),
        mouth=dict(umf=flax_tree(TM.MouthMotionNetwork(), rng),
                   pmf=[flax_tree(TM.PersonalizedMotionNetwork("mouth"),
                                  rng) for _ in range(N_IDS)]),
        states=[state_from_jax(s, "cpu") for s in j_states],
        batches=[frame_batch({k: None if v is None else np.asarray(v)
                              for k, v in vars(b).items()}, "cpu")
                 for b in j_batches])
    root = str(tmp_path_factory.mktemp("idp_ids"))
    for k, name in enumerate(IDS):
        generate_scene(os.path.join(root, name), n_frames=4, size=SIZE,
                       n_val=1, seed=k, device="cpu")
    ranks = start(_rank_work, N_IDS, (c, root), device="cpu", timeout=240.0)
    yield dict(c, j_states=j_states, j_batches=j_batches, ranks=ranks)
    ranks.join()


@pytest.fixture(scope="module")
def jax_losses(case):
    """JAX's identity-parallel face and mouth step losses."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from instag_tpu.config import OptimizationConfig as JOptConfig
    from instag_tpu.models import gaussians as JG
    from instag_tpu.models import motion as JM
    from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
    from instag_tpu.parallel.identity_parallel import (
        make_idp_pretrain_mouth_step as j_mouth, make_idp_pretrain_step
        as j_face, stack_identities as stack)
    from instag_tpu.train.optim import pmf_optimizer, umf_optimizer
    from instag_tpu.train.pretrain import PretrainFlags

    mesh = Mesh(np.array(jax.devices()[:N_IDS]), ("id",))
    cfg = JConfig(SIZE, SIZE, max_per_tile=K, approx_topk=False,
                  backend="xla")
    flags = PretrainFlags(use_regs=jnp.float32(1.0),
                          hair_paint=jnp.float32(0.0))
    states = stack(case["j_states"])
    gopts = stack([JG.adam_init(s.params) for s in case["j_states"]])
    batches = stack(case["j_batches"])
    out = {}
    for kind in ("face", "mouth"):
        umf_p, pmf_p = case[kind]["umf"], case[kind]["pmf"]
        umf_tx, umf_opt = umf_optimizer(umf_p, total_iters=100, warm_step=0)
        pmf_tx, pmf_opt = pmf_optimizer(pmf_p[0])
        args = (states, gopts, umf_p, umf_opt, stack(pmf_p),
                stack([pmf_opt] * N_IDS), umf_p)
        if kind == "face":
            step, _ = j_face(cfg, JOptConfig(), JM.MotionNetwork(),
                             JM.PersonalizedMotionNetwork("face"), 1.0,
                             N_IDS, mesh, umf_tx, pmf_tx)
            res = step(*args, batches, jnp.zeros(N_IDS, jnp.int32), 1, flags)
        else:
            step, _ = j_mouth(cfg, JOptConfig(), JM.MouthMotionNetwork(),
                              JM.PersonalizedMotionNetwork("mouth"),
                              JM.MotionNetwork(), 1.0, N_IDS, mesh, umf_tx,
                              pmf_tx)
            res = step(*args, states, case["face"]["umf"], batches,
                       jnp.zeros(N_IDS, jnp.int32),
                       (jnp.arange(N_IDS, dtype=jnp.int32) + 1) % N_IDS, 1,
                       flags)
        out[kind] = np.asarray(res[-1])
    return out


def _serial_losses(case, kind):
    losses = []
    for k in range(N_IDS):
        nets = _nets(case, kind)
        state = case["states"][k]
        if kind == "face":
            step = _face_step(case, *nets)
            args = (k, case["batches"][k], 0, 1, FLAGS)
        else:
            step = _mouth_step(case, *nets)
            args = (k, 1 - k, case["batches"][k], 0, 1, FLAGS)
        losses.append(float(step(state, G.adam_init(state.params),
                                 *args)[2]))
    return np.asarray(losses)


@pytest.mark.parametrize("kind", ["face", "mouth"])
def test_idp_losses_match_jax_and_serial(case, jax_losses, kind):
    outs = case["ranks"].join()
    ours = np.asarray([o[f"{kind}_loss"] for o in outs])
    np.testing.assert_allclose(ours, jax_losses[kind], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ours, _serial_losses(case, kind), rtol=2e-4,
                               atol=2e-5)
    for k, v in outs[0][f"{kind}_umf"].items():
        assert torch.equal(v, outs[1][f"{kind}_umf"][k]), k


def test_idp_densify_equals_serial(case):
    outs = case["ranks"].join()
    gen = torch.Generator().manual_seed(5)
    state0 = case["states"][0]
    noise = torch.randn((N_IDS, 2, state0.capacity, 3), generator=gen)
    oc = dataclasses.replace(OptimizationConfig(), **DENSE)
    for k in range(N_IDS):
        state = case["states"][k]
        st, _ = G.densify_and_prune(_hot(state), G.adam_init(state.params),
                                    noise[k], oc.densify_grad_threshold,
                                    0.005, 1.0, None, oc.percent_dense)
        assert int(st.alive.sum()) > int(_hot(state).alive.sum())
        np.testing.assert_array_equal(outs[k]["alive"], st.alive.numpy())
        for f in G.PARAM_FIELDS:
            np.testing.assert_array_equal(outs[k]["densified"][f],
                                          getattr(st.params, f).numpy(), f)


def test_idp_loop_returns_every_identity(case):
    a, b = (o["loop"] for o in case["ranks"].join())
    assert len(a["losses"]) == 4 and np.isfinite(a["losses"]).all()
    assert a["losses"] == b["losses"]
    for x, y in zip(a["xyz"], b["xyz"]):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a["xyz"][0], a["xyz"][1])
    for p, q in zip(a["pmf"], b["pmf"]):
        for k in p:
            np.testing.assert_array_equal(p[k], q[k], k)


def test_fewer_ranks_than_identities_refused():
    with pytest.raises(ValueError,
                       match=r"identity_parallel needs >= 2 devices, have 1"):
        TP.pretrain_face(ModelConfig(source_path="/nonexistent"),
                         OptimizationConfig(), IDS, identity_parallel=True,
                         device="cpu")


def test_a_rank_decodes_only_its_identity(tmp_path):
    """Under identity parallelism a rank decodes only its own identity's
    frames and builds only its cloud; every identity's meta and extent,
    which the draws every rank replays need, equal a full read's."""
    for k, name in enumerate(IDS):
        generate_scene(str(tmp_path / name), n_frames=4, size=SIZE, n_val=1,
                       seed=k, device="cpu")
    mc = ModelConfig(source_path=str(tmp_path), init_num=64, capacity=128,
                     max_per_tile=K)
    args = (mc, OptimizationConfig(iterations=4), IDS, False, 0, False,
            1000, torch.device("cpu"), "test")
    full, own = TP._start(*args), TP._start(*args, only=1)
    assert own["batches"][0] is None and own["states"][0] is None
    assert own["gopts"][0] is None
    for a, b in zip(vars(full["batches"][1]).values(),
                    vars(own["batches"][1]).values()):
        assert (a is None and b is None) or torch.equal(a, b)
    for f in G.PARAM_FIELDS:
        assert torch.equal(getattr(full["states"][1].params, f),
                           getattr(own["states"][1].params, f))
    for a, b in zip(full["metas"], own["metas"]):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name))
    assert full["extents"] == own["extents"] and full["cfg"] == own["cfg"]
    with pytest.raises(ValueError, match="exclusive with streaming"):
        TP._start(*args[:5], True, *args[6:], only=0)
