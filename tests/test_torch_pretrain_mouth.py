"""The port's mouth pre-training, and its face pre-training with
``share_audio_net``, against the JAX package's, on the two generated
identities of tests/test_torch_pretrain_face.py (its helpers and
tolerances).

  * one mouth motion step of identity 0 under a frozen face cloud and face
    UMF (``use_regs`` 1, a non-zero contrastive term against identity
    1's PMF): the loss within rtol 1e-4, the Gaussian, UMF and PMF
    gradients within rtol 2e-3 on top of 5e-4 of each tensor's largest
    gradient, and identity 1's PMF bit-unchanged. (Not 1e-5: the target
    is background green but for the 64-pixel mouth, and on the same
    painted pair of images the two packages' SSIMs differ by 3.1e-5 of
    this loss, scripts/probe_pretrain_parity.py; see
    tests/test_torch_pretrain_face.py.)
  * a 30-step-an-identity ``pretrain_face`` with ``share_audio_net``: the
    per-step losses within rtol 1e-3, the final alive masks equal, and
    every PMF's audio weights equal to the UMF's at the end (the JAX
    loop's too);
  * a 20-step-an-identity ``pretrain_mouth`` (warm-up 8 steps an
    identity) under the JAX face run's result, from the JAX loop's own
    starting nets: the per-step losses within rtol 1e-3, the final alive
    masks equal, the EMA's wiring within rtol 1e-6 and the EMA within 0.1
    of how far JAX's moved (see tests/test_torch_pretrain_face.py for why
    not rtol 1e-4).
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.config import OptimizationConfig as JOptConfig
from instag_tpu.models import gaussians as JG
from instag_tpu.models import motion as JM
from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
from instag_tpu.train import optim as j_optim
from instag_tpu.train import pretrain as JP
from instag_torch.config import OptimizationConfig
from instag_torch.io.checkpoints import flax_params
from instag_torch.io.from_jax import (load_motion_net, motion_state_dict,
                                      state_from_jax)
from instag_torch.models import gaussians as G
from instag_torch.models import motion as TM
from instag_torch.ops.rasterize import RasterizeConfig
from instag_torch.train import optim as t_optim
from instag_torch.train import pretrain as TP
from tests.test_torch_motion import flax_tree
from tests.test_torch_pretrain_face import (  # noqa: F401
    EMA_PART, IDS, K, LOOP_KW, LOOP_OPT, LOSS_RTOL, SIZE, check_step_grads,
    ema_parting,
    identity_batch, jax_start_nets, model_configs, port_nets,
    port_pretrain_face, root, step_cloud, tree_close, umf_transforms_kept,
    umf_tx)
from tests.torch_cpu import one_torch_thread  # noqa: F401

MOUTH_OPT = dict(LOOP_OPT, iterations=20, position_lr_max_steps=40)


def test_mouth_motion_step_matches_jax(root, jax_umf_transforms):
    jb, tb, extent = identity_batch(root, IDS[0])
    state = step_cloud(21, mouth=True)
    face_state = step_cloud(22)
    t_state = state_from_jax(state, "cpu")
    t_face = state_from_jax(face_state, "cpu")
    rng = np.random.default_rng(23)
    umf_p = flax_tree(TM.MouthMotionNetwork(), rng)
    face_p = flax_tree(TM.MotionNetwork(), rng)
    pmf_p = [flax_tree(TM.PersonalizedMotionNetwork("mouth"), rng)
             for _ in IDS]
    # identity 1's PMF moves its splats far, so that the contrastive term
    # weighs in the loss and the PMF's gradient
    pmf_p[1]["params"]["sigma_net"]["net_2"]["kernel"] *= 1e5
    frame, it = 3, 40
    umf, pmfs = port_nets("mouth", umf_p, pmf_p)
    face_net = load_motion_net(TM.MotionNetwork(), face_p, "cpu")
    other0 = copy.deepcopy(pmfs[1].state_dict())

    tx = umf_tx(jax_umf_transforms, umf_p)
    pmf_tx, pmf_opt = j_optim.pmf_optimizer(pmf_p[0])
    stack = lambda trees: jax.tree.map(lambda *x: jnp.stack(x), *trees)
    block = JP.make_pretrain_mouth_step(
        JConfig(SIZE, SIZE, max_per_tile=K, approx_topk=False),
        JOptConfig(), JM.MouthMotionNetwork(),
        JM.PersonalizedMotionNetwork("mouth"), JM.MotionNetwork(), extent,
        len(IDS), tx, pmf_tx)
    flags = JP.PretrainFlags(use_regs=jnp.ones((1,)),
                             hair_paint=jnp.zeros((1,)))
    (j_state, j_gopt, _, j_umf_opt, j_stack, j_pmf_opt, _,
     j_losses) = jax.device_get(block(
        state, JG.adam_init(state.params), umf_p, jax.jit(tx.init)(umf_p),
        stack(pmf_p), stack([pmf_opt] * len(IDS)), umf_p, 0, 1, face_state,
        face_p, jb, jnp.asarray([frame], jnp.int32),
        jnp.asarray([it], jnp.int32), flags))

    ema = copy.deepcopy(umf)
    cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=K)
    step = TP.make_pretrain_mouth_step(
        cfg, OptimizationConfig(), umf, pmfs, ema, [t_face, t_face],
        face_net, extent, 1, 60, device="cpu")
    alone = TP.make_pretrain_mouth_step(
        cfg, OptimizationConfig(), umf, pmfs[:1], ema, [t_face], face_net,
        extent, 1, 60, device="cpu")
    t_flags = TP.PretrainFlags(use_regs=1.0, hair_paint=0.0)
    with torch.no_grad():
        off = torch.zeros((t_state.capacity, 2))
        contrast = float(
            step.loss(t_state, off, 0, 1, tb, frame, t_flags)[0]
            - alone.loss(t_state, off, 0, 0, tb, frame, t_flags)[0])
    _, t_gopt, loss = step(t_state, G.adam_init(t_state.params), 0, 1, tb,
                           frame, it, t_flags)

    np.testing.assert_allclose(float(loss), float(j_losses[0]), rtol=1e-4)
    assert contrast > 1e-3 * float(loss)
    check_step_grads(t_gopt, j_gopt, [(umf, False), (pmfs[0], True)],
                     [j_umf_opt, jax.tree.map(lambda x: x[0], j_pmf_opt)],
                     [umf_p, pmf_p[0]])
    for k, v in pmfs[1].state_dict().items():
        assert torch.equal(v, other0[k]), k
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda x: x[1], j_stack)),
                    jax.tree.leaves(pmf_p[1])):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.fixture(scope="module")
def shared_face_runs(root):
    """``pretrain_face`` with ``share_audio_net`` in both packages; the JAX
    result stays on the device for the JAX mouth loop."""
    with umf_transforms_kept({}) as seen:
        ref = JP.pretrain_face(model_configs(root)[0],
                               JOptConfig(**LOOP_OPT), IDS,
                               share_audio_net=True, **LOOP_KW)
    umf_p, pmf_p = jax_start_nets("face", 0, len(IDS))
    ours = port_pretrain_face(root, umf_p, pmf_p, share_audio_net=True)
    return ref, ours, seen["transforms"]


@pytest.fixture(scope="module")
def jax_umf_transforms(shared_face_runs):
    """The JAX loop's UMF transforms (30 iterations an identity), from
    ``shared_face_runs``' call: one JAX loop traced for both."""
    return shared_face_runs[2]


def test_share_audio_net_matches_jax(shared_face_runs):
    ref, ours, _ = shared_face_runs
    np.testing.assert_allclose(ours["losses"], ref["losses"],
                               rtol=LOSS_RTOL)
    for t, j in zip(ours["states"], ref["states"]):
        np.testing.assert_array_equal(t.alive.numpy(), np.asarray(j.alive))
    umf_audio = flax_params(ours["umf_net"])["params"]["audio"]
    j_audio = jax.device_get(ref["umf_params"]["params"]["audio"])
    for k, pmf in enumerate(ours["pmf_nets"]):
        assert pmf.audio is ours["umf_net"].audio
        saved = flax_params(pmf)["params"]["audio"]
        for a, b in zip(jax.tree.leaves(saved), jax.tree.leaves(umf_audio)):
            np.testing.assert_array_equal(a, b)
        j_pmf = jax.device_get(jax.tree.map(
            lambda x, k=k: x[k], ref["pmf_stack"]["params"]["audio"]))
        for a, b in zip(jax.tree.leaves(j_pmf), jax.tree.leaves(j_audio)):
            np.testing.assert_array_equal(a, b)


def test_pretrain_mouth_matches_jax(root, shared_face_runs):
    face = shared_face_runs[0]
    kw = dict(LOOP_KW)
    j_mc, t_mc = model_configs(root, "mouth")
    ref = jax.device_get(JP.pretrain_mouth(
        j_mc, JOptConfig(**MOUTH_OPT), IDS, face, **kw))
    umf_p, pmf_p = jax_start_nets("mouth", 0, len(IDS))
    umf, pmfs = port_nets("mouth", umf_p, pmf_p)
    t_face = dict(states=[state_from_jax(s, "cpu") for s in face["states"]],
                  ema_net=load_motion_net(TM.MotionNetwork(),
                                          jax.device_get(face["ema_params"]),
                                          "cpu"))
    trace = []
    with pytest.MonkeyPatch.context() as mp:
        def ema_update(ema, net, decay):
            trace.append(copy.deepcopy(net.state_dict()))
            t_optim.ema_update(ema, net, decay)
        mp.setattr(TP, "ema_update", ema_update)
        ours = TP.pretrain_mouth(t_mc, OptimizationConfig(**MOUTH_OPT), IDS,
                                 t_face, umf_net=umf, pmf_nets=pmfs,
                                 device="cpu", **kw)

    assert len(ours["losses"]) == len(ref["losses"]) == 40
    np.testing.assert_allclose(ours["losses"], ref["losses"],
                               rtol=LOSS_RTOL)
    for t, j in zip(ours["states"], ref["states"]):
        np.testing.assert_array_equal(t.alive.numpy(), np.asarray(j.alive))
    assert len(trace) == 40 - 15
    ema = umf_p
    for sd in trace:
        ema = j_optim.ema_update(ema, flax_params(sd), 0.995)
    tree_close(ours["ema_net"].state_dict(),
               motion_state_dict(jax.device_get(ema)), rtol=1e-6,
               atol_frac=1e-6)
    start = motion_state_dict(umf_p)
    assert ema_parting(ours["ema_net"], ref["ema_params"], start) <= EMA_PART
