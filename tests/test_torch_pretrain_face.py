"""The port's face pre-training (``instag_torch/train/pretrain.py``) against
the JAX package's, on two identities that ``generate_scene`` writes (6
frames at 64x64, ``variation`` 0.3, seeds 0 and 1), with exact selection
and K=256 so that no tile is cut.

  * the curriculum draw for draw, the green prune's masks, the EMA update
    within rtol 1e-7 and the UMF multiplier within rtol 1e-6 of the JAX
    loop's own learning rates (taken from a ``pretrain_face`` call);
  * one face motion step of identity 0 (``use_regs`` 1, a non-zero
    contrastive term against identity 1) from the same cloud, frame and
    nets: the loss within rtol 1e-5, the Gaussian, UMF and PMF gradients
    within rtol 2e-3 on top of 5e-4 of each tensor's largest gradient (as
    tests/test_torch_face.py reads them from the JAX Adam moments), and
    identity 1's PMF bit-unchanged;
  * a 30-step-an-identity ``pretrain_face`` (warm-up 8 steps an identity,
    so that the first motion block starts on a step without the
    regularisers; log points every 20) from the JAX loop's own starting
    nets: per-step losses within rtol 1e-3 (see
    tests/test_torch_train_face.py) and final alive masks equal. The EMA
    is held two ways. Its wiring exactly: JAX's ``ema_update`` over the
    port's own live UMF after each of its updates gives the port's EMA
    within rtol 1e-6 (a copy of the starting UMF, one update a motion
    step, none in warm-up). And against the JAX loop's EMA: the port's
    lies within 0.1 of how far JAX's moved from the starting UMF (L2 over
    every parameter; 0.054 measured by scripts/probe_pretrain_parity.py,
    against < 1e-4 between two JAX runs whose starting UMFs differ by one
    part in 1e6). rtol 1e-4 is out of reach. The painted target (and, in
    most motion steps, the render's painted hair) is flat background
    green over whole SSIM windows, where the SSIM's variance
    blur(x^2) - mu^2 is float32 cancellation noise that XLA's and
    PyTorch's sums round differently: on one same pair of images the two
    SSIMs differ by 7e-5 to 9e-5 relative (the same script). Their
    gradients differ in the last bits, and AdamW (eps 1e-8) takes a
    learning-rate-size step on any gradient above ~1e-7, as the UMF's
    hash tables hold, so the two live UMFs part over the 45 updates;
  * the run with its frames streamed from host memory, against the same
    run with its frames in one batch, within rtol 1e-4 (the JAX package's
    own test_streaming_matches_preloaded tolerance).
"""

import contextlib
import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from instag_tpu.config import ModelConfig as JModelConfig
from instag_tpu.config import OptimizationConfig as JOptConfig
from instag_tpu.data.dataset import load_frames as j_load_frames
from instag_tpu.data.dataset import random_init_points
from instag_tpu.data.dataset import scene_extent as j_scene_extent
from instag_tpu.data.synthetic import generate_scene
from instag_tpu.models import gaussians as JG
from instag_tpu.models import motion as JM
from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
from instag_tpu.train import common as j_common
from instag_tpu.train import optim as j_optim
from instag_tpu.train import pretrain as JP
from instag_torch.config import ModelConfig, OptimizationConfig
from instag_torch.io.checkpoints import flax_params
from instag_torch.io.from_jax import (frame_batch, load_motion_net,
                                      motion_state_dict, state_from_jax)
from instag_torch.models import gaussians as G
from instag_torch.models import motion as TM
from instag_torch.ops.rasterize import RasterizeConfig
from instag_torch.train import optim as t_optim
from instag_torch.train import pretrain as TP
from instag_torch.train.common import FrameMeta
from tests.test_torch_face import _adam_mu, _close
from tests.test_torch_motion import flax_tree
from tests.torch_cpu import one_torch_thread  # noqa: F401

IDS = ["id_a", "id_b"]
SIZE, K = 64, 256
B1 = 0.9
LOSS_RTOL = 1e-3
EMA_PART = 0.1     # see the module docstring
LOOP_OPT = dict(iterations=30, densify_from_iter=10,
                densification_interval=5, opacity_reset_interval=100000,
                position_lr_max_steps=60)
LOOP_KW = dict(log_every=20, warm_per_id=8, identity_block=5)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pretrain_ids"))
    for k, name in enumerate(IDS):
        generate_scene(os.path.join(path, name), n_frames=6, size=SIZE,
                       n_val=2, seed=k, variation=0.3)
    return path


def jax_start_nets(kind: str, seed: int, n: int):
    """The JAX loop's own starting nets (flax trees, as numpy): the UMF and
    one PMF an identity, drawn as ``pretrain_face`` / ``pretrain_mouth``
    draw them (flax's init reads only the shapes of its inputs)."""
    face = kind == "face"
    keys = jax.random.split(jax.random.key(seed if face else seed + 99),
                            n + 2)
    x0, a0 = jnp.zeros((8, 3)), jnp.zeros((8, 29, 16))
    last = jnp.zeros((6,)) if face else jnp.zeros((1, 3))
    umf = (JM.MotionNetwork() if face else JM.MouthMotionNetwork())
    pmf = JM.PersonalizedMotionNetwork(kind)
    umf_p = jax.device_get(jax.jit(umf.init)(keys[0], x0, a0, last))
    pmf_args = (x0, a0, last) if face else (x0, a0)
    pmf_p = [jax.device_get(jax.jit(pmf.init)(keys[1 + k], *pmf_args))
             for k in range(n)]
    return umf_p, pmf_p


def port_nets(kind: str, umf_p, pmf_p):
    umf = TM.MotionNetwork() if kind == "face" else TM.MouthMotionNetwork()
    return (load_motion_net(umf, umf_p, "cpu"),
            [load_motion_net(TM.PersonalizedMotionNetwork(kind), p, "cpu")
             for p in pmf_p])


def ema_parting(ema_net, ref_params, start: dict) -> float:
    """How far the port's EMA lies from the JAX loop's, over how far the
    JAX loop's moved from the starting UMF (L2 over every parameter)."""
    ref = motion_state_dict(ref_params)
    ours = ema_net.state_dict()
    apart = sum(float((ours[k] - ref[k]).square().sum()) for k in ref)
    moved = sum(float((ref[k] - start[k]).square().sum()) for k in ref)
    return (apart / moved) ** 0.5


def tree_close(ours: dict, ref: dict, rtol: float, atol_frac: float = 0.0):
    """Two state dicts: every tensor within rtol, on top of ``atol_frac``
    of its reference's largest value."""
    assert set(ours) == set(ref)
    for k in ours:
        r = ref[k].numpy()
        np.testing.assert_allclose(
            ours[k].numpy(), r, rtol=rtol,
            atol=atol_frac * float(np.abs(r).max()), err_msg=k)


@contextlib.contextmanager
def umf_transforms_kept(seen: dict):
    """Keep the per-label AdamW transforms that ``pretrain_face`` builds
    inline for its UMF (its first ``optax.multi_transform``) in
    ``seen["transforms"]``, and let the call go on."""
    real = optax.multi_transform

    def keep(transforms, labels):
        seen.setdefault("transforms", transforms)
        return real(transforms, labels)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "multi_transform", keep)
        yield seen
    assert real is optax.multi_transform


@pytest.fixture(scope="module")
def jax_umf_transforms(face_runs):
    """The per-label AdamW transforms of the JAX loop's UMF, taken from
    ``face_runs``' call (30 iterations an identity): one JAX loop traced
    for both."""
    return face_runs["transforms"]


def _meta(rng, n=12):
    mouth = [float(x) for x in rng.integers(1, 12, n)]
    return FrameMeta(blink=rng.uniform(0, 1, n), mouth=mouth,
                     mouth_lb=min(mouth), mouth_ub=max(mouth),
                     au25=np.zeros(n), au25_pcts=(0, 0, 0, 0),
                     mouth_px=np.zeros(n, int))


@pytest.mark.parametrize("select_iter", [1, 400])
def test_sample_face_curriculum_matches_jax(select_iter):
    """500 draws over warm_step 200 (mouth windows, then blink windows),
    with select_iter 1 (every windowed draw runs its 100 tries) and 400
    (windows that move through the values)."""
    meta = _meta(np.random.default_rng(select_iter))
    j_meta = {"mouth": list(meta.mouth), "blink": list(meta.blink),
              "mouth_lb": meta.mouth_lb, "mouth_ub": meta.mouth_ub}
    r_j, r_t = np.random.default_rng(3), np.random.default_rng(3)
    s_j, s_t = [], []
    picks = [(JP._sample_face_curriculum(r_j, j_meta, s_j, it, 200,
                                         select_iter, 15),
              TP._sample_face_curriculum(r_t, meta, s_t, it, 200,
                                         select_iter, 15))
             for it in range(1, 501)]
    assert all(a == b for a, b in picks)
    assert s_j == s_t and r_j.integers(1 << 30) == r_t.integers(1 << 30)


def test_prune_green_matches_jax():
    """A cloud with a third of its live splats painted background green."""
    state = JG.create_from_points(
        *map(jnp.asarray, random_init_points(300, 4)), 512, 2, 1.0)
    rng = np.random.default_rng(5)
    green = rng.random(512) < 0.33
    dc = np.array(state.params.features_dc)
    dc[green, 0] = (np.array([0.05, 0.98, 0.02]) - 0.5) / 0.28209479177387814
    rest = np.array(state.params.features_rest)
    rest[green] = 0.0
    state = state.replace(params=state.params.replace(
        features_dc=jnp.asarray(dc), features_rest=jnp.asarray(rest)))
    t_state = state_from_jax(state, "cpu")
    campos = np.array([0.1, -0.2, 2.0], np.float32)
    j_out, _ = JP._prune_green(state, JG.adam_init(state.params),
                               jnp.asarray(campos))
    t_out, _ = TP._prune_green(t_state, G.adam_init(t_state.params),
                               torch.from_numpy(campos))
    alive = t_out.alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(j_out.alive))
    assert 150 < alive.sum() < 250


def test_ema_update_matches_jax():
    net = TM.MotionNetwork()
    rng = np.random.default_rng(7)
    e_p, p_p = flax_tree(net, rng), flax_tree(net, rng)
    ema, live = (load_motion_net(TM.MotionNetwork(), t, "cpu")
                 for t in (e_p, p_p))
    t_optim.ema_update(ema, live, 0.995)
    ref = motion_state_dict(jax.device_get(
        j_optim.ema_update(e_p, p_p, 0.995)))
    tree_close(ema.state_dict(), ref, rtol=1e-7)


def test_pretrain_schedule_matches_jax(jax_umf_transforms):
    """The multiplier at update counts 0, 1, select_iter and total - 1, on
    the JAX loop's own LR callables (30 iterations an identity, 2
    identities: select_iter 1, total 60), and the port's optimizer at the
    same counts."""
    select_iter, total = 1, 60
    mult = t_optim.pretrain_schedule(select_iter, total)
    net = TM.MotionNetwork()
    opt, sched = t_optim.pretrain_umf_optimizer(net, select_iter, total)
    seen = {}
    for count in range(total):
        seen[count] = [g["lr"] for g in opt.param_groups]
        opt.step()              # no gradients: no parameter moves
        sched.step()
    base = {"net": 5e-4, "encoder": 5e-3, "audio_att": 2.5e-3,
            "align": 2.5e-4}
    for count in (0, 1, select_iter, total - 1):
        for label, tx in jax_umf_transforms.items():
            assert mult(count) == pytest.approx(
                float(_jax_lr(tx, count)) / base[label], rel=1e-6), label
        assert seen[count] == pytest.approx(
            [base[lb] * mult(count) for lb in ("net", "encoder",
                                               "audio_att")], rel=1e-6)
    assert mult(0) == 1.0 and mult(1) == pytest.approx(0.1 ** (1 / total))


def _jax_lr(tx, count: int):
    """The learning rate an optax adamw applies at update ``count``: its
    update of a zero parameter with a unit gradient, at a schedule count
    of ``count`` (Adam's normalised step is then 1)."""
    p = {"p": jnp.zeros(())}
    state = tx.init(p)
    # chain state: (scale_by_adam, add_decayed_weights, schedule)
    state = (state[0], state[1], state[2]._replace(
        count=jnp.asarray(count, jnp.int32)))
    upd, _ = tx.update({"p": jnp.ones(())}, state, p)
    return -upd["p"]


def umf_tx(transforms: dict, params):
    """The JAX loop's UMF optimizer over ``params``."""
    return optax.multi_transform(transforms, j_optim.label_tree(params))


def identity_batch(root: str, name: str):
    """(JAX FrameBatch, port FrameBatch, scene extent) of one identity."""
    records = j_load_frames(os.path.join(root, name), "train")
    jb = j_common.build_frame_batch(records)
    tb = frame_batch({k: None if v is None else np.asarray(v)
                      for k, v in vars(jb).items()}, device="cpu")
    return jb, tb, j_scene_extent(records)[1]


def step_cloud(seed: int, n: int = 150, capacity: int = 512,
               mouth: bool = False):
    """A JAX cloud from ``random_init_points`` (halved and moved down as
    the mouth's when ``mouth``) with brighter colours, spread 1.5x wider,
    so that no two overlapping splats sit at depths that rounding could
    reorder, in front of a backdrop of 64 wide splats (an 8x8 grid 0.5
    behind the origin, depths jittered) that covers the frame. The
    backdrop keeps every pixel off the background: where a render and
    its target are both flat background green over an SSIM window, the
    window's variance is float32 cancellation noise, and whether the
    variance clamp passes its gradient follows the noise's sign, which
    differs between XLA's and PyTorch's blur sums. (Fewer than K splats in
    all, so no tile is cut.)"""
    rng = np.random.default_rng(seed)
    xyz, cols = random_init_points(n, seed)
    if mouth:
        xyz = xyz / 2.0
        xyz[:, 1] -= 0.05
    xyz = xyz * 1.5
    g = np.linspace(-1.0, 1.0, 8)
    back = np.stack([*np.meshgrid(g, g), np.zeros((8, 8))], -1).reshape(-1, 3)
    back[:, 2] = -0.5 + rng.uniform(-0.1, 0.1, 64)
    xyz = np.concatenate([xyz, back]).astype(np.float32)
    cols = rng.uniform(0.2, 0.9, (len(xyz), 3)).astype(np.float32)
    state = JG.create_from_points(jnp.asarray(xyz), jnp.asarray(cols),
                                  capacity, 2, 1.0)
    scaling = np.array(state.params.scaling)
    scaling[n:len(xyz)] = np.log(0.12)
    return state.replace(params=state.params.replace(
        scaling=jnp.asarray(scaling)))


def check_step_grads(t_gopt, j_gopt, nets, opt_states, starts):
    """The port's Gaussian and net gradients against the JAX Adam first
    moments (mu / (1 - b1); a PMF's audio_att moment holds g + 1e-4 p)."""
    for f in G.PARAM_FIELDS:
        _close(getattr(t_gopt.mu, f) / (1 - B1),
               np.asarray(getattr(j_gopt.mu, f)) / (1 - B1), f)
    for (net, pmf), opt_state, p0 in zip(nets, opt_states, starts):
        ref = motion_state_dict(_adam_mu(opt_state))
        start = motion_state_dict(p0)
        grads = {n: p.grad for n, p in net.named_parameters()}
        assert set(ref) == set(grads)
        for n, g in grads.items():
            if pmf and "audio_att_net" in n:
                g = g + 1e-4 * start[n]
            _close(g.numpy(), ref[n].numpy() / (1 - B1), n)


def test_face_motion_step_matches_jax(root, jax_umf_transforms):
    jb, tb, extent = identity_batch(root, IDS[0])
    state = step_cloud(11)
    t_state = state_from_jax(state, "cpu")
    rng = np.random.default_rng(12)
    umf_p = flax_tree(TM.MotionNetwork(), rng)
    pmf_p = [flax_tree(TM.PersonalizedMotionNetwork("face"), rng)
             for _ in IDS]
    # identity 1's PMF moves its splats far (it renders nothing here), so
    # that the contrastive term weighs in the loss and the PMF's gradient
    pmf_p[1]["params"]["sigma_net"]["net_2"]["kernel"] *= 1e5
    frame, it = 2, 40
    umf, pmfs = port_nets("face", umf_p, pmf_p)
    other0 = copy.deepcopy(pmfs[1].state_dict())

    # JAX: one motion step of identity 0 (its block donates its carry)
    tx = umf_tx(jax_umf_transforms, umf_p)
    pmf_tx, pmf_opt = j_optim.pmf_optimizer(pmf_p[0])
    stack = lambda trees: jax.tree.map(lambda *x: jnp.stack(x), *trees)
    block = JP.make_pretrain_face_step(
        JConfig(SIZE, SIZE, max_per_tile=K, approx_topk=False),
        JOptConfig(), JM.MotionNetwork(), JM.PersonalizedMotionNetwork("face"),
        extent, len(IDS), tx, pmf_tx)
    flags = JP.PretrainFlags(use_regs=jnp.ones((1,)),
                             hair_paint=jnp.zeros((1,)))
    (j_state, j_gopt, _, j_umf_opt, j_stack, j_pmf_opt, _,
     j_losses) = jax.device_get(block(
        state, JG.adam_init(state.params), umf_p, jax.jit(tx.init)(umf_p),
        stack(pmf_p), stack([pmf_opt] * len(IDS)), umf_p, 0, jb,
        jnp.asarray([frame], jnp.int32), jnp.asarray([it], jnp.int32),
        flags))

    ema = copy.deepcopy(umf)
    step = TP.make_pretrain_face_step(
        RasterizeConfig(SIZE, SIZE, max_per_tile=K), OptimizationConfig(),
        umf, pmfs, ema, extent, 1, 60, device="cpu")
    t_flags = TP.PretrainFlags(use_regs=1.0, hair_paint=0.0)
    # the contrastive term: the same loss without identity 1's PMF
    alone = TP.make_pretrain_face_step(
        RasterizeConfig(SIZE, SIZE, max_per_tile=K), OptimizationConfig(),
        umf, pmfs[:1], ema, extent, 1, 60, device="cpu")
    with torch.no_grad():
        off = torch.zeros((t_state.capacity, 2))
        contrast = float(step.loss(t_state, off, 0, tb, frame, t_flags)[0]
                         - alone.loss(t_state, off, 0, tb, frame,
                                      t_flags)[0])
    t_state1, t_gopt, loss = step(t_state, G.adam_init(t_state.params), 0,
                                  tb, frame, it, t_flags)

    np.testing.assert_allclose(float(loss), float(j_losses[0]), rtol=1e-5)
    assert contrast > 1e-3 * float(loss)
    check_step_grads(t_gopt, j_gopt, [(umf, False), (pmfs[0], True)],
                     [j_umf_opt, jax.tree.map(lambda x: x[0], j_pmf_opt)],
                     [umf_p, pmf_p[0]])
    for name in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(t_state1, name).numpy(),
                                   np.asarray(getattr(j_state, name)),
                                   rtol=2e-4, atol=1e-7, err_msg=name)
    # identity 1's PMF: untouched in both packages
    for k, v in pmfs[1].state_dict().items():
        assert torch.equal(v, other0[k]), k
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda x: x[1], j_stack)),
                    jax.tree.leaves(pmf_p[1])):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the EMA moved by (1 - decay) of the UMF's update
    assert any(not torch.equal(a, b) for a, b in zip(
        ema.state_dict().values(), load_motion_net(
            TM.MotionNetwork(), umf_p, "cpu").state_dict().values()))


def model_configs(root: str, kind: str = "face"):
    """(JAX, port) model settings of the loop runs."""
    kw = dict(source_path=root, init_num=150, capacity=512, max_per_tile=K,
              type=kind)
    return JModelConfig(approx_topk=False, **kw), ModelConfig(**kw)


def port_pretrain_face(root: str, umf_p, pmf_p, trace=None, **kw):
    """The port's loop from the given flax trees; ``trace`` (a list)
    collects the live UMF's state dict after each of its updates."""
    umf, pmfs = port_nets("face", umf_p, pmf_p)
    with pytest.MonkeyPatch.context() as mp:
        if trace is not None:
            def ema_update(ema, net, decay):
                trace.append(copy.deepcopy(net.state_dict()))
                t_optim.ema_update(ema, net, decay)
            mp.setattr(TP, "ema_update", ema_update)
        return TP.pretrain_face(
            model_configs(root)[1], OptimizationConfig(**LOOP_OPT), IDS,
            umf_net=umf, pmf_nets=pmfs, device="cpu", **LOOP_KW, **kw)


@pytest.fixture(scope="module")
def face_runs(root):
    """The JAX loop, and the port's from the JAX loop's starting nets."""
    with umf_transforms_kept({}) as seen:
        ref = JP.pretrain_face(model_configs(root)[0],
                               JOptConfig(**LOOP_OPT), IDS, **LOOP_KW)
    umf_p, pmf_p = jax_start_nets("face", 0, len(IDS))
    trace = []
    ours = port_pretrain_face(root, umf_p, pmf_p, trace=trace)
    return dict(ref=jax.device_get(ref), ours=ours, umf_p=umf_p,
                pmf_p=pmf_p, trace=trace, transforms=seen["transforms"])


def test_pretrain_face_losses_and_masks_match_jax(face_runs):
    ref, ours = face_runs["ref"], face_runs["ours"]
    assert len(ours["losses"]) == len(ref["losses"]) == 60
    np.testing.assert_allclose(ours["losses"], ref["losses"],
                               rtol=LOSS_RTOL)
    for t, j in zip(ours["states"], ref["states"]):
        np.testing.assert_array_equal(t.alive.numpy(), np.asarray(j.alive))
        assert t.capacity == j.capacity
    assert ours["data_list"] == IDS and ours["cfg"].image_height == SIZE


def test_pretrain_face_ema_matches_jax(face_runs):
    ref, ours, trace = face_runs["ref"], face_runs["ours"], face_runs["trace"]
    # one update a motion step: warm-up runs the steps below warm_step (16)
    assert len(trace) == 60 - 15
    start = motion_state_dict(face_runs["umf_p"])
    live = jax.device_get(jax.tree.map(jnp.asarray, face_runs["umf_p"]))
    ema = live
    for sd in trace:
        ema = j_optim.ema_update(ema, flax_params(sd), 0.995)
    tree_close(ours["ema_net"].state_dict(),
               motion_state_dict(jax.device_get(ema)), rtol=1e-6,
               atol_frac=1e-6)
    tree_close(ours["umf_net"].state_dict(), trace[-1], rtol=0.0)
    assert ema_parting(ours["ema_net"], ref["ema_params"], start) <= EMA_PART


def test_pretrain_face_streamed_matches_preloaded(root, face_runs):
    streamed = port_pretrain_face(root, face_runs["umf_p"],
                                  face_runs["pmf_p"], stream=True)
    np.testing.assert_allclose(streamed["losses"],
                               face_runs["ours"]["losses"], rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(streamed["states"], face_runs["ours"]["states"]):
        assert torch.equal(a.alive, b.alive)
