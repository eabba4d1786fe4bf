"""The port's training pieces against the JAX package on the same inputs:
the image losses, the xyz learning-rate schedule, the Gaussian Adam, the
densification statistics and the motion-net optimizers."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.models import gaussians as JG
from instag_tpu.train import common as JC
from instag_tpu.train import optim as JO
from instag_tpu.utils import general as JGen
from instag_tpu.utils import losses as JL
from instag_torch.config import OptimizationConfig
from instag_torch.io.from_jax import load_motion_net, motion_state_dict
from instag_torch.models import gaussians as G
from instag_torch.models import motion as TM
from instag_torch.train import common as TC
from instag_torch.train import optim as TO
from instag_torch.utils import general as TGen
from instag_torch.utils import losses as TL
from tests.test_torch_motion import flax_tree
from tests.torch_cpu import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _images(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    a = (rng.uniform(size=(3, 40, 56)) * scale).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, None).astype(np.float32)
    return a, b


@pytest.mark.parametrize("scale", [1.0, 300.0], ids=["unit", "blown-up"])
def test_losses_match_jax(scale):
    """SSIM's clamps matter on the blown-up pair (large unclamped values)."""
    a, b = _images(0, scale)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("l1_loss", "ssim", "psnr"):
        ref = float(getattr(JL, name)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(float(getattr(TL, name)(ta, tb)), ref,
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(
        float(TC.rgb_loss(ta, tb, 0.2)),
        float(JC.rgb_loss(jnp.asarray(a), jnp.asarray(b), 0.2)), **TOL)
    np.testing.assert_allclose(TL.normalize_depth(ta[0]).numpy(),
                               np.asarray(JL.normalize_depth(jnp.asarray(a[0]))),
                               **TOL)
    if scale != 1.0:
        return        # the blown-up pair's gradient is cancellation noise
    x = ta.clone().requires_grad_(True)
    TL.ssim(x, tb).backward()
    ref = jax.jit(jax.grad(JL.ssim))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-6 * float(np.abs(ref).max()))


def test_lr_schedule_and_rect_mask_match_jax():
    oc = OptimizationConfig()
    for step in (-1, 0, 1, 777, 45_000, 45_001):
        for scale in (1.0, 2.5):
            ref = JC.gaussian_lrs(oc, step, scale)
            ours = TC.gaussian_lrs(oc, step, scale)
            assert set(ours) == set(ref)
            for k in ref:
                np.testing.assert_allclose(float(ours[k]), float(ref[k]),
                                           rtol=1e-6, atol=0, err_msg=k)
    np.testing.assert_allclose(
        float(TGen.expon_lr(30, 1e-2, 1e-4, lr_delay_steps=100,
                            lr_delay_mult=0.1, max_steps=500)),
        float(JGen.expon_lr(30, 1e-2, 1e-4, lr_delay_steps=100,
                            lr_delay_mult=0.1, max_steps=500)), rtol=1e-6)
    rect = np.array([5, 20, 7, 30], np.int32)
    np.testing.assert_array_equal(
        TC.rect_mask(32, 40, torch.from_numpy(rect)).numpy(),
        np.asarray(JC.rect_mask(32, 40, jnp.asarray(rect))))


def _params(rng, cap):
    shapes = dict(xyz=(cap, 3), features_dc=(cap, 1, 3),
                  features_rest=(cap, 3, 3), identity=(cap, 1),
                  scaling=(cap, 3), rotation=(cap, 4), opacity=(cap, 1))
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


def test_gaussian_adam_and_stats_match_jax():
    rng = np.random.default_rng(1)
    cap = 64
    p0 = _params(rng, cap)
    alive = rng.uniform(size=cap) < 0.8
    lrs = dict(xyz=1.6e-4, features_dc=2.5e-3, features_rest=1.25e-4,
               identity=1e-2, opacity=5e-2, scaling=3e-3, rotation=1e-3)

    jp = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in p0.items()})
    jopt = JG.adam_init(jp)
    tp = G.GaussianParams(**{k: torch.from_numpy(v) for k, v in p0.items()})
    topt = G.adam_init(tp)
    for _ in range(3):
        g = _params(rng, cap)
        g["xyz"][:5] = 0.0                          # zero-gradient slots
        jp, jopt = JG.adam_update(
            jp, JG.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()}),
            jopt, lrs, jnp.asarray(alive))
        tp, topt = G.adam_update(
            tp, G.GaussianParams(**{k: torch.from_numpy(v)
                                    for k, v in g.items()}),
            topt, lrs, torch.from_numpy(alive))
    assert topt.step == int(jopt.step) == 3
    for k in p0:
        for ours, ref in ((tp, jp), (topt.mu, jopt.mu), (topt.nu, jopt.nu)):
            np.testing.assert_allclose(getattr(ours, k).numpy(),
                                       np.asarray(getattr(ref, k)),
                                       err_msg=k, **TOL)
        dead = ~alive
        np.testing.assert_array_equal(getattr(tp, k).numpy()[dead],
                                      p0[k][dead])

    # densification statistics over two steps
    jstate = JG.GaussianState(
        params=jp, alive=jnp.asarray(alive),
        max_radii2d=jnp.zeros(cap), xyz_grad_accum=jnp.zeros(cap),
        denom=jnp.zeros(cap), active_sh_degree=jnp.int32(1))
    tstate = G.GaussianState(params=tp, alive=torch.from_numpy(alive),
                             active_sh_degree=1, max_sh_degree=1)
    for _ in range(2):
        g2d = rng.normal(size=(cap, 2)).astype(np.float32)
        radii = rng.integers(0, 9, size=cap).astype(np.int32)
        vis = radii > 0
        jstate = JG.add_densification_stats(jstate, jnp.asarray(g2d),
                                            jnp.asarray(vis))
        jstate = JG.update_max_radii(jstate, jnp.asarray(radii),
                                     jnp.asarray(vis))
        tstate = G.add_densification_stats(tstate, torch.from_numpy(g2d),
                                           torch.from_numpy(radii),
                                           torch.from_numpy(vis))
    for k in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(tstate, k).numpy(),
                                   np.asarray(getattr(jstate, k)),
                                   err_msg=k, **TOL)
    assert G.one_up_sh_degree(tstate).active_sh_degree == 1
    assert G.one_up_sh_degree(tstate.replace(active_sh_degree=0)
                              ).active_sh_degree == 1


@pytest.mark.parametrize("which", ["umf", "pmf"])
def test_motion_optimizers_match_optax(which):
    """Three steps on identical gradients; the UMF's LambdaLR crosses its
    warm-up switch at warm_step=1, and every label group is present."""
    net = (TM.MotionNetwork() if which == "umf"
           else TM.PersonalizedMotionNetwork("face"))
    rng = np.random.default_rng(3)
    params = flax_tree(net, rng)
    load_motion_net(net, params, device="cpu")
    if which == "umf":
        tx, state = JO.umf_optimizer(params, total_iters=10, warm_step=1)
        opt, sched = TO.umf_optimizer(net, total_iters=10, warm_step=1)
    else:
        tx, state = JO.pmf_optimizer(params)
        opt, sched = TO.pmf_optimizer(net), None
    labels = {TO.label_for_name(n) for n, _ in net.named_parameters()}
    assert labels == ({"net", "encoder", "audio_att"} if which == "umf"
                      else {"net", "encoder", "audio_att", "align"})
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = dict(net.named_parameters())
    update = jax.jit(tx.update)
    for _ in range(3):
        grads = flax_tree(net, rng)
        upd, state = update(jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        for n, g in motion_state_dict(grads).items():
            tparams[n].grad = g
        opt.step()
        if sched is not None:
            sched.step()
    ref = motion_state_dict(jax.device_get(jparams))
    for n, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(),
                                   err_msg=n, **TOL)
