"""The port's LPIPS, its patch cut and the face step's LPIPS phase against
the JAX package, on the same numpy inputs and the JAX package's own LPIPS
parameters (its fixed-seed random-feature fallback, carried across by
``from_jax.lpips_state_dict`` or by the ``.npz`` both packages read).

Tolerances: ``patchify`` exact; LPIPS distances within rtol 1e-5 (fp32),
and their input gradients within rtol 1e-5 on top of an atol of 1e-5 of
the largest gradient (a gradient element near 0 is a difference of
rounded terms); the face step's loss within rtol 1e-5, and its gradients
as tests/test_torch_face.py holds them.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import instag_tpu.models.lpips as JL
from instag_tpu.config import OptimizationConfig as JOptConfig
from instag_tpu.models import gaussians as JG
from instag_tpu.models import motion as JM
from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
from instag_tpu.train import face as JF
from instag_tpu.train.optim import pmf_optimizer as j_pmf_opt
from instag_tpu.train.optim import umf_optimizer as j_umf_opt
from instag_tpu.utils.losses import patchify as j_patchify
import instag_torch.models.lpips as TL
from instag_torch.config import OptimizationConfig
from instag_torch.io.from_jax import (frame_batch, load_motion_net,
                                      lpips_state_dict, motion_state_dict,
                                      state_from_jax)
from instag_torch.models import gaussians as G
from instag_torch.models import motion as TM
from instag_torch.ops.rasterize import RasterizeConfig
from instag_torch.train.face import Flags, make_face_block
from instag_torch.utils.losses import patchify
from tests.test_torch_face import (B1, FIELDS, K, SIZE, _adam_mu, _close,
                                   _scene)
from tests.test_torch_motion import flax_tree
from tests.torch_cpu import one_torch_thread  # noqa: F401

RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_lpips():
    """The JAX package's LPIPS model and its random-feature params."""
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setenv("INSTAG_LPIPS_WEIGHTS", "/nonexistent/lpips_alex.npz")
        model, params, real = JL.load_lpips_params()
    assert real is False
    return model, jax.device_get(params)


def _port_lpips(params) -> TL.LPIPS:
    net = TL.LPIPS()
    net.load_state_dict(lpips_state_dict(params), strict=True)
    return net.requires_grad_(False)


@pytest.mark.parametrize("shape,ps", [((3, 64, 64), 32), ((3, 80, 100), 36),
                                      ((2, 33, 47), 16), ((3, 40, 40), 40)])
def test_patchify_matches_jax(shape, ps):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(patchify(torch.from_numpy(x), ps).numpy(),
                                  np.asarray(j_patchify(jnp.asarray(x), ps)))


def test_pools_floor_as_flax_valid():
    """At 32 px, conv_0 gives 7x7 and the two pools floor to 3x3 and 1x1."""
    taps = TL.AlexFeatures()(torch.zeros(1, 3, 32, 32))
    assert [tuple(t.shape[2:]) for t in taps] == [(7, 7), (3, 3), (1, 1),
                                                   (1, 1), (1, 1)]


@pytest.mark.parametrize("size", [32, 64])
def test_lpips_matches_jax(jax_lpips, size):
    model, params = jax_lpips
    rng = np.random.default_rng(size)
    a = rng.uniform(-1, 1, (3, 3, size, size)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)

    def j_loss(x):
        return jnp.sum(model.apply(params, x, jnp.asarray(b))
                       * jnp.arange(1.0, 4.0))
    ref = np.asarray(model.apply(params, jnp.asarray(a), jnp.asarray(b)))
    ref_g = np.asarray(jax.grad(j_loss)(jnp.asarray(a)))

    net = _port_lpips(params)
    x = torch.from_numpy(a).requires_grad_(True)
    d = net(x, torch.from_numpy(b))
    (d * torch.arange(1.0, 4.0)).sum().backward()
    np.testing.assert_allclose(d.detach().numpy(), ref, rtol=RTOL)
    assert (ref > 0).all()
    np.testing.assert_allclose(x.grad.numpy(), ref_g, rtol=RTOL,
                               atol=RTOL * float(np.abs(ref_g).max()))


def test_load_lpips_params_reads_the_jax_npz(jax_lpips, tmp_path,
                                             monkeypatch):
    """Both packages read one ``.npz`` (HWIO kernels) to the same model."""
    model, params = jax_lpips
    p = params["params"]
    path = str(tmp_path / "lpips_alex.npz")
    np.savez(path, **{k: np.asarray(v) for i in range(5) for k, v in (
        (f"conv_{i}_w", p["alex"][f"conv_{i}"]["kernel"]),
        (f"conv_{i}_b", p["alex"][f"conv_{i}"]["bias"]),
        (f"lin_{i}", p[f"lin_{i}"]))})
    monkeypatch.setenv("INSTAG_LPIPS_WEIGHTS", path)
    net, real = TL.load_lpips_params(device="cpu")
    assert real is True
    assert not any(q.requires_grad for q in net.parameters())
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(-1, 1, (2, 3, 40, 40)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        net(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(model.apply(params, jnp.asarray(a), jnp.asarray(b))),
        rtol=RTOL)


def test_lpips_fallback_warns_once(tmp_path, monkeypatch):
    monkeypatch.setenv("INSTAG_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setattr(TL, "_warned_fallback", False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        net, real = TL.load_lpips_params(device="cpu")
        net2, _ = TL.load_lpips_params(device="cpu")
    assert real is False
    assert sum("RANDOM FEATURES" in str(w.message) for w in rec) == 1
    for q, q2 in zip(net.parameters(), net2.parameters()):
        assert torch.equal(q, q2)       # fixed seed
    x = torch.rand(2, 3, 32, 32) * 2 - 1
    d = net(x, x.flip(0))
    assert torch.isfinite(d).all() and (d > 0).all()
    assert float(net(x, x).abs().max()) < 1e-6


def test_lpips_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.load_lpips_params()


@pytest.mark.parametrize("long", [False, True])
def test_face_step_with_lpips_matches_jax(jax_lpips, long):
    """One face step in the LPIPS phase (``use_lpips=1``, patch side 64 at
    64x64; ``long`` adds the lips crop of min(96, h, w) = 64 and drops the
    priors) against a one-step JAX ``make_face_block`` with ``lpips_fn``."""
    lp_model, lp_params = jax_lpips
    state, batch = _scene(has_priors=True)
    tnets = [TM.MotionNetwork(), TM.PersonalizedMotionNetwork("face")]
    params = [flax_tree(n, np.random.default_rng(50 + i))
              for i, n in enumerate(tnets)]
    t_state = state_from_jax(state, device="cpu")
    flags = dict(align=1.0, use_regs=1.0, use_sapiens=1.0, use_depth=1.0,
                 hair_paint=0.0, use_lpips=1.0)

    cfg = JConfig(SIZE, SIZE, max_per_tile=K, tile_chunk=8,
                  approx_topk=False, backend="xla")
    umf_tx, umf_opt = j_umf_opt(params[0])
    pmf_tx, pmf_opt = j_pmf_opt(params[1])
    block = JF.make_face_block(
        cfg, JOptConfig(), JM.MotionNetwork(),
        JM.PersonalizedMotionNetwork("face"), 1.0, True, umf_tx, pmf_tx,
        lambda lp, a, b: lp_model.apply(lp, a, b), (SIZE,), long,
        lips_crop=SIZE)
    j_flags = JF.Flags(**{k: jnp.ones((1,)) * v for k, v in flags.items()},
                       valid=jnp.ones((1,)))
    (_, j_gopt, _, j_umf_state, _, _, j_losses) = jax.device_get(block(
        state, JG.adam_init(state.params), params[0], umf_opt, params[1],
        pmf_opt, batch, jnp.zeros((1, 1), jnp.int32),
        jnp.ones((1,), jnp.int32), j_flags, jnp.zeros((1,), jnp.int32),
        lp_params))

    t_batch = frame_batch({k: (None if v is None else np.asarray(v))
                           for k, v in vars(batch).items()}, device="cpu")
    umf, pmf = (load_motion_net(n, p, device="cpu")
                for n, p in zip(tnets, params))
    t_block = make_face_block(RasterizeConfig(SIZE, SIZE, max_per_tile=K),
                              OptimizationConfig(), umf, pmf, 1.0, True,
                              device="cpu", long=long,
                              lpips=_port_lpips(lp_params),
                              lpips_patches=(SIZE,), lips_crop=SIZE)
    _, t_gopt, losses = t_block(t_state, G.adam_init(t_state.params),
                                t_batch, [0], [1], Flags(**flags), [0])
    np.testing.assert_allclose(float(losses[0]), float(j_losses[0]),
                               rtol=RTOL)
    for f in FIELDS:
        _close(getattr(t_gopt.mu, f) / (1 - B1),
               np.asarray(getattr(j_gopt.mu, f)) / (1 - B1), f)
    ref = motion_state_dict(_adam_mu(j_umf_state))
    for n, p in umf.named_parameters():
        _close(p.grad.numpy(), ref[n].numpy() / (1 - B1), n)

    # the same step on fresh nets without the LPIPS phase: the phase adds
    # a term
    umf, pmf = (load_motion_net(n, p, device="cpu")
                for n, p in zip(tnets, params))
    no_lp = make_face_block(RasterizeConfig(SIZE, SIZE, max_per_tile=K),
                            OptimizationConfig(), umf, pmf, 1.0, True,
                            device="cpu", long=long)
    _, _, base = no_lp(t_state, G.adam_init(t_state.params), t_batch, [0],
                       [1], Flags(**flags))
    assert float(losses[0]) > float(base[0]) + 1e-4
