"""The port's math utilities, camera helpers and Gaussian activations
against the JAX package on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.models import gaussians as JG
from instag_tpu.utils import general as JGen
from instag_tpu.utils import graphics as JGr
from instag_tpu.utils import sh as JSH
from instag_torch.io.from_jax import gaussian_state
from instag_torch.utils import general as TGen
from instag_torch.utils import graphics as TGr
from instag_torch.utils import sh as TSH
from tests.torch_cpu import one_torch_thread  # noqa: F401


def _dirs(n=64, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("deg", range(9))
def test_sh_basis_and_eval_match_jax(deg):
    """Degrees 0-4 are the explicit polynomials, 5-8 the recurrence."""
    dirs = _dirs(seed=deg)
    ref = np.asarray(JSH.sh_basis(deg, jnp.asarray(dirs)))
    out = TSH.sh_basis(deg, torch.from_numpy(dirs)).numpy()
    assert out.shape == (64, (deg + 1) ** 2)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    sh = np.random.default_rng(9).normal(
        size=(64, 3, (deg + 1) ** 2 + 2)).astype(np.float32)
    np.testing.assert_allclose(
        TSH.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)).numpy(),
        np.asarray(JSH.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))),
        atol=1e-4)


def test_general_utils_match_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q[0] = 0.0                                     # a dead padded slot
    p = rng.uniform(0.01, 0.99, 32).astype(np.float32)
    rgb = rng.uniform(0, 1, (32, 3)).astype(np.float32)
    qn = TGen.safe_normalize(torch.from_numpy(q))
    np.testing.assert_allclose(
        qn.numpy(), np.asarray(JGen.safe_normalize(jnp.asarray(q))),
        atol=1e-6)
    assert np.isfinite(qn.numpy()).all()
    np.testing.assert_allclose(
        TGen.quat_to_rotmat(qn).numpy(),
        np.asarray(JGen.quat_to_rotmat(jnp.asarray(qn.numpy()))), atol=1e-6)
    np.testing.assert_allclose(
        TGen.inverse_sigmoid(torch.from_numpy(p)).numpy(),
        np.asarray(JGen.inverse_sigmoid(jnp.asarray(p))), atol=1e-5)
    np.testing.assert_allclose(
        TSH.rgb2sh(torch.from_numpy(rgb)).numpy(),
        np.asarray(JSH.rgb2sh(jnp.asarray(rgb))), atol=1e-6)


def test_camera_matrices_match_jax():
    R = np.linalg.qr(np.random.default_rng(2).normal(size=(3, 3)))[0]
    t = np.array([0.1, -0.2, 3.0])
    for args in [(R, t), (R, t, np.array([0.5, 0.0, -0.1]), 1.5)]:
        np.testing.assert_array_equal(TGr.world_to_view(*args),
                                      JGr.world_to_view(*args))
    np.testing.assert_array_equal(TGr.projection_matrix(0.01, 100.0, 0.4, 0.5),
                                  JGr.projection_matrix(0.01, 100.0, 0.4, 0.5))


def test_gaussian_activations_match_jax():
    rng = np.random.default_rng(3)
    C = 24
    fields = dict(
        xyz=rng.normal(size=(C, 3)), features_dc=rng.normal(size=(C, 1, 3)),
        features_rest=rng.normal(size=(C, 8, 3)),
        identity=np.zeros((C, 1)), scaling=rng.normal(-3, 1, (C, 3)),
        rotation=rng.normal(size=(C, 4)), opacity=rng.normal(size=(C, 1)))
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    alive = np.arange(C) < 20
    jstate = JG.GaussianState(
        params=JG.GaussianParams(**{k: jnp.asarray(v)
                                    for k, v in fields.items()}),
        alive=jnp.asarray(alive), max_radii2d=jnp.zeros(C),
        xyz_grad_accum=jnp.zeros(C), denom=jnp.zeros(C),
        active_sh_degree=jnp.int32(2), max_sh_degree=2)
    tstate = gaussian_state(fields, alive, 2, 2, device="cpu")
    assert tstate.capacity == C and int(tstate.alive.sum()) == 20
    for name in ("get_scaling", "get_opacity", "get_rotation",
                 "get_features"):
        np.testing.assert_allclose(getattr(tstate, name)().numpy(),
                                   np.asarray(getattr(jstate, name)()),
                                   atol=1e-6, err_msg=name)
