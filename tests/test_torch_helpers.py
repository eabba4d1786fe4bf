"""The port's small math helpers against the JAX package's on the same
inputs, on the CPU: quaternion normalisation, L = R(q) S, the covariance
L L^T and its upper triangle, the L2 loss and SH-to-RGB within 1e-6; and
the hash-grid table's init (shape, dtype, range, seeded)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instag_tpu.utils import general as JG
from instag_tpu.utils.losses import l2_loss as j_l2_loss
from instag_tpu.utils.sh import sh2rgb as j_sh2rgb
from instag_torch.ops.hashgrid import HashGridConfig, init_hashgrid
from instag_torch.utils import general as TG
from instag_torch.utils.losses import l2_loss
from instag_torch.utils.sh import sh2rgb
from tests.torch_cpu import one_torch_thread  # noqa: F401

TOL = 1e-6


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q[0] = 0.0                       # the guarded zero quaternion
    s = rng.uniform(0.001, 0.2, (64, 3)).astype(np.float32)
    return q, s


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", ["quat_normalize", "build_scaling_rotation",
                                  "covariance_from_scaling_rotation",
                                  "strip_symmetric"])
def test_general_matches_jax(inputs, name):
    q, s = inputs
    qn_t = TG.quat_normalize(torch.from_numpy(q))
    qn_j = JG.quat_normalize(jnp.asarray(q))
    if name == "quat_normalize":
        _close(qn_t, qn_j)
    elif name == "build_scaling_rotation":
        _close(TG.build_scaling_rotation(torch.from_numpy(s), qn_t),
               JG.build_scaling_rotation(jnp.asarray(s), qn_j))
    else:
        cov_t = TG.covariance_from_scaling_rotation(torch.from_numpy(s), qn_t)
        cov_j = JG.covariance_from_scaling_rotation(jnp.asarray(s), qn_j)
        if name == "strip_symmetric":
            _close(TG.strip_symmetric(cov_t), JG.strip_symmetric(cov_j))
        else:
            _close(cov_t, cov_j)


def test_l2_loss_and_sh2rgb_match_jax():
    rng = np.random.default_rng(1)
    x, y = rng.random((2, 3, 32, 24)).astype(np.float32)
    _close(l2_loss(torch.from_numpy(x), torch.from_numpy(y)),
           j_l2_loss(jnp.asarray(x), jnp.asarray(y)))
    sh = rng.normal(size=(100, 3)).astype(np.float32)
    _close(sh2rgb(torch.from_numpy(sh)), j_sh2rgb(jnp.asarray(sh)))


def test_init_hashgrid():
    cfg = HashGridConfig(input_dim=2, num_levels=4, level_dim=2,
                         base_resolution=16, log2_hashmap_size=10)
    a = init_hashgrid(cfg, torch.Generator().manual_seed(3))
    b = init_hashgrid(cfg, torch.Generator().manual_seed(3))
    assert a.shape == (cfg.total_params(), 2) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert a.abs().max() <= 1e-4 and a.min() < -5e-5 and a.max() > 5e-5
    wide = init_hashgrid(cfg, torch.Generator().manual_seed(3),
                         torch.float64)
    assert wide.dtype == torch.float64
