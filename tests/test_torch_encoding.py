"""The port's frequency encoding, encoder factory and GridRenderer against
the JAX package's, on the same inputs and weights."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.models.grid_renderer import GridRenderer as JGridRenderer
from instag_tpu.ops import encoding as JE
from instag_tpu.ops import freq as JFQ
from instag_tpu.ops import hashgrid as JH
from instag_torch.io.checkpoints import flax_params
from instag_torch.io.from_jax import load_motion_net
from instag_torch.models.grid_renderer import GridRenderer
from instag_torch.ops import encoding as TE
from instag_torch.ops import freq as TFQ
from instag_torch.ops import hashgrid as TH
from tests.torch_cpu import one_torch_thread  # noqa: F401

TOL = 1e-6


def _points(n=300, dim=3, lo=-1.05, hi=1.05, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, dim)).astype(
        np.float32)


@pytest.mark.parametrize("degree,include", [(6, True), (4, False), (10, True)])
def test_freq_encode_matches_jax(degree, include):
    x = _points(dim=3)
    ref = np.asarray(JFQ.freq_encode(jnp.asarray(x), degree, include))
    out = TFQ.freq_encode(torch.from_numpy(x), degree, include).numpy()
    assert out.shape == ref.shape
    assert TFQ.freq_output_dim(3, degree, include) == \
        JFQ.freq_output_dim(3, degree, include) == ref.shape[-1]
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


# small grids: the factory's defaults hold a 2^19 table a level
GRID = dict(num_levels=4, level_dim=2, base_resolution=4,
            log2_hashmap_size=10, desired_resolution=64)


@pytest.mark.parametrize("kind,kw", [
    ("None", {}),
    ("frequency", {"multires": 5}),
    ("sphere_harmonics", {"degree": 4}),
    ("sphere_harmonics", {"degree": 2}),
    ("hashgrid", GRID),
    ("tiledgrid", GRID),
], ids=["none", "frequency", "sh4", "sh2", "hashgrid", "tiledgrid"])
def test_get_encoder_matches_jax(kind, kw):
    j_spec, j_dim = JE.get_encoder(kind, input_dim=3, **kw)
    t_spec, t_dim = TE.get_encoder(kind, input_dim=3, **kw)
    assert t_dim == j_dim
    x = _points(dim=3)
    if kind == "sphere_harmonics":
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    if kind in ("hashgrid", "tiledgrid"):
        # the JAX config's onehot_threshold picks an XLA lowering only
        j_fields = dataclasses.asdict(j_spec)
        j_fields.pop("onehot_threshold")
        assert dataclasses.asdict(t_spec) == j_fields
        assert t_spec.total_params() == j_spec.total_params()
        emb = np.random.default_rng(1).uniform(
            -0.3, 0.3, (t_spec.total_params(), t_spec.level_dim)).astype(
            np.float32)
        ref = np.asarray(JH.hashgrid_encode_jit(j_spec, jnp.asarray(emb),
                                                jnp.asarray(x)))
        out = TH.hashgrid_encode(t_spec, torch.from_numpy(emb),
                                 torch.from_numpy(x)).numpy()
    else:
        ref = np.asarray(j_spec(jnp.asarray(x)))
        out = t_spec(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and out.shape[-1] == t_dim
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_get_encoder_refuses_an_unknown_name():
    for get in (JE.get_encoder, TE.get_encoder):
        with pytest.raises(NotImplementedError, match="Unknown encoding"):
            get("fourier")


@pytest.fixture(scope="module")
def grid_renderer():
    """The JAX GridRenderer's init tree and one forward of it."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.9, 0.9, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    net = JGridRenderer()
    # flax's init under one jit: eager, it runs ~3600 operations one by one
    params = jax.device_get(jax.jit(net.init)(jax.random.key(0),
                                              jnp.asarray(x), jnp.asarray(d)))
    # the init table is +-1e-4; spread it so the grid shapes the output
    emb = params["params"]["encoder"]["embeddings"]
    params["params"]["encoder"]["embeddings"] = rng.uniform(
        -1.0, 1.0, emb.shape).astype(np.float32)
    sigma, rgb = jax.device_get(jax.jit(net.apply)(params, x, d))
    return params, x, d, sigma, rgb


def test_grid_renderer_forward_matches_jax(grid_renderer):
    params, x, d, sigma, rgb = grid_renderer
    net = load_motion_net(GridRenderer(), params, device="cpu")
    with torch.no_grad():
        t_sigma, t_rgb = net(torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(t_sigma.numpy(), sigma, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_rgb.numpy(), rgb, rtol=1e-5, atol=1e-6)


def test_grid_renderer_tree_matches_jax_init(grid_renderer):
    """The port's fresh GridRenderer as a flax tree has the JAX init tree's
    keys and shapes, and its table starts within the JAX init's range."""
    params = grid_renderer[0]
    tree = flax_params(GridRenderer())
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, params)
    assert np.abs(tree["params"]["encoder"]["embeddings"]).max() <= 1e-4
