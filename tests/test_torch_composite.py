"""The port's fused composite, forward and backward, against the JAX
package's Pallas kernels (interpret mode) on the same random [F, T, K] tile
features.

On the CPU ``composite_fwd`` and ``composite_bwd`` run their plain PyTorch
versions; the CUDA kernels themselves are held against those plain versions
on the card (tests/test_torch_kernels.py, marked ``cuda``, and
chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.ops.pallas_composite import (CompositeStatic,
                                             composite_tiles_fused)
from instag_torch.ops.composite import CompositeFunction, composite_fwd
from tests.test_torch_kernels import T, TILES_X, make_tiles
from tests.torch_cpu import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("K", [64, 256])
@pytest.mark.parametrize("n_aux", [0, 4])
@pytest.mark.parametrize("n_chan", [3, 8])
def test_plain_matches_pallas_forward(n_chan, n_aux, K):
    feats, cnt = make_tiles(n_chan, n_aux, K, seed=n_chan + n_aux + K)
    static = CompositeStatic(16, TILES_X, n_chan, n_aux, interpret=True)
    ref = np.asarray(composite_tiles_fused(static, jnp.asarray(feats),
                                           jnp.asarray(cnt)))
    out = composite_fwd(torch.from_numpy(feats), torch.from_numpy(cnt),
                        TILES_X, n_chan, n_aux).numpy()
    assert out.shape == ref.shape == (T, n_chan + 2 + n_aux, 256)
    np.testing.assert_allclose(out, ref, atol=2e-5)
    # empty tiles: zeros, T_final = 1
    for t in (0, 5):
        np.testing.assert_array_equal(out[t, n_chan + 1], 1.0)
        np.testing.assert_array_equal(np.delete(out[t], n_chan + 1, 0), 0.0)
    # the saturated tile is opaque at the centre of its wide splats
    assert out[1, n_chan, 8 + 16 * 8] > 0.98


@pytest.mark.parametrize("n_chan,n_aux", [(8, 2), (3, 0)])
def test_plain_backward_matches_pallas_vjp(n_chan, n_aux):
    """K=256 runs the TPU kernel's two 128-slot chunks; tiles 0 and 5 are
    empty, tile 1 saturates within its first splats."""
    feats, cnt = make_tiles(n_chan, n_aux, 256, seed=3 + n_aux)
    g = np.random.default_rng(9).normal(
        size=(T, n_chan + 2 + n_aux, 256)).astype(np.float32)
    static = CompositeStatic(16, TILES_X, n_chan, n_aux, interpret=True)
    # under one jit: eager JAX interprets the kernel one operation at a time
    ref = np.asarray(jax.jit(lambda f, c, g: jax.vjp(
        lambda f: composite_tiles_fused(static, f, c), f)[1](g)[0])(
            jnp.asarray(feats), jnp.asarray(cnt), jnp.asarray(g)))

    f = torch.from_numpy(feats).requires_grad_(True)
    out = CompositeFunction.apply(f, torch.from_numpy(cnt), TILES_X, n_chan,
                                  n_aux)
    out.backward(torch.from_numpy(g))
    ours = f.grad.numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(ours, ref, atol=1e-4 * scale, rtol=1e-3)
    # empty tiles, rows past 6+C+A and slots past cnt carry no gradient
    assert not ours[:, [0, 5]].any() and not ours[6 + n_chan + n_aux:].any()
    assert not ours[:, 2, 5:].any()
    # the saturated tile: only its first splats reach the image
    assert not ours[:, 1, 16:].any() and ours[:, 1, :2].any()
