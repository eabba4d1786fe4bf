"""The port's fused composite against the JAX package's Pallas forward
kernel (interpret mode) on the same random [F, T, K] tile features.

On the CPU ``composite_fwd`` runs its plain PyTorch version; the CUDA
kernel itself is held against that plain version on the card
(tests/test_torch_kernels.py, marked ``cuda``, and chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.ops.pallas_composite import (CompositeStatic,
                                             composite_tiles_fused)
from instag_torch.ops.composite import composite_fwd
from tests.test_torch_kernels import T, TILES_X, make_tiles


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
