"""The port's tile -> splat scatter-add against the JAX package's Pallas
kernel (interpret mode), at the shapes of tests/test_pallas_scatter.py.

On the CPU ``scatter_add_tiles`` runs its plain PyTorch version; the CUDA
kernel is held against it on the card (tests/test_torch_kernels.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.ops.pallas_scatter import scatter_add_tiles as j_scatter
from instag_torch.ops.rasterize import TileGather
from instag_torch.ops.scatter import scatter_add_tiles
from tests.torch_cpu import one_torch_thread  # noqa: F401


def _case(F, T, K, n, seed, cnt=None):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(F, T, K)).astype(np.float32)
    # duplicate-heavy ids (collisions within and across tiles)
    ids = rng.integers(0, max(n // 8, 4), size=(T, K)).astype(np.int32)
    if cnt is None:
        cnt = rng.integers(0, K + 1, size=(T,)).astype(np.int32)
    return g, ids, np.asarray(cnt, np.int32)


@pytest.mark.parametrize("F,T,K,n,cnt", [
    (4, 8, 16, 256, None), (16, 13, 32, 512, None),
    (3, 8, 8, 64, [0, 8, 0, 1, 8, 0, 7, 2])],
    ids=["small", "wide", "empty-and-full"])
def test_plain_matches_pallas_scatter(F, T, K, n, cnt):
    g, ids, cnt = _case(F, T, K, n, seed=F + T, cnt=cnt)
    ref = np.asarray(j_scatter(jnp.asarray(g), jnp.asarray(ids),
                               jnp.asarray(cnt), n, interpret=True))
    out = scatter_add_tiles(torch.from_numpy(g), torch.from_numpy(ids),
                            torch.from_numpy(cnt), n)
    assert out.shape == (F, n) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_tile_gather_backward_is_the_scatter():
    """TileGather's gradient equals autograd's through the masked gather."""
    rng = np.random.default_rng(2)
    F, N, T, K = 5, 128, 6, 16
    feats = torch.from_numpy(rng.normal(size=(F, N)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, N, size=(T, K)).astype(np.int32))
    valid = torch.arange(K)[None, :] < torch.from_numpy(
        rng.integers(0, K + 1, size=(T, 1)))
    g = torch.from_numpy(rng.normal(size=(F, T, K)).astype(np.float32))

    a = feats.clone().requires_grad_(True)
    out = TileGather.apply(a, ids, valid)
    out.backward(g)
    b = feats.clone().requires_grad_(True)
    ref = torch.where(valid[None], b[:, ids.long()], 0.0)
    ref.backward(g)
    torch.testing.assert_close(out, ref.detach(), rtol=0, atol=0)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)
