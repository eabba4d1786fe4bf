"""The port's composite wrapper and its plain version, without JAX.

This file imports nothing of JAX, so the tests marked ``cuda`` also run on a
machine that has a card and no JAX:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel has no
CPU mode, so its comparison with the plain version skips here.
"""

import numpy as np
import pytest
import torch

from instag_torch.ops.composite import composite_fwd, composite_fwd_plain

TILES_X = 3
T = 6          # 3 x 2 tiles
KERNEL_ATOL = 1e-4   # kernel vs plain on the card: expf/log1pf vs PyTorch's


def make_tiles(n_chan, n_aux, K, seed=0):
    """Random prefix-valid tile features: two empty tiles, one full tile
    that saturates within its first few splats, the rest partly filled."""
    rng = np.random.default_rng(seed)
    F = -(-(6 + n_chan + n_aux) // 8) * 8
    cnt = np.array([0, K, 5, K // 2 + 3, K, 0], np.int32)
    feats = np.zeros((F, T, K), np.float32)
    for t in range(T):
        n = cnt[t]
        ox, oy = (t % TILES_X) * 16, (t // TILES_X) * 16
        feats[0, t, :n] = ox + rng.uniform(-8, 24, n)
        feats[1, t, :n] = oy + rng.uniform(-8, 24, n)
        a = rng.uniform(0.01, 0.4, n)
        c = rng.uniform(0.01, 0.4, n)
        feats[2, t, :n] = a
        feats[3, t, :n] = rng.uniform(-0.6, 0.6, n) * np.sqrt(a * c)
        feats[4, t, :n] = c
        feats[5, t, :n] = rng.uniform(0.05, 0.99, n)
        feats[6:6 + n_chan + n_aux, t, :n] = rng.normal(
            size=(n_chan + n_aux, n))
    # tile 1: wide, nearly opaque splats -> transmittance < 1e-4 at the third
    # (opacity 0.98, not 0.99: two splats at the 0.99 clamp leave exactly
    # T = 1e-4, where the last bit of float32 rounding decides)
    feats[0, 1, :8] = 16 + 8
    feats[1, 1, :8] = 8
    feats[2, 1, :8] = feats[4, 1, :8] = 1e-3
    feats[3, 1, :8] = 0.0
    feats[5, 1, :8] = 0.98
    return feats, cnt


def test_pair_count_stops_at_saturation():
    feats, cnt = make_tiles(3, 0, 64)
    out, pairs = composite_fwd_plain(torch.from_numpy(feats),
                                     torch.from_numpy(cnt), TILES_X, 3,
                                     count_pairs=True)
    full = int(cnt.sum()) * 256
    assert 0 < pairs < full
    np.testing.assert_array_equal(
        out.numpy(), composite_fwd(torch.from_numpy(feats),
                                   torch.from_numpy(cnt), TILES_X, 3).numpy())


def _walk_pixel(feats, n, tx, ty, x, y, n_chan, n_aux):
    """The kernel's per-thread loop for one pixel, written out in float64:
    front to back, log-domain transmittance, stop at the first splat that
    does not contribute."""
    nv = n_chan + n_aux
    acc, wsum, log_t, log_t_c = np.zeros(nv), 0.0, 0.0, 0.0
    for k in range(n):
        px, py, ca, cb, cc, op = (float(v) for v in feats[:6, k])
        dx, dy = x - (px - tx * 16), y - (py - ty * 16)
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = min(0.99, op * np.exp(power))
        if not (power <= 0.0 and alpha >= 1.0 / 255.0):
            continue
        log_t += np.log1p(-alpha)
        if np.exp(log_t) < 1e-4:
            break
        w = np.exp(log_t) * alpha / (1.0 - alpha)
        log_t_c += np.log1p(-alpha)
        wsum += w
        acc += w * feats[6:6 + nv, k]
    return np.concatenate([acc[:n_chan], [wsum, np.exp(log_t_c)],
                           acc[n_chan:]])


@pytest.mark.parametrize("n_chan,n_aux", [(3, 0), (8, 4)])
def test_plain_matches_front_to_back_walk(n_chan, n_aux):
    feats, cnt = make_tiles(n_chan, n_aux, 64, seed=5)
    out = composite_fwd_plain(torch.from_numpy(feats), torch.from_numpy(cnt),
                              TILES_X, n_chan, n_aux).numpy()
    for t in (1, 2, 3, 4):
        for p in (0, 17, 136, 255):
            ref = _walk_pixel(feats[:, t].astype(np.float64), int(cnt[t]),
                              t % TILES_X, t // TILES_X, p % 16, p // 16,
                              n_chan, n_aux)
            np.testing.assert_allclose(out[t, :, p], ref, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_chan,n_aux", [(8, 0), (3, 4)])
def test_kernel_matches_plain_on_card(n_chan, n_aux):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    feats, cnt = make_tiles(n_chan, n_aux, 256)
    f = torch.from_numpy(feats).cuda()
    c = torch.from_numpy(cnt).cuda()
    before = composite_fwd.launches
    out = composite_fwd(f, c, TILES_X, n_chan, n_aux)
    torch.cuda.synchronize()
    assert composite_fwd.launches == before + 1
    ref = composite_fwd_plain(f, c, TILES_X, n_chan, n_aux)
    torch.testing.assert_close(out, ref, atol=KERNEL_ATOL, rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    feats, cnt = make_tiles(3, 0, 64)
    f = torch.from_numpy(feats).cuda()
    c = torch.from_numpy(cnt).cuda()
    with pytest.raises(ValueError, match="int32"):
        composite_fwd(f, c.long(), TILES_X, 3)
    with pytest.raises(ValueError, match="channel counts"):
        composite_fwd(f, c, TILES_X, 12, 8)
    with pytest.raises(ValueError, match="float32"):
        composite_fwd(f.double(), c, TILES_X, 3)
