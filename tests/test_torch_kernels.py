"""The port's kernel wrappers and their plain versions, without JAX.

This file imports nothing of JAX, so the tests marked ``cuda`` also run on a
machine that has a card and no JAX:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

On the CPU the wrappers run the plain PyTorch versions; the CUDA kernels
have no CPU mode, so their comparisons with the plain versions skip here.
"""

import shutil

import numpy as np
import pytest
import torch

from instag_torch import kernels
from instag_torch.ops.composite import (composite_bwd, composite_bwd_plain,
                                        composite_fwd, composite_fwd_plain)
from instag_torch.ops.scatter import scatter_add_tiles, scatter_add_tiles_plain

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


def _cotangent(n_chan, n_aux, seed=9):
    return np.random.default_rng(seed).normal(
        size=(T, n_chan + 2 + n_aux, 256)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_chan,n_aux", [(8, 2), (8, 0)])
def test_backward_kernel_matches_plain_on_card(n_chan, n_aux):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    feats, cnt = make_tiles(n_chan, n_aux, 256)
    f = torch.from_numpy(feats).cuda()
    c = torch.from_numpy(cnt).cuda()
    g = torch.from_numpy(_cotangent(n_chan, n_aux)).cuda()
    before = composite_bwd.launches
    out = composite_bwd(f, c, g, TILES_X, n_chan, n_aux)
    torch.cuda.synchronize()
    assert composite_bwd.launches == before + 1
    ref = composite_bwd_plain(f, c, g, TILES_X, n_chan, n_aux)
    # the kernel sums each slot's 256 pixels in another order than the
    # plain version's reductions: tolerance relative to the largest term
    scale = float(ref.abs().max())
    torch.testing.assert_close(out, ref, atol=1e-4 * scale, rtol=1e-3)
    with pytest.raises(ValueError, match="g shape"):
        composite_bwd(f, c, g[:, 1:].contiguous(), TILES_X, n_chan, n_aux)


@pytest.mark.cuda
def test_scatter_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    F, nt, K, n = 16, 13, 256, 512
    g = torch.from_numpy(rng.normal(size=(F, nt, K)).astype(np.float32)).cuda()
    ids = torch.from_numpy(rng.integers(0, n // 8, size=(nt, K)
                                        ).astype(np.int32)).cuda()
    cnt = torch.from_numpy(rng.integers(0, K + 1, size=(nt,)
                                        ).astype(np.int32)).cuda()
    before = scatter_add_tiles.launches
    out = scatter_add_tiles(g, ids, cnt, n)
    torch.cuda.synchronize()
    assert scatter_add_tiles.launches == before + 1
    # atomics add in no fixed order: float32 rounding of ~100-term sums
    torch.testing.assert_close(out, scatter_add_tiles_plain(g, ids, cnt, n),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="int32"):
        scatter_add_tiles(g, ids.long(), cnt, n)


def test_library_path_follows_sources_and_headers(tmp_path, monkeypatch):
    """An edited header rebuilds every library; an edited source only its
    own (on a copy of csrc/)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    names = ("composite_fwd", "composite_bwd", "scatter_add")

    def paths():
        return {n: kernels.library_path(n) for n in names}

    start = paths()
    assert len(set(start.values())) == 3
    header = csrc / "composite_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = paths()
    assert all(edited[n] != start[n] for n in names)
    src = csrc / "scatter_add.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = paths()
    assert again["scatter_add"] != edited["scatter_add"]
    assert again["composite_fwd"] == edited["composite_fwd"]
