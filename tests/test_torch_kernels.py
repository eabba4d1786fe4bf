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
    cnt = np.array([0, K, 5, K // 2 + 3, K, 0], np.int32)
    return _fill_tiles(cnt, TILES_X, n_chan, n_aux, K, seed), cnt


def _fill_tiles(cnt, tiles_x, n_chan, n_aux, K, seed):
    """Feature rows [F, len(cnt), K] for the valid prefixes ``cnt``: splats
    centred up to 8 px outside their tile, random conics, opacities and
    values; tile 1's first 8 splats saturate its centre pixels."""
    rng = np.random.default_rng(seed)
    F = -(-(6 + n_chan + n_aux) // 8) * 8
    feats = np.zeros((F, len(cnt), K), np.float32)
    for t in range(len(cnt)):
        n = cnt[t]
        ox, oy = (t % tiles_x) * 16, (t // tiles_x) * 16
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
    return feats


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


def _splat(feats, k, tx, ty, x, y, f):
    """Slot k's (alpha, ok) at tile-local pixel (x, y), in the type ``f``
    and in the kernel's order of operations (composite_common.cuh)."""
    px, py, ca, cb, cc, op = (f(v) for v in feats[:6, k])
    dx, dy = f(x) - (px - f(tx * 16)), f(y) - (py - f(ty * 16))
    power = f(-0.5) * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = min(f(0.99), op * np.exp(power))
    return alpha, bool(power <= 0 and alpha >= f(1.0 / 255.0))


def _walk_pixel(feats, n, tx, ty, x, y, n_chan, n_aux, f=np.float64,
                with_stop=False):
    """The kernel's per-thread loop for one pixel, written out in the type
    ``f``: front to back, log-domain transmittance, stop at the first splat
    that does not contribute (``with_stop`` also returns that slot, or n,
    and each contributing slot's log T)."""
    nv = n_chan + n_aux
    acc, wsum, log_t, log_t_c = np.zeros(nv, f), f(0), f(0), f(0)
    stop, lts = n, {}
    for k in range(n):
        alpha, ok = _splat(feats, k, tx, ty, x, y, f)
        if not ok:
            continue
        log_t += np.log1p(-alpha)
        if np.exp(log_t) < f(1e-4):
            stop = k
            break
        w = np.exp(log_t) * alpha / (f(1) - alpha)
        lts[k] = log_t
        log_t_c += np.log1p(-alpha)
        wsum += w
        acc += w * feats[6:6 + nv, k].astype(f)
    out = np.concatenate([acc[:n_chan], [wsum, np.exp(log_t_c)],
                          acc[n_chan:]])
    return (out, stop, lts) if with_stop else out


def _grouped_carry(steps, f=np.float32):
    """composite_common.cuh's carry_group over a pixel's slots, 8 at a
    time: ``steps`` holds log1p(-alpha) where a slot is ok and 0 where it is
    not. Returns the stop slot (or n), T_final and each contributing slot's
    log T, recomputed as the forward kernel does: the group's running sum."""
    n = len(steps)
    log_t, done, stop, lts = f(0), False, n, {}
    for j0 in range(0, n, 8):
        group = [steps[j] if j < n else f(0) for j in range(j0, j0 + 8)]
        entry, run = log_t, log_t
        for s in group:
            run = run + s
        keep = set()
        if not done and run > f(-9):  # every slot's test passes
            log_t = run
            keep = {u for u, s in enumerate(group) if s < 0}
        else:
            for u, s in enumerate(group):
                if not done and s < 0:
                    nxt = log_t + s
                    if nxt > f(-9) or np.exp(nxt) >= f(1e-4):
                        log_t = nxt
                        keep.add(u)
                    else:
                        done, stop = True, j0 + u
        run = entry
        for u, s in enumerate(group):
            run = run + s
            if u in keep:
                lts[j0 + u] = run
    return stop, np.exp(log_t), lts


def test_grouped_carry_keeps_the_serial_decisions():
    """The carry that both kernels run (8-slot groups, one compare above
    log T = -9, adding 0 for slots that are not ok) gives the serial walk's
    stop slot, T_final bits and each contributing slot's log T (from which
    the forward forms the weight), in float32, on every pixel of the ragged
    busy tiles: tile 1 saturates after 8 splats at opacity 0.98, and tile 3
    is led by two such splats (T = 4e-4 after them, above the -9 shortcut)."""
    f = np.float32
    feats, cnt = make_busy_tiles(3, 0, 64)
    feats[:6, 3, :2] = feats[:6, 1, :2]
    feats[0, 3, :2] = 3 * 16 + 8   # tile 3's centre
    n_slow = 0
    for t in np.flatnonzero(cnt):
        tx, ty, n = t % BUSY_TILES_X, t // BUSY_TILES_X, int(cnt[t])
        for p in range(256):
            x, y = p % 16, p // 16
            ref, stop, lts = _walk_pixel(feats[:, t], n, tx, ty, x, y, 3, 0,
                                         f, with_stop=True)
            steps = []
            for k in range(n):
                alpha, ok = _splat(feats[:, t], k, tx, ty, x, y, f)
                steps.append(np.log1p(-alpha) if ok else f(0))
            g_stop, t_final, g_lts = _grouped_carry(steps)
            assert g_stop == stop and g_lts == lts, (t, p)
            assert np.float32(t_final).view(np.uint32) == \
                np.float32(ref[3 + 1]).view(np.uint32), (t, p)
            n_slow += stop < n
    assert n_slow > 0   # some pixels stop, through the exact test


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


BUSY_TILES_X = 4


def make_busy_tiles(n_chan, n_aux, K, seed=3):
    """Twelve tiles (4 x 3), ten of them busy, with ragged counts: 0, 1, K,
    counts that are no multiple of the kernel's 32-slot batches or 8-slot
    groups, and tile 1 full and saturating early."""
    cnt = np.minimum(np.array([1, K, 7, 33, K - 1, 0, 45, K // 2 + 3, 63, 0,
                               K, 9]), K).astype(np.int32)
    return _fill_tiles(cnt, BUSY_TILES_X, n_chan, n_aux, K, seed), cnt


def _busy_case(n_chan, n_aux, K):
    feats, cnt = make_busy_tiles(n_chan, n_aux, K)
    g = np.random.default_rng(4).normal(
        size=(len(cnt), n_chan + 2 + n_aux, 256)).astype(np.float32)
    return (torch.from_numpy(feats).cuda(), torch.from_numpy(cnt).cuda(),
            torch.from_numpy(g).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [64, 256])
@pytest.mark.parametrize("n_chan,n_aux", [(8, 2), (8, 0), (3, 4)])
def test_backward_kernel_matches_plain_on_busy_tiles(n_chan, n_aux, K):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    f, c, g = _busy_case(n_chan, n_aux, K)
    out = composite_bwd(f, c, g, BUSY_TILES_X, n_chan, n_aux)
    ref = composite_bwd_plain(f, c, g, BUSY_TILES_X, n_chan, n_aux)
    torch.cuda.synchronize()
    # the same tolerance as test_backward_kernel_matches_plain_on_card
    scale = float(ref.abs().max())
    torch.testing.assert_close(out, ref, atol=1e-4 * scale, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [64, 256])
@pytest.mark.parametrize("n_chan,n_aux", [(8, 2), (8, 0), (3, 4)])
def test_kernel_matches_plain_on_busy_tiles(n_chan, n_aux, K):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    f, c, _ = _busy_case(n_chan, n_aux, K)
    out = composite_fwd(f, c, BUSY_TILES_X, n_chan, n_aux)
    ref = composite_fwd_plain(f, c, BUSY_TILES_X, n_chan, n_aux)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=KERNEL_ATOL, rtol=0)


@pytest.mark.cuda
def test_kernel_is_deterministic():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    f, c, _ = _busy_case(8, 2, 256)
    first = composite_fwd(f, c, BUSY_TILES_X, 8, 2)
    second = composite_fwd(f, c, BUSY_TILES_X, 8, 2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _layout(name, n_chan=8, n_aux=2):
    """Tile layouts for the kernel's choice of CTAs a busy tile, which it
    makes on the card from the busy-tile count. On an H100 (3 x 132
    resident split CTAs) busy_1, busy_40, busy_80 and busy_150 take 16, 8,
    4 and 2 CTAs a busy tile, busy_300 and busy_1024 one thread a pixel.
    twelve_k61 (ten busy tiles, K = 61) also takes the 4-byte staging."""
    if name.startswith("twelve"):
        K = 61 if name.endswith("k61") else 64
        feats, cnt = make_busy_tiles(n_chan, n_aux, K)
        return feats, cnt, BUSY_TILES_X
    if name == "one_of_64":
        cnt = np.zeros(64, np.int32)
        cnt[1] = 64   # the tile that saturates
        return _fill_tiles(cnt, 8, n_chan, n_aux, 64, 6), cnt, 8
    n_busy = int(name.split("_")[1])
    rng = np.random.default_rng(n_busy)
    cnt = np.zeros(1024, np.int32)
    others = np.setdiff1d(np.arange(1024), [1])
    busy = np.concatenate([[1], rng.choice(others, n_busy - 1,
                                           replace=False)])
    cnt[busy] = rng.integers(1, 65, n_busy)
    cnt[busy[-1]] = 64
    return _fill_tiles(cnt, 32, n_chan, n_aux, 64, 8), cnt, 32


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["one_of_64", "twelve", "twelve_k61",
                                  "busy_1", "busy_40", "busy_80",
                                  "busy_150", "busy_300", "busy_1024"])
def test_kernel_matches_plain_at_every_split(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    feats, cnt, tiles_x = _layout(name)
    f, c = torch.from_numpy(feats).cuda(), torch.from_numpy(cnt).cuda()
    out = composite_fwd(f, c, tiles_x, 8, 2)
    ref = composite_fwd_plain(f, c, tiles_x, 8, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=KERNEL_ATOL, rtol=0)


@pytest.mark.cuda
def test_split_and_one_thread_a_pixel_agree():
    """The same twelve tiles alone (many CTAs a busy tile) and as the first
    twelve of 1024 busy tiles (one thread a pixel): T_final bitwise equal,
    the sums within float32 rounding of their order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    small, cnt = make_busy_tiles(8, 2, 64)
    big_cnt = np.random.default_rng(9).integers(1, 65, 1024).astype(np.int32)
    big_cnt[:12] = cnt
    big = _fill_tiles(big_cnt, BUSY_TILES_X, 8, 2, 64, 10)
    big[:, :12] = small
    out_s = composite_fwd(torch.from_numpy(small).cuda(),
                          torch.from_numpy(cnt).cuda(), BUSY_TILES_X, 8, 2)
    out_b = composite_fwd(torch.from_numpy(big).cuda(),
                          torch.from_numpy(big_cnt).cuda(), BUSY_TILES_X, 8,
                          2)[:12]
    torch.cuda.synchronize()
    assert torch.equal(out_s[:, 9], out_b[:, 9])
    torch.testing.assert_close(out_s, out_b, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_backward_kernel_is_deterministic():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    f, c, g = _busy_case(8, 2, 256)
    first = composite_bwd(f, c, g, BUSY_TILES_X, 8, 2)
    second = composite_bwd(f, c, g, BUSY_TILES_X, 8, 2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("F,n", [(16, 200), (3, 101)])
def test_scatter_kernel_skips_out_of_range_ids(F, n):
    """Ids shared across tiles, cnt of 0 and K, and ids outside [0, n),
    which the kernel skips, against a float64 sum of the valid adds; F * n
    = 303 also leaves the zeroing a tail past its 16-byte stores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(1)
    nt, K = 24, 64
    g = rng.normal(size=(F, nt, K)).astype(np.float32)
    ids = rng.integers(-20, n + 20, size=(nt, K)).astype(np.int32)
    cnt = rng.integers(1, K, size=nt).astype(np.int32)
    cnt[[0, 5]], cnt[[3, 17]] = 0, K
    ref = np.zeros((F, n))
    for t in range(nt):
        for j in range(cnt[t]):
            if 0 <= ids[t, j] < n:
                ref[:, ids[t, j]] += g[:, t, j]
    out = scatter_add_tiles(torch.from_numpy(g).cuda(),
                            torch.from_numpy(ids).cuda(),
                            torch.from_numpy(cnt).cuda(), n)
    torch.cuda.synchronize()
    # atomics add in no fixed order: float32 rounding of ~10-term sums
    np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=1e-5, atol=1e-5)


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
