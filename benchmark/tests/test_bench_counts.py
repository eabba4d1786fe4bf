"""The yardstick's counts on hand-worked shapes."""

import pytest

from benchmark import counts as C


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert C.bound(3.35e12, 0) == pytest.approx(1.0)
    assert C.bound(0, 67e12) == pytest.approx(1.0)
    assert C.bound(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_composite_fwd_bound_on_a_hand_worked_tile():
    # one tile, 10 valid slots, 3 colours: rows (6 + 3) x 10, count 1,
    # output (3 + 2) x 256, all fp32; 100 pairs at 26 + 6 operations
    b = 4 * (9 * 10 + 1 + 5 * 256)
    assert C.composite_fwd_bound(10, 1, 100, 3) == pytest.approx(
        max(b / C.HBM_BYTES_PER_S, 100 * 32 / C.FP32_OPS_PER_S))


def test_composite_bwd_bound_counts_only_the_busy_tiles():
    busy = C.composite_bwd_bound(valid=1000, busy=10, tiles=10, pairs=5000,
                                 n_chan=3, n_aux=0, n_feat=9)
    # 1014 more idle tiles add their counts' 4 bytes each, never a zero row
    more = C.composite_bwd_bound(valid=1000, busy=10, tiles=1024,
                                 pairs=5000, n_chan=3, n_aux=0, n_feat=9)
    assert more - busy == pytest.approx(4 * 1014 / C.HBM_BYTES_PER_S)
    b = 4 * (9 * 1000 + 10 + 10 * 5 * 256 + 9 * 1000)
    assert busy == pytest.approx(max(b / C.HBM_BYTES_PER_S,
                                     5000 * (49 + 18) / C.FP32_OPS_PER_S))


def test_scatter_add_bound():
    b = 4 * (9 * 500 + 500 + 64 + 9 * 2000)
    assert C.scatter_add_bound(500, 64, 9, 2000) == pytest.approx(
        max(b / C.HBM_BYTES_PER_S, 9 * 500 / C.FP32_OPS_PER_S))


def test_mlp_and_audio_flops():
    assert C.mlp_flops([74, 64, 64, 11]) == 2 * (74 * 64 + 64 * 64 + 64 * 11)
    # deepspeech: 29 -> 32 -> 32 -> 64 -> 64 over 8, 4, 2, 1 steps, 8 windows
    conv = 2 * 3 * (29 * 32 * 8 + 32 * 32 * 4 + 32 * 64 * 2 + 64 * 64 * 1)
    head = 2 * (64 * 64 + 64 * 32)
    att = 2 * 3 * 8 * (32 * 16 + 16 * 8 + 8 * 4 + 4 * 2 + 2 * 1) + 2 * 64
    assert C.audio_flops(29) == 8 * (conv + head) + att


def test_frame_and_step_flops_grow_with_their_work():
    f = C.frame_flops(30000, 10000, (1, 2), 10 ** 7, 29, 512)
    assert C.frame_flops(30000, 10000, (1, 2), 2 * 10 ** 7, 29, 512) - f \
        == pytest.approx(10 ** 7 * C.pair_flops(3))
    # the mouth at SH degree 2 (the recipe's) evaluates 8 rest coefficients
    assert f - C.frame_flops(30000, 10000, (1, 1), 10 ** 7, 29, 512) \
        == 10000 * (C.SH_FLOPS[2] - C.SH_FLOPS[1])
    s = C.step_flops(2000, 1, 10 ** 6, 29, 512)
    assert C.step_flops(4000, 1, 10 ** 6, 29, 512) > s > 0
