"""The port's OpenCV operations (``instag_torch.data_utils.cv_ops``)
against OpenCV itself, byte for byte, over seeded sizes that shrink and
grow: the uint8 and float32 bilinear resizes, the integer-factor area
resize, the nearest resize and ``fillPoly`` (self-intersecting polygons and
mouth-like octagons, vertices inside the image, and polygons of 3 to 8
vertices up to half the image outside it). The float32 resize is held
where ``cv_ops`` states its domain (1 channel; 3 or 4 channels widened
less than 8-fold) and refuses the rest with ``ValueError``."""

import cv2
import numpy as np
import pytest

from instag_torch.data_utils import cv_ops
from tests.torch_cpu import one_torch_thread  # noqa: F401


def _sizes(seed, n=40, lo=2, hi=300):
    rng = np.random.default_rng(seed)
    return [tuple(int(v) for v in rng.integers(lo, hi, 4)) for _ in range(n)]


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_linear_uint8_is_opencvs(channels):
    rng = np.random.default_rng(channels)
    cases = _sizes(channels) + [(512, 512, 256, 256), (512, 512, 512, 512),
                                (840, 840, 256, 256), (96, 96, 512, 512),
                                (512, 512, 1024, 768)]
    for h, w, dh, dw in cases:
        img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        if channels == 1:
            img = img[..., 0]
        assert np.array_equal(cv_ops.resize_linear(img, (dw, dh)),
                              cv2.resize(img, (dw, dh))), (h, w, dh, dw)


@pytest.mark.parametrize("channels", [1, 3])
def test_linear_float32_is_opencvs(channels):
    rng = np.random.default_rng(10 + channels)
    cases = [c for c in _sizes(10 + channels, n=60, lo=8, hi=400)
             if c[3] < 8 * c[1]] + [(1024, 768, 512, 512),
                                    (1024, 768, 96, 96)]
    for h, w, dh, dw in cases:
        img = rng.normal(size=(h, w, channels)).astype(np.float32)
        if channels == 1:
            img = img[..., 0]
        assert np.array_equal(cv_ops.resize_linear_f32(img, (dw, dh)),
                              cv2.resize(img, (dw, dh))), (h, w, dh, dw)


@pytest.mark.parametrize("channels", [2, 3, 4])
def test_linear_float32_refuses_outside_its_domain(channels):
    """OpenCV's IPP route rounds 2 channels, and 3 or 4 widened 8-fold or
    more, otherwise: the port refuses them; 1 channel widened 8-fold and
    more is held."""
    rng = np.random.default_rng(20 + channels)
    for h, w, dh, dw in [(7, 5, 30, 40), (12, 9, 50, 200), (3, 3, 9, 24)]:
        img = rng.normal(size=(h, w, channels)).astype(np.float32)
        if channels == 2 or dw >= 8 * w:
            with pytest.raises(ValueError, match="widened less than 8-fold"):
                cv_ops.resize_linear_f32(img, (dw, dh))
        flat = img[..., 0].copy()
        assert np.array_equal(cv_ops.resize_linear_f32(flat, (dw, dh)),
                              cv2.resize(flat, (dw, dh)))


@pytest.mark.parametrize("factor", [2, 3, 4, 8])
def test_area_is_opencvs(factor):
    rng = np.random.default_rng(factor)
    for h, w in [(512, 512), (96, 80), (factor * 7, factor * 13)]:
        h, w = h // factor * factor, w // factor * factor
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.resize(img, (w // factor, h // factor),
                          interpolation=cv2.INTER_AREA)
        assert np.array_equal(cv_ops.resize_area(
            img, (w // factor, h // factor)), want), (h, w)
    with pytest.raises(ValueError, match="integer factor"):
        cv_ops.resize_area(img[:-1], (w // factor, h // factor))


def test_nearest_is_opencvs():
    rng = np.random.default_rng(5)
    for h, w, dh, dw in _sizes(5, n=60, lo=1, hi=600):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(cv_ops.resize_nearest(img, (dw, dh)), want)


def _mouth(rng, w, h):
    c = rng.uniform([10, 10], [w - 10, h - 10])
    r = rng.uniform(2, 9, 2)
    a = np.linspace(0, 2 * np.pi, 8, endpoint=False) + rng.uniform(0, 1)
    p = c + np.stack([r[0] * np.cos(a), r[1] * np.sin(a)], -1)
    return (p + rng.normal(0, 0.7, (8, 2))).astype(np.int32)


@pytest.mark.parametrize("kind", ["mouth", "random"])
def test_fill_poly_is_opencvs(kind):
    rng = np.random.default_rng(7)
    for _ in range(150):
        h, w = (int(v) for v in rng.integers(20, 160, 2))
        pts = (_mouth(rng, w, h) if kind == "mouth" else np.stack(
            [rng.integers(0, w, 8), rng.integers(0, h, 8)], -1)
            .astype(np.int32))
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = cv_ops.fill_poly(np.zeros((h, w), np.uint8), pts, 1)
        assert np.array_equal(got, want), pts.tolist()


@pytest.mark.parametrize("seed", [7, 8])
def test_fill_poly_outside_the_image_is_opencvs(seed):
    """Polygons whose vertices reach half the image beyond each side,
    among them the ones whose clipped edges are horizontal."""
    rng = np.random.default_rng(seed)
    for _ in range(600):
        h, w = (int(v) for v in rng.integers(20, 160, 2))
        n = int(rng.integers(3, 9))
        pts = np.stack([rng.integers(-w // 2, w + w // 2, n),
                        rng.integers(-h // 2, h + h // 2, n)],
                       -1).astype(np.int32)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = cv_ops.fill_poly(np.zeros((h, w), np.uint8), pts, 1)
        assert np.array_equal(got, want), (h, w, pts.tolist())
    # a clipped edge that is one point: its edge keeps the clipped x
    pts = np.array([[-24, 86], [159, 53], [53, 108]], np.int32)
    want = np.zeros((75, 119), np.uint8)
    cv2.fillPoly(want, [pts], 1)
    assert want[53:60, 118].all()
    assert np.array_equal(cv_ops.fill_poly(np.zeros((75, 119), np.uint8),
                                           pts, 1), want)
