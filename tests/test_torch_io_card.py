"""The JPEG paths of the frame reader and writer on the committed fixture
(``tests/torch_fixtures/frame_512.jpg``: one 512x512 frame of the JAX
package's ``generate_scene`` at quality 95, and ``frame_512_libjpeg.npz``,
its decode by PIL's libjpeg). This file imports nothing of JAX, so the
tests marked ``cuda`` also run on a machine that has a card and no JAX:

    python -m pytest tests/test_torch_io_card.py -m cuda --noconftest -q

On the CPU the reader decodes with PIL and must equal the committed
decode. On the card nvJPEG decodes the planes and ``csrc/jpeg_codec.cu``
applies libjpeg's output stage (fancy chroma upsampling, fixed-point
colour conversion), which ``test_libjpeg_output_stage`` pins down here
against PIL: libjpeg decodes a 4:2:0 file at half scale to its native
chroma planes, and the stage applied to them gives PIL's full-size decode
bit for bit. Only the IDCT then differs; the card test bounds the
differences at the values ``chip_smoke.py`` phase 12 measured
(PERF.md)."""

import os

import numpy as np
import pytest
import torch

from instag_torch.data import image_io

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "torch_fixtures", "frame_512.jpg")
DECODED = os.path.join(HERE, "torch_fixtures", "frame_512_libjpeg.npz")
NVJPEG_MAX = 3           # levels, any channel (measured 3)
NVJPEG_MEAN = 0.01       # levels (measured 0.0028)
NVJPEG_LUMA_MAX = 2.0    # levels of 0.299 R + 0.587 G + 0.114 B (1.6)


def _luma(img):
    img = np.asarray(img, np.float64)
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def _libjpeg_output_stage(y, cb, cr):
    """What ``ycc_to_rgb_kernel`` computes for 4:2:0: the h2v2 triangle
    filter on the chroma planes [H/2, W/2] (edges replicated), then
    libjpeg's 16-bit fixed-point YCbCr -> RGB; int arrays in, uint8 out."""
    def up(p):
        above = np.vstack([p[:1], p[:-1]])
        below = np.vstack([p[1:], p[-1:]])
        out = np.zeros((2 * p.shape[0], 2 * p.shape[1]), np.int64)
        for v, other in ((0, above), (1, below)):
            col = 3 * p + other
            left = np.hstack([col[:, :1], col[:, :-1]])
            right = np.hstack([col[:, 1:], col[:, -1:]])
            out[v::2, 0::2] = (3 * col + left + 8) >> 4
            out[v::2, 1::2] = (3 * col + right + 7) >> 4
        return out

    b, r = up(cb) - 128, up(cr) - 128
    rgb = np.stack([y + ((91881 * r + 32768) >> 16),
                    y + ((-22554 * b + 32768 - 46802 * r) >> 16),
                    y + ((116130 * b + 32768) >> 16)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def test_libjpeg_output_stage():
    from PIL import Image
    import io
    blob, ref = _fixture()
    full = Image.open(io.BytesIO(blob))
    full.draft("YCbCr", full.size)
    half = Image.open(io.BytesIO(blob))
    half.draft("YCbCr", (256, 256))         # chroma at its native size
    assert half.size == (256, 256)
    y = np.asarray(full).astype(np.int64)[..., 0]
    planes = np.asarray(half).astype(np.int64)
    np.testing.assert_array_equal(
        _libjpeg_output_stage(y, planes[..., 1], planes[..., 2]), ref)


def _fixture():
    with open(FIXTURE, "rb") as f:
        return f.read(), np.load(DECODED)["image"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: nvJPEG runs on the card only")
    return torch.device("cuda")


def test_fixture_decode_on_the_cpu_is_libjpeg():
    blob, ref = _fixture()
    assert image_io.jpeg_size(blob) == (512, 512)
    out = image_io.decode_jpegs([blob], "cpu")
    assert out.shape == (1, 512, 512, 3) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out[0].numpy(), ref)


@pytest.mark.cuda
def test_fixture_decode_on_the_card_is_near_libjpeg():
    dev = _card()
    blob, ref = _fixture()
    out = image_io.decode_jpegs([blob, blob], dev)
    torch.cuda.synchronize()
    assert out.device.type == "cuda" and torch.equal(out[0], out[1])
    got = out[0].cpu().numpy().astype(np.int32)
    d = np.abs(got - ref.astype(np.int32))
    assert d.max() <= NVJPEG_MAX and d.mean() <= NVJPEG_MEAN
    assert np.abs(_luma(got) - _luma(ref)).max() <= NVJPEG_LUMA_MAX


@pytest.mark.cuda
def test_encode_on_the_card_round_trips():
    dev = _card()
    _, ref = _fixture()
    img = torch.from_numpy(ref).to(dev)
    blob = image_io.encode_jpeg(img, 95)
    assert blob[:2] == b"\xff\xd8" and image_io.jpeg_size(blob) == (512, 512)
    back = image_io.decode_jpegs([blob], dev)[0].cpu().numpy()
    err = (back.astype(np.float64) - ref) / 255.0
    assert -10 * np.log10(np.mean(err ** 2)) >= 40.0
