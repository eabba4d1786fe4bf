"""The OpenCV image operations of the preprocessing tasks, in numpy.

The card's machine is not promised OpenCV, so the port computes what the
JAX package asks of ``cv2`` itself, byte for byte as OpenCV 5.0 computes it
on x86 (its universal-intrinsics paths and its IPP HAL), on both machines:

  * ``resize_area``: ``INTER_AREA`` at an integer factor on uint8 (each
    output the block's sum times ``1 / area`` in float32, rounded half to
    even; at a factor of 2 the sum plus 2, shifted by 2);
  * ``resize_linear``: ``INTER_LINEAR`` on uint8, fixed point with 11-bit
    coefficients (a horizontal pass into int32, a vertical pass on the
    rows shifted by 4 that keeps the high halves of the 16-bit products);
    ``resize_linear_window`` the same of a zero canvas holding an image,
    reading only the canvas pixels the taps touch;
  * ``resize_linear_f32``: ``INTER_LINEAR`` on float32, ``s0 + f (s1 -
    s0)`` with the fraction from float64 and one rounding (a fused
    multiply-add), horizontally and then vertically, of 1 channel, or of
    3 or 4 channels widened less than 8-fold; outside that domain
    (OpenCV's IPP route rounds 2 channels, and 3 or 4 widened 8-fold or
    more, otherwise) it raises ``ValueError``. No caller comes near it;
  * ``resize_nearest``: ``INTER_NEAREST``;
  * ``fill_poly``: ``fillPoly`` of one polygon with 8-connected edges,
    vertices inside or outside the image (OpenCV 5 builds the edge of a
    clipped segment from its clipped x and, unless the clipped segment is
    horizontal, its clipped y).

Sizes are ``(width, height)``, as ``cv2.resize`` takes them.
"""

from __future__ import annotations

import numpy as np

_COEF_BITS = 11
_XY_SHIFT = 16


def _src_pos(ssize: int, dsize: int, dtype) -> tuple[np.ndarray, np.ndarray]:
    """Each output's source position: its floor and its fraction."""
    f = ((np.arange(dsize) + 0.5) * (ssize / dsize) - 0.5).astype(dtype)
    s = np.floor(f).astype(np.int64)
    return s, (f - s).astype(dtype)


def _clamped(ssize: int, dsize: int, dtype):
    """Horizontal taps: a position left of the first or right of the last
    source pixel takes that pixel alone."""
    s, fr = _src_pos(ssize, dsize, dtype)
    out = (s < 0) | (s >= ssize - 1)
    fr[out] = 0
    s = np.clip(s, 0, ssize - 1)
    return s, np.minimum(s + 1, ssize - 1), fr


def _clipped(ssize: int, dsize: int, dtype):
    """Vertical taps: the fraction kept, the rows clipped into the image."""
    s, fr = _src_pos(ssize, dsize, dtype)
    return np.clip(s, 0, ssize - 1), np.clip(s + 1, 0, ssize - 1), fr


def _as_hwc(img: np.ndarray) -> tuple[np.ndarray, bool]:
    return (img[..., None], True) if img.ndim == 2 else (img, False)


def _linear_u8(sample, shape: tuple[int, int], size: tuple[int, int]):
    """``INTER_LINEAR`` of a uint8 source [H, W, C] of ``shape`` (H, W)
    read through ``sample(rows, cols)``, which returns the source's pixels
    at those rows and columns: only the rows and columns the taps touch
    are read."""
    dw, dh = size
    one = 1 << _COEF_BITS
    x0, x1, fx = _clamped(shape[1], dw, np.float32)
    y0, y1, fy = _clipped(shape[0], dh, np.float32)
    ax1 = np.rint(fx * one).astype(np.int32)[None, :, None]
    ax0 = np.rint((1 - fx) * one).astype(np.int32)[None, :, None]
    by1 = np.rint(fy * one).astype(np.int32)[:, None, None]
    by0 = np.rint((1 - fy) * one).astype(np.int32)[:, None, None]
    rows, ry = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    cols, cx = np.unique(np.concatenate([x0, x1]), return_inverse=True)
    a = sample(rows, cols).astype(np.int32)
    h = a[:, cx[:dw]] * ax0 + a[:, cx[dw:]] * ax1       # [rows, dw, C]
    out = ((((h[ry[:dh]] >> 4) * by0) >> 16)
           + (((h[ry[dh:]] >> 4) * by1) >> 16) + 2) >> 2
    return out.astype(np.uint8)


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (``INTER_LINEAR``) of uint8 [H, W(, C)]."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8, not {img.dtype}")
    if img.shape[:2] == size[::-1]:
        return img.copy()
    a, flat = _as_hwc(img)
    out = _linear_u8(lambda r, c: a[r][:, c], a.shape[:2], size)
    return out[..., 0] if flat else out


def resize_linear_window(img: np.ndarray, shape: tuple[int, int],
                         top: int, left: int,
                         size: tuple[int, int]) -> np.ndarray:
    """``resize_linear`` of a zero canvas of ``shape`` (H, W) holding the
    uint8 image [h, w, C] with its top-left pixel at (``top``, ``left``)
    (clipped to the canvas), without making the canvas: its size does not
    bound the memory."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear_window takes uint8, not {img.dtype}")
    if shape[0] <= 0 or shape[1] <= 0:
        raise ValueError(f"empty canvas {shape}")

    def sample(rows, cols):
        out = np.zeros((len(rows), len(cols), img.shape[2]), np.uint8)
        r, c = rows - top, cols - left
        rm = (r >= 0) & (r < img.shape[0])
        cm = (c >= 0) & (c < img.shape[1])
        out[np.ix_(rm, cm)] = img[r[rm]][:, c[cm]]
        return out
    if tuple(shape) == size[::-1]:
        return sample(np.arange(shape[0]), np.arange(shape[1]))
    return _linear_u8(sample, shape, size)


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product is exact in
    float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def resize_linear_f32(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (``INTER_LINEAR``) of float32 [H, W(, C)]."""
    if img.dtype != np.float32:
        raise TypeError(f"resize_linear_f32 takes float32, not {img.dtype}")
    dw, dh = size
    if img.shape[:2] == (dh, dw):
        return img.copy()
    a, flat = _as_hwc(img)
    if not flat and (a.shape[2] not in (3, 4) or dw >= 8 * a.shape[1]):
        raise ValueError(
            f"resize_linear_f32 holds OpenCV's bytes for 1 channel, and for "
            f"3 or 4 channels widened less than 8-fold; not {a.shape[2]} "
            f"channels from width {a.shape[1]} to {dw}")
    x0, x1, fx = _clamped(a.shape[1], dw, np.float64)
    y0, y1, fy = _clamped(a.shape[0], dh, np.float64)
    fx = fx.astype(np.float32)[None, :, None]
    fy = fy.astype(np.float32)[:, None, None]
    rows = _fma(fx, a[:, x1] - a[:, x0], a[:, x0])
    out = _fma(fy, rows[y1] - rows[y0], rows[y0])
    return out[..., 0] if flat else out


def resize_area(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_AREA)`` of uint8 [H, W(,
    C)] where ``size`` divides the image by one integer factor."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_area takes uint8, not {img.dtype}")
    dw, dh = size
    h, w = img.shape[:2]
    k = h // dh
    if k < 1 or h != k * dh or w != k * dw:
        raise ValueError(f"resize_area shrinks by one integer factor; "
                         f"{(w, h)} -> {size} is not one")
    a, flat = _as_hwc(img)
    s = a.reshape(dh, k, dw, k, a.shape[2]).astype(np.int64).sum((1, 3))
    if k == 2:
        out = (s + 2) >> 2
    else:
        out = np.rint(s.astype(np.float32) * np.float32(1.0 / (k * k)))
    out = out.astype(np.uint8)
    return out[..., 0] if flat else out


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_NEAREST)``."""
    dw, dh = size
    h, w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / w))).astype(
        np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / h))).astype(
        np.int64), h - 1)
    return img[ys][:, xs]


def _clip_line(w: int, h: int, p1, p2):
    """OpenCV's ``clipLine``: the segment's part inside the image, and
    whether there is one."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _inside(w: int, h: int, *pts) -> bool:
    return all(0 <= x < w and 0 <= y < h for x, y in pts)


def _line8(img: np.ndarray, value, p1, p2) -> None:
    """OpenCV's 8-connected line (its ``LineIterator``, left to right)."""
    h, w = img.shape[:2]
    if not _inside(w, h, p1, p2):
        ok, p1, p2 = _clip_line(w, h, p1, p2)
        if not ok:
            return
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = -1 if y2 < y1 else 1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err, x, y = dx - 2 * dy, x1, y1
    for _ in range(dx + 1):
        img[y, x] = value
        minor = err < 0
        err += 2 * dx - 2 * dy if minor else -2 * dy
        if steep:
            y += sy
            x += minor
        else:
            x += 1
            y += sy if minor else 0


def _trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_poly(img: np.ndarray, pts, value=1) -> np.ndarray:
    """``cv2.fillPoly(img, [pts], value)`` in place on [H, W(, C)]: the
    polygon's edges drawn 8-connected, then each scanline filled between
    successive crossings (even-odd), the edges' x in 16.16 fixed point."""
    h, w = img.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    p0 = pts[-1]
    for p1 in pts:
        _line8(img, value, p0, p1)
        c0, c1 = p0, p1
        if not _inside(w, h, p0, p1):
            # OpenCV 5 takes the clipped x always, the clipped y only when
            # the clipped segment is not horizontal
            _, q0, q1 = _clip_line(w, h, p0, p1)
            if q0[1] != q1[1]:
                c0, c1 = q0, q1
            else:
                c0, c1 = (q0[0], p0[1]), (q1[0], p1[1])
        if p0[1] != p1[1]:
            dx = _trunc_div((c1[0] - c0[0]) << _XY_SHIFT, c1[1] - c0[1])
            top, c = (p0, c0) if p0[1] < p1[1] else (p1, c1)
            edges.append([top[1], max(p0[1], p1[1]),
                          (c[0] << _XY_SHIFT) + (top[1] - c[1]) * dx, dx])
        p0 = p1
    if len(edges) < 2:
        return img
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    y_end = min(max(e[1] for e in edges), h)
    one = (1 << _XY_SHIFT) - 1
    active, nxt = [], 0
    for y in range(edges[0][0], y_end):
        active = [e for e in active if e[1] != y]
        while nxt < len(edges) and edges[nxt][0] == y:
            active.append(edges[nxt])
            nxt += 1
        active.sort(key=lambda e: e[2])
        for a, b in zip(active[0::2], active[1::2]):
            x1 = (min(a[2], b[2]) + one) >> _XY_SHIFT
            x2 = max(a[2], b[2]) >> _XY_SHIFT
            if y >= 0 and x1 < w and x2 >= 0:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = value
            a[2] += a[3]
            b[2] += b[3]
    return img
