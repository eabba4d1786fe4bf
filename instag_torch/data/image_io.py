"""Image files of a scene directory, without PIL, cv2 or pandas on the card.

  * PNG, on every device: decode with the standard library's ``zlib`` and
    numpy unfiltering (8-bit gray, RGB and RGBA, filter types 0-4, no
    interlace), equal to PIL's decode; encode as PIL's PNG writer encodes
    (its per-row filter choice, zlib at the default level with the
    filtered-data strategy, 64 KB IDAT chunks), so a written file is byte
    for byte PIL's.
  * JPEG: on the card through nvJPEG (``csrc/jpeg_codec.cu``, built by
    ``kernels.py``), decoding into a uint8 tensor on the card with libjpeg's
    chroma upsampling and colour conversion (only the IDCT differs from
    PIL's); on the CPU, only when the caller asks for it, through PIL,
    which must then be installed. Neither path falls back to the other.
"""

from __future__ import annotations

import ctypes
import io
import struct
import zlib

import numpy as np
import torch

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}          # color type -> channels
_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}
_IDAT_CHUNK = 65536                          # PIL's encoder buffer


# ---- PNG ------------------------------------------------------------------

def _chunks(data: bytes):
    pos = len(_PNG_SIG)
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int):
    """Rows [H, 1 + W bpp] of filter type + filtered bytes -> [H, W, bpp]."""
    kinds = raw[:, 0]
    filt = raw[:, 1:].reshape(height, width, bpp).astype(np.int32)
    if kinds.max(initial=0) > 4:
        raise ValueError("PNG row filter type above 4")
    # recon padded by one zero row above and one zero column to the left
    rec = np.zeros((height + 1, width + 1, bpp), np.int32)
    if (kinds <= 2).all():
        for r in range(height):
            row, up = filt[r], rec[r, 1:]
            if kinds[r] == 1:
                row = np.cumsum(row, axis=0)
            elif kinds[r] == 2:
                row = row + up
            rec[r + 1, 1:] = row & 0xFF
        return rec[1:, 1:].astype(np.uint8)
    # average and Paeth read the left neighbour's reconstruction: sweep the
    # anti-diagonals r + x = d, whose pixels depend only on earlier ones
    for d in range(height + width - 1):
        rows = np.arange(max(0, d - width + 1), min(height - 1, d) + 1)
        cols = d - rows
        a = rec[rows + 1, cols]          # left
        b = rec[rows, cols + 1]          # up
        c = rec[rows, cols]              # upper left
        k = kinds[rows][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, _paeth(a, b, c), 0))))
        rec[rows + 1, cols + 1] = (filt[rows, cols] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit gray ([H, W]), RGB or RGBA ([H, W, C]) PNG as uint8."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type "
                         f"{color} (8-bit gray, RGB and RGBA only)")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    ch = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw.reshape(height, 1 + width * ch), height, width, ch)
    return img[..., 0] if ch == 1 else img


def read_png(path: str, channels: int) -> np.ndarray:
    """A PNG file as uint8 [H, W, channels], converted as PIL's
    ``convert("RGB")`` (3) or ``convert("RGBA")`` (4) converts: gray
    replicated, alpha dropped, or added at 255."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if channels == 3:
        return np.ascontiguousarray(img[..., :3])
    if channels == 4 and img.shape[-1] == 3:
        return np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
    if channels == 4:
        return img
    raise ValueError(f"channels must be 3 or 4, got {channels}")


def _filter_rows(img: np.ndarray) -> np.ndarray:
    """PIL's per-row filter choice: none, then up, sub and Paeth, each kept
    when its sum of |byte| (a byte read as signed) is smaller than the best
    so far, the search ending at a zero sum. Returns [H, 1 + W bpp]."""
    h, w, bpp = img.shape
    cur = img.reshape(h, w * bpp).astype(np.int32)
    prev = np.concatenate([np.zeros((1, w * bpp), np.int32), cur[:-1]])
    left = np.concatenate([np.zeros((h, bpp), np.int32), cur[:, :-bpp]], 1)
    upleft = np.concatenate([np.zeros((h, bpp), np.int32), prev[:, :-bpp]],
                            1)
    cands = [(0, cur), (2, cur - prev), (1, cur - left),
             (4, cur - _paeth(left, prev, upleft))]
    kind = np.zeros(h, np.uint8)
    best = cur & 0xFF
    best_sum = np.full(h, np.iinfo(np.int64).max)
    for code, vals in cands:
        v = vals & 0xFF
        s = np.where(v < 128, v, 256 - v).sum(1)
        take = (s < best_sum) & (best_sum > 0)
        kind = np.where(take, code, kind)
        best = np.where(take[:, None], v, best)
        best_sum = np.where(take, s, best_sum)
    return np.concatenate([kind[:, None], best.astype(np.uint8)], 1)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] (gray), [H, W, 3] or [H, W, 4] as the PNG bytes PIL's
    ``Image.fromarray(img).save(path)`` writes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encode takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _PNG_COLOR_TYPE:
        raise ValueError(f"PNG encode takes 1, 3 or 4 channels, not {ch}")
    comp = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, 15, 9,
                            zlib.Z_FILTERED)
    data = comp.compress(_filter_rows(img).tobytes()) + comp.flush()
    step = max(_IDAT_CHUNK, w * 4)
    out = [_PNG_SIG, _png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[ch], 0, 0, 0))]
    out += [_png_chunk(b"IDAT", data[i:i + step])
            for i in range(0, len(data), step)]
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# ---- JPEG -----------------------------------------------------------------

def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("JPEG on the CPU needs PIL, which is not "
                           "installed; on the card pass a CUDA device") from e
    return Image


_CODEC_SIGS = {
    "jpeg_codec_image_info": [ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)],
    "jpeg_codec_decode": [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p],
    "jpeg_codec_encode": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p],
}


def _codec():
    from .. import kernels
    lib = kernels.load("jpeg_codec")
    if lib.jpeg_codec_decode.argtypes is None:
        for fname, argtypes in _CODEC_SIGS.items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.jpeg_codec_error_string.argtypes = [ctypes.c_int]
        lib.jpeg_codec_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"nvJPEG {what} failed: "
                           + lib.jpeg_codec_error_string(err).decode())


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(height, width) from a JPEG's frame header."""
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError("malformed JPEG marker")
        marker = data[pos + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h, w = struct.unpack(">HH", data[pos + 5:pos + 9])
            return h, w
        pos += 2 + n
    raise ValueError("no JPEG frame header")


def decode_jpegs(blobs: list[bytes], device: str | torch.device
                 ) -> torch.Tensor:
    """JPEG bitstreams of one size as RGB uint8 [N, H, W, 3] on ``device``:
    nvJPEG on a CUDA device, PIL on the CPU."""
    dev = torch.device(device)
    h, w = jpeg_size(blobs[0])
    if dev.type == "cpu":
        Image = _pil()
        out = np.empty((len(blobs), h, w, 3), np.uint8)
        for i, b in enumerate(blobs):
            out[i] = np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))
        return torch.from_numpy(out)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _codec()
    out = torch.empty((len(blobs), h, w, 3), dtype=torch.uint8, device=dev)
    planes = torch.empty(3 * h * w, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i, b in enumerate(blobs):
        _check(lib, lib.jpeg_codec_decode(b, len(b), out[i].data_ptr(),
                                          planes.data_ptr(), h, w, stream),
               "decode")
    return out


def read_jpegs(paths: list[str], device: str | torch.device) -> torch.Tensor:
    """JPEG files of one size as RGB uint8 [N, H, W, 3] on ``device``."""
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    return decode_jpegs(blobs, device)


def encode_jpeg(img: torch.Tensor | np.ndarray, quality: int = 95) -> bytes:
    """RGB uint8 [H, W, 3] as a baseline JPEG: nvJPEG for a tensor on the
    card (4:2:0), PIL for one on the CPU or a numpy array (PIL's defaults,
    also 4:2:0)."""
    if isinstance(img, np.ndarray) or img.device.type == "cpu":
        Image = _pil()
        buf = io.BytesIO()
        Image.fromarray(np.asarray(img)).save(buf, format="JPEG",
                                              quality=quality)
        return buf.getvalue()
    if img.dtype != torch.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"JPEG encode takes uint8 [H, W, 3], not "
                         f"{img.dtype} {tuple(img.shape)}")
    lib = _codec()
    img = img.contiguous()
    h, w = img.shape[:2]
    cap = 2 * h * w * 3 + 65536
    out = ctypes.create_string_buffer(cap)
    length = ctypes.c_size_t(cap)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    _check(lib, lib.jpeg_codec_encode(img.data_ptr(), h, w, int(quality),
                                      ctypes.addressof(out),
                                      ctypes.byref(length), stream), "encode")
    return out.raw[:length.value]


def write_jpeg(path: str, img: torch.Tensor | np.ndarray,
               quality: int = 95) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(img, quality))
