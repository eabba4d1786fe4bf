"""The subset of MessagePack that the JAX package's bundles use (the port's
own codec: neither flax nor the ``msgpack`` package is needed).

``packb`` writes what ``flax.serialization.msgpack_serialize`` writes for a
tree of plain values, byte for byte:

  * maps with string keys, in sorted key order (flax maps the tree through
    ``jax.tree_util`` first, which sorts dict keys); lists and tuples as
    arrays;
  * ``None``, ``bool``, ``int`` (the smallest encoding), ``float`` (float64),
    ``str`` (str8 allowed) and ``bytes`` (bin);
  * a numpy array as ext type 1 and a numpy scalar as ext type 3, both
    carrying the packed triple ``(shape, dtype name, C-order bytes)``.

``unpackb`` reads every MessagePack type but timestamps and returns what
``flax.serialization.msgpack_restore`` returns: dicts, lists, Python scalars,
numpy arrays for ext 1 and numpy scalars for ext 3. flax splits an array of
more than 2**30 bytes into a ``__msgpack_chunked_array__`` map; a bundle of
this system holds a few MB, and both directions refuse such arrays.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_ARRAY_BYTES = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


_UINTS = ((0xFF, b"\xcc", ">B"), (0xFFFF, b"\xcd", ">H"),
          (0xFFFFFFFF, b"\xce", ">I"), (0xFFFFFFFFFFFFFFFF, b"\xcf", ">Q"))
_SINTS = ((-0x80, b"\xd0", ">b"), (-0x8000, b"\xd1", ">h"),
          (-0x80000000, b"\xd2", ">i"), (-0x8000000000000000, b"\xd3", ">q"))


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80 or -32 <= x < 0:
        out.append(x & 0xFF)
        return
    for limit, code, fmt in (_UINTS if x > 0 else _SINTS):
        if (x <= limit) if x > 0 else (x >= limit):
            out += code + struct.pack(fmt, x)
            return
    raise OverflowError(f"integer {x} does not fit 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes: tuple, out: bytearray):
    """A length header: ``fix | n`` below ``fix_max``, else the 8-, 16- or
    32-bit form (``codes``; None where the type has no such form)."""
    if n < fix_max and fix is not None:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} exceeds MessagePack's 32-bit limit")


def _pack_ext(code: int, payload: bytes, out: bytearray) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fixed is not None:
        out.append(fixed)
    else:
        _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
    out.append(code)
    out += payload


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialised")
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(
            f"array of {arr.nbytes} bytes: flax would write it as a chunked "
            f"array, which this codec does not support")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name,
                  arr.tobytes("C")))


def _pack(obj, out: bytearray) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif t is str:
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif t in (bytes, bytearray, memoryview):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += raw
    elif t is dict:
        if not all(type(k) is str for k in obj):
            raise TypeError("map keys must be str")
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    elif t in (list, tuple):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialise {t.__name__}")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes (see the module docstring)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def ext(self, n: int):
        code = self.num(">b")
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported MessagePack ext type {code}")
        shape, name, buf = unpackb(payload, raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(
            shape).copy()
        return arr if code == EXT_NDARRAY else arr[()]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("chunked arrays (over 2**30 bytes) are not "
                             "supported")
        return out

    def value(self):
        b = self.num(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map_(b & 0x0F)
        if b < 0xA0:
            return [self.value() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return self.str_(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        ints = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.num(ints[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H",
                0xC9: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H",
                0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if b in lens:
            n = self.num(lens[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return self.str_(n)
            if b <= 0xDD:
                return [self.value() for _ in range(n)]
            return self.map_(n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")


def unpackb(data: bytes, raw: bool = False):
    """Decode MessagePack ``data`` (see the module docstring); ``raw``
    returns strings as bytes."""
    reader = _Reader(data, raw)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the MessagePack value")
    return value
