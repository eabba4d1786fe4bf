"""Minimal PLY point-cloud I/O, numpy only (the port's own copy of
instag_tpu/data/plyio.py): one 'vertex' element of scalar properties,
binary little-endian written, binary or ascii read. It carries the 3DGS
checkpoint layout and the scene's ``points3d.ply``.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}
_NAMES = {"<f4": "float", "<f8": "double", "u1": "uchar", "i1": "char",
          "<i2": "short", "<u2": "ushort", "<i4": "int", "<u4": "uint"}


def write_ply(path: str, names: list[str], arrays: list[np.ndarray]) -> None:
    """Write one 'vertex' element with the given scalar property columns."""
    n = arrays[0].shape[0]
    fields = []
    for name, arr in zip(names, arrays):
        dt = np.dtype(arr.dtype).newbyteorder("<")
        fields.append((name, dt.str.lstrip("=")))
    rec = np.empty(n, dtype=fields)
    for name, arr in zip(names, arrays):
        rec[name] = arr.reshape(n)

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    for name, arr in zip(names, arrays):
        dt = np.dtype(arr.dtype).str.lstrip("=<>|")
        key = {"f4": "<f4", "f8": "<f8", "u1": "u1", "i1": "i1", "i2": "<i2",
               "u2": "<u2", "i4": "<i4", "u4": "<u4"}[dt]
        header.append(f"property {_NAMES[key]} {name}")
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read the first 'vertex' element into {property: array}."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        assert magic == b"ply", "not a PLY file"
        fmt = None
        count = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    count = int(cnt)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                assert parts[1] != "list", "list properties unsupported"
                props.append((parts[2], _DTYPES[parts[1]]))
            elif line == "end_header":
                break
        dtype = np.dtype([(n, t) for n, t in props])
        if fmt == "binary_little_endian":
            rec = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                                count=count)
        elif fmt == "ascii":
            rows = [f.readline().split() for _ in range(count)]
            rec = np.array([tuple(r) for r in rows], dtype=dtype)
        else:
            raise ValueError(f"unsupported PLY format: {fmt}")
    return {n: np.asarray(rec[n]) for n, _ in props}


def write_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """xyz [N,3] f32, rgb [N,3] uint8 (+ zero normals), the reference's
    storePly layout (scene/dataset_readers.py:82-97)."""
    zeros = np.zeros_like(xyz, dtype=np.float32)
    names = ["x", "y", "z", "nx", "ny", "nz", "red", "green", "blue"]
    cols = [xyz[:, 0].astype(np.float32), xyz[:, 1].astype(np.float32),
            xyz[:, 2].astype(np.float32), zeros[:, 0], zeros[:, 1], zeros[:, 2],
            rgb[:, 0].astype(np.uint8), rgb[:, 1].astype(np.uint8),
            rgb[:, 2].astype(np.uint8)]
    write_ply(path, names, cols)


def read_point_cloud(path: str):
    d = read_ply(path)
    xyz = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)
    if "red" in d:
        rgb = np.stack([d["red"], d["green"], d["blue"]], axis=1)
        colors = rgb.astype(np.float32) / 255.0
    else:
        colors = np.zeros_like(xyz)
    return xyz, colors
