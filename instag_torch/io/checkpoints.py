"""Checkpoint bundles and PLY snapshots (counterpart of
instag_tpu/io/checkpoints.py), readable and writable by both packages.

  * bundles: one MessagePack file of plain state dicts (numpy arrays and
    Python scalars), written byte for byte as the JAX package's
    ``save_bundle`` writes the same tree (``io/msgpack.py``); loading runs
    no code. Motion networks travel as flax parameter trees
    (``flax_params`` here, ``from_jax.motion_state_dict`` back);
  * PLY snapshots of the alive slots in the vanilla-3DGS attribute layout
    (x, y, z, nx, ny, nz, f_dc_*, f_rest_*, opacity, scale_*, rot_*).

``restore_like``, which rebuilds optimizer states from a bundle, belongs to
resuming a training run and is not here.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..data.plyio import read_ply, write_ply
from ..device import resolve_device
from ..models.gaussians import PARAM_FIELDS, GaussianParams, GaussianState
from . import msgpack
from .from_jax import _KERNEL_LAYOUT

_STATS = ("max_radii2d", "xyz_grad_accum", "denom")


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def save_gaussian_ply(path: str, state: GaussianState) -> None:
    """Write the alive slots in the reference PLY attribute layout."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    alive = _host(state.alive)
    p = {f: _host(getattr(state.params, f))[alive] for f in PARAM_FIELDS}
    n = p["xyz"].shape[0]
    zeros = np.zeros(n, np.float32)
    names = ["x", "y", "z", "nx", "ny", "nz"]
    cols = [p["xyz"][:, 0], p["xyz"][:, 1], p["xyz"][:, 2], zeros, zeros,
            zeros]
    # SH blocks [N, K, 3] flatten channel-major
    for prefix, field in (("f_dc", "features_dc"),
                          ("f_rest", "features_rest")):
        flat = p[field].transpose(0, 2, 1).reshape(n, -1)
        names += [f"{prefix}_{i}" for i in range(flat.shape[1])]
        cols += [flat[:, i].astype(np.float32) for i in range(flat.shape[1])]
    names.append("opacity")
    cols.append(p["opacity"][:, 0].astype(np.float32))
    for prefix, field, k in (("scale", "scaling", 3), ("rot", "rotation", 4)):
        names += [f"{prefix}_{i}" for i in range(k)]
        cols += [p[field][:, i].astype(np.float32) for i in range(k)]
    write_ply(path, names, [np.ascontiguousarray(c) for c in cols])


def load_gaussian_ply(path: str, capacity: int, max_sh_degree: int = 2,
                      device: str | torch.device = "cuda") -> GaussianState:
    """A reference-layout PLY as a GaussianState of ``capacity`` slots, the
    points in the first ones, at the full SH degree."""
    dev = resolve_device(device)
    d = read_ply(path)
    n = d["x"].shape[0]
    if n > capacity:
        raise ValueError(f"PLY has {n} points > capacity {capacity}")
    rest_k = (max_sh_degree + 1) ** 2 - 1

    def cols(names):
        return np.stack([d[k] for k in names], 1).astype(np.float32)

    rest_names = sorted((k for k in d if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    fields = dict(
        xyz=cols(["x", "y", "z"]),
        features_dc=cols([f"f_dc_{i}" for i in range(3)]).reshape(
            n, 3, 1).transpose(0, 2, 1),
        features_rest=(cols(rest_names).reshape(n, 3, rest_k).transpose(
            0, 2, 1) if rest_names else np.zeros((n, rest_k, 3), np.float32)),
        identity=np.zeros((n, 1), np.float32),
        scaling=cols([f"scale_{i}" for i in range(3)]),
        rotation=cols([f"rot_{i}" for i in range(4)]),
        opacity=d["opacity"].reshape(n, 1).astype(np.float32))

    def pad(x):
        x = np.pad(x, [(0, capacity - n)] + [(0, 0)] * (x.ndim - 1))
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return GaussianState(
        params=GaussianParams(**{f: pad(fields[f]) for f in PARAM_FIELDS}),
        alive=torch.arange(capacity, device=dev) < n,
        active_sh_degree=max_sh_degree, max_sh_degree=max_sh_degree)


def state_to_dict(state: GaussianState) -> dict:
    """A GaussianState as the plain dict the JAX package's ``state_to_dict``
    writes: numpy fields at full capacity, Python scalars."""
    return {
        "params": {f: _host(getattr(state.params, f)) for f in PARAM_FIELDS},
        "alive": _host(state.alive),
        **{k: _host(getattr(state, k)) for k in _STATS},
        "active_sh_degree": int(state.active_sh_degree),
        "dropped_children": int(state.dropped_children),
        "spatial_lr_scale": float(state.spatial_lr_scale),
        "max_sh_degree": int(state.max_sh_degree),
    }


def state_from_dict(d: Mapping, device: str | torch.device = "cuda"
                    ) -> GaussianState:
    """The inverse of ``state_to_dict`` (also of the JAX package's), on
    ``device``."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x)).to(dev)

    return GaussianState(
        params=GaussianParams(**{f: t(d["params"][f]) for f in PARAM_FIELDS}),
        alive=t(d["alive"]).to(torch.bool),
        active_sh_degree=int(d["active_sh_degree"]),
        max_sh_degree=int(d["max_sh_degree"]),
        dropped_children=int(d.get("dropped_children", 0)),
        spatial_lr_scale=float(d["spatial_lr_scale"]),
        **{k: t(d[k]) for k in _STATS})


def flax_params(net: nn.Module | Mapping[str, torch.Tensor]) -> dict:
    """A port motion network (or its state dict) as the flax parameter tree
    ``{"params": {...}}`` of the JAX package's network: the inverse of
    ``from_jax.motion_state_dict``, ``weight`` back to ``kernel`` in flax's
    layout, every other leaf copied."""
    sd = net.state_dict() if isinstance(net, nn.Module) else net
    tree: dict = {}
    for name, value in sd.items():
        *path, leaf = name.split(".")
        value = _host(value).astype(np.float32)
        if leaf == "weight":
            value = np.ascontiguousarray(value.transpose(
                np.argsort(_KERNEL_LAYOUT[value.ndim])))
            leaf = "kernel"
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return {"params": tree}


def _state_dict_tree(x):
    """Tensors to numpy and lists to ``{"0": ...}`` maps, as flax's
    ``to_state_dict`` stores them."""
    if isinstance(x, Mapping):
        return {str(k): _state_dict_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {str(i): _state_dict_tree(v) for i, v in enumerate(x)}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def save_bundle(path: str, bundle: Mapping) -> None:
    """Write a tree of arrays and scalars as a MessagePack bundle, the bytes
    the JAX package's ``save_bundle`` writes for the same tree."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = msgpack.packb(_state_dict_tree(bundle))
    with open(path, "wb") as f:
        f.write(data)


def load_bundle(path: str) -> dict:
    """A MessagePack bundle as nested dicts of numpy arrays and scalars."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:1] == b"\x80":
        raise ValueError(f"{path} is a pickle, not a MessagePack bundle; "
                         "load_bundle reads MessagePack only")
    return msgpack.unpackb(data)


def bundle_list(x) -> list:
    """A list stored in a bundle, which arrives as a ``{"0": ...}`` map."""
    if isinstance(x, Mapping):
        return [x[k] for k in sorted(x, key=int)]
    return list(x)
