"""Carry the JAX package's parameters into the port.

Inputs are plain numpy (no JAX import here): a flax parameter tree as
nested dicts of arrays, and the ``GaussianParams`` fields. The port's
modules keep flax's submodule names, so the mapping is a rename plus the
inverse of the layout map in instag_tpu/io/reference_convert.py:

  * Conv ``kernel`` [K, I, O] -> Conv1d ``weight`` [O, I, K];
  * Dense ``kernel`` [I, O]  -> Linear ``weight`` [O, I];
  * ``bias`` and hash-grid ``embeddings`` are copied as they are.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.gaussians import GaussianParams, GaussianState


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, name + ".")
        else:
            yield name, np.asarray(value)


def motion_state_dict(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """A flax motion-net tree ({'params': {...}} or its inner dict) as a
    PyTorch state dict."""
    tree = flax_params.get("params", flax_params)
    sd = {}
    for name, value in _flatten(tree):
        head, _, leaf = name.rpartition(".")
        if leaf == "kernel":
            value = (value.transpose(2, 1, 0) if value.ndim == 3
                     else value.T)
            name = f"{head}.weight"
        sd[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return sd


def load_motion_net(net: nn.Module, flax_params: Mapping,
                    device: str | torch.device = "cuda") -> nn.Module:
    """Load converted flax weights into ``net`` (every parameter must match)
    and move it to ``device``."""
    dev = resolve_device(device)
    net.load_state_dict(motion_state_dict(flax_params), strict=True)
    return net.to(dev).eval()


def gaussian_state(fields: Mapping[str, np.ndarray], alive: np.ndarray,
                   active_sh_degree: int, max_sh_degree: int,
                   device: str | torch.device = "cuda") -> GaussianState:
    """A GaussianState from the JAX ``GaussianParams`` fields as numpy."""
    dev = resolve_device(device)
    params = GaussianParams(**{
        f: torch.from_numpy(np.array(fields[f], dtype=np.float32)).to(dev)
        for f in GaussianParams.__dataclass_fields__})
    return GaussianState(params=params,
                         alive=torch.from_numpy(np.array(alive, bool)).to(dev),
                         active_sh_degree=int(active_sh_degree),
                         max_sh_degree=int(max_sh_degree))
