"""Carry the JAX package's parameters into the port.

Inputs are plain numpy (no JAX import here): a flax parameter tree as
nested dicts of arrays, and the ``GaussianParams`` fields. The port's
modules keep flax's submodule names, so the mapping is a rename plus the
inverse of the layout map in instag_tpu/io/reference_convert.py:

  * 2-D Conv ``kernel`` [K, K, I, O] -> Conv2d ``weight`` [O, I, K, K];
  * 1-D Conv ``kernel`` [K, I, O] -> Conv1d ``weight`` [O, I, K];
  * Dense ``kernel`` [I, O]  -> Linear ``weight`` [O, I];
  * ``bias``, hash-grid ``embeddings`` and LPIPS ``lin_i`` are copied as
    they are.

The Gaussian state (from numpy fields, or from any object with the JAX
state's attributes), its Adam state, the frame batch and the frame meta of
the JAX frame records are carried field by field.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.gaussians import (PARAM_FIELDS, AdamState, GaussianParams,
                                GaussianState)


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, name + ".")
        else:
            yield name, np.asarray(value)


_KERNEL_LAYOUT = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}


def motion_state_dict(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """A flax tree ({'params': {...}} or its inner dict) as a PyTorch state
    dict."""
    tree = flax_params.get("params", flax_params)
    sd = {}
    for name, value in _flatten(tree):
        head, _, leaf = name.rpartition(".")
        if leaf == "kernel":
            value = value.transpose(_KERNEL_LAYOUT[value.ndim])
            name = f"{head}.weight"
        sd[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    return sd


def lpips_state_dict(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's LPIPS tree (``alex.conv_i`` kernels [K, K, I, O]
    and biases, ``lin_i`` [C]) as the state dict of ``models.lpips.LPIPS``."""
    return motion_state_dict(flax_params)


def load_motion_net(net: nn.Module, flax_params: Mapping,
                    device: str | torch.device = "cuda") -> nn.Module:
    """Load converted flax weights into ``net`` (every parameter must match)
    and move it to ``device``."""
    dev = resolve_device(device)
    net.load_state_dict(motion_state_dict(flax_params), strict=True)
    return net.to(dev).eval()


def _params(fields: Mapping[str, np.ndarray], dev) -> GaussianParams:
    return GaussianParams(**{
        f: torch.from_numpy(np.array(fields[f], dtype=np.float32)).to(dev)
        for f in PARAM_FIELDS})


def gaussian_state(fields: Mapping[str, np.ndarray], alive: np.ndarray,
                   active_sh_degree: int, max_sh_degree: int,
                   device: str | torch.device = "cuda",
                   stats: Mapping[str, np.ndarray] | None = None,
                   spatial_lr_scale: float = 1.0,
                   dropped_children: int = 0) -> GaussianState:
    """A GaussianState from the JAX ``GaussianParams`` fields as numpy.
    ``stats`` may carry the JAX state's ``max_radii2d``, ``xyz_grad_accum``
    and ``denom``; those it lacks start at zero."""
    dev = resolve_device(device)

    def t(x, dtype=np.float32):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)

    stats = stats or {}
    return GaussianState(params=_params(fields, dev), alive=t(alive, bool),
                         active_sh_degree=int(active_sh_degree),
                         max_sh_degree=int(max_sh_degree),
                         spatial_lr_scale=float(spatial_lr_scale),
                         dropped_children=int(dropped_children),
                         **{k: t(stats[k]) for k in ("max_radii2d",
                                                     "xyz_grad_accum",
                                                     "denom") if k in stats})


def state_from_jax(state, device: str | torch.device = "cuda"
                   ) -> GaussianState:
    """The port's GaussianState from an object with the JAX state's
    attributes (``params`` fields, ``alive``, the densification statistics,
    the SH degrees, ``spatial_lr_scale`` and ``dropped_children``), read
    with ``numpy.asarray``."""
    return gaussian_state(
        {f: np.asarray(getattr(state.params, f)) for f in PARAM_FIELDS},
        np.asarray(state.alive), int(np.asarray(state.active_sh_degree)),
        state.max_sh_degree, device=device,
        stats={k: np.asarray(getattr(state, k))
               for k in ("max_radii2d", "xyz_grad_accum", "denom")},
        spatial_lr_scale=state.spatial_lr_scale,
        dropped_children=int(np.asarray(state.dropped_children)))


def adam_state(mu: Mapping[str, np.ndarray], nu: Mapping[str, np.ndarray],
               step: int, device: str | torch.device = "cuda") -> AdamState:
    """An AdamState from the JAX ``AdamState``'s moments (``GaussianParams``
    fields as numpy) and step."""
    dev = resolve_device(device)
    return AdamState(mu=_params(mu, dev), nu=_params(nu, dev), step=int(step))


def frame_meta(records):
    """The port's FrameMeta from the JAX package's frame records."""
    from ..train.common import FrameMeta

    return FrameMeta.from_records(records)


def frame_batch(arrays: Mapping[str, np.ndarray | None],
                device: str | torch.device = "cuda"):
    """The port's FrameBatch from the JAX FrameBatch's fields as numpy
    (``None`` for absent priors)."""
    from ..train.common import FrameBatch

    dev = resolve_device(device)
    return FrameBatch(**{
        k: None if v is None else torch.from_numpy(np.array(v)).to(dev)
        for k, v in arrays.items()})
