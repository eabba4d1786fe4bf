"""Checkpoint bundles and PLY snapshots (counterpart of
instag_tpu/io/checkpoints.py), readable and writable by both packages.

  * bundles: one MessagePack file of plain state dicts (numpy arrays and
    Python scalars), written byte for byte as the JAX package's
    ``save_bundle`` writes the same tree (``io/msgpack.py``); loading runs
    no code. Motion networks travel as flax parameter trees
    (``flax_params`` here, ``from_jax.motion_state_dict`` back);
  * PLY snapshots of the alive slots in the vanilla-3DGS attribute layout
    (x, y, z, nx, ny, nz, f_dc_*, f_rest_*, opacity, scale_*, rot_*);
  * optimizer states, to resume a run (the counterpart of the JAX package's
    ``restore_like``): the Gaussian Adam as its ``AdamState`` dict, and the
    UMF ``AdamW`` + ``LambdaLR`` and the PMF ``Adam`` as the state dicts of
    its optax ``multi_transform``s. flax's ``to_state_dict`` writes those as
    ``inner_states/<label>/inner_state/<i>``, one entry per transform of the
    label's chain: the UMF's ``adamw`` is (``scale_by_adam``,
    ``add_decayed_weights``, the schedule), the PMF's (``scale_by_adam``,
    ``scale``), and its ``audio_att`` chain starts with
    ``add_decayed_weights``, so its Adam state sits at index 1. Stateless
    transforms, and the moments of the parameters outside a label, are
    empty maps. optax keeps one ``count`` a label, PyTorch one ``step`` a
    parameter; every label steps at every update, so they are one number.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..data.plyio import read_ply, write_ply
from ..device import resolve_device
from ..models.gaussians import (PARAM_FIELDS, AdamState, GaussianParams,
                                GaussianState)
from ..models.motion import (MotionNetwork, MouthMotionNetwork,
                             PersonalizedMotionNetwork)
from ..train.optim import LABELS, label_for_name
from . import msgpack
from .from_jax import _KERNEL_LAYOUT, load_motion_net, motion_state_dict

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


def _flax_tree(named) -> dict:
    """``(name, tensor or None)`` pairs as a flax tree ``{"params": ...}``:
    ``weight`` back to ``kernel`` in flax's layout, every other leaf copied,
    ``None`` (a parameter outside an optimizer's label) an empty map."""
    tree: dict = {}
    for name, value in named:
        *path, leaf = name.split(".")
        if leaf == "weight":
            leaf = "kernel"
            if value is not None:
                value = value.permute(
                    *np.argsort(_KERNEL_LAYOUT[value.dim()]).tolist())
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        # a copy: on the CPU, .numpy() shares the live tensor's memory
        node[leaf] = ({} if value is None else
                      np.array(_host(value), np.float32, order="C"))
    return {"params": tree}


def flax_params(net: nn.Module | Mapping[str, torch.Tensor]) -> dict:
    """A port motion network (or its state dict) as the flax parameter tree
    ``{"params": {...}}`` of the JAX package's network: the inverse of
    ``from_jax.motion_state_dict``."""
    sd = net.state_dict() if isinstance(net, nn.Module) else net
    return _flax_tree(sd.items())


def gopt_to_dict(opt: AdamState) -> dict:
    """The Gaussian Adam state as the JAX package's ``AdamState`` dict."""
    return {"mu": {f: _host(getattr(opt.mu, f)) for f in PARAM_FIELDS},
            "nu": {f: _host(getattr(opt.nu, f)) for f in PARAM_FIELDS},
            "step": np.asarray(opt.step, np.int32)}


def gopt_from_dict(d: Mapping, device: str | torch.device = "cuda"
                   ) -> AdamState:
    """The inverse of ``gopt_to_dict`` (also of the JAX package's), on
    ``device``."""
    dev = resolve_device(device)

    def params(tree):
        return GaussianParams(**{f: torch.from_numpy(np.array(tree[f])).to(
            dev) for f in PARAM_FIELDS})
    return AdamState(mu=params(d["mu"]), nu=params(d["nu"]),
                     step=int(d["step"]))


# where each label's scale_by_adam state sits in its optax chain, and the
# chain's length
_UMF_CHAIN = {label: (0, 3) for label in LABELS}
_PMF_CHAIN = {label: (1, 3) if label == "audio_att" else (0, 2)
              for label in LABELS}


def _count(opt: torch.optim.Optimizer) -> int:
    """The optimizer's update count (0 before its first step)."""
    steps = {int(st["step"]) for st in opt.state.values() if "step" in st}
    if len(steps) > 1:
        raise ValueError(f"parameters stand at different steps {steps}")
    return steps.pop() if steps else 0


def _opt_to_dict(net: nn.Module, opt: torch.optim.Optimizer,
                 chain: dict) -> dict:
    count = np.asarray(_count(opt), np.int32)
    params = list(net.named_parameters())
    inner = {}
    for label, (at, length) in chain.items():
        def moments(key):
            return _flax_tree(
                (name, opt.state.get(p, {}).get(key, torch.zeros_like(p))
                 if label_for_name(name) == label else None)
                for name, p in params)
        states = {str(i): {} for i in range(length)}
        states[str(at)] = {"count": count, "mu": moments("exp_avg"),
                           "nu": moments("exp_avg_sq")}
        inner[label] = {"inner_state": states}
    return {"inner_states": inner}


def _restore_opt(net: nn.Module, opt: torch.optim.Optimizer, d: Mapping,
                 chain: dict) -> int:
    """Load the moments and count of ``d`` into ``opt``'s state; returns
    the count."""
    counts, by_name = set(), {}
    for label, (at, _) in chain.items():
        st = d["inner_states"][label]["inner_state"][str(at)]
        counts.add(int(st["count"]))
        mu, nu = motion_state_dict(st["mu"]), motion_state_dict(st["nu"])
        for name in mu:
            if label_for_name(name) != label:
                raise ValueError(f"{name} has moments under label {label}")
            by_name[name] = (mu[name], nu[name])
    if len(counts) != 1:
        raise ValueError(f"labels stand at different counts {counts}")
    count = counts.pop()
    params = dict(net.named_parameters())
    if set(by_name) != set(params):
        raise ValueError(f"moments for {sorted(set(by_name) ^ set(params))} "
                         "do not match the network's parameters")
    opt.state.clear()
    for name, p in params.items():
        mu, nu = by_name[name]
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": mu.to(p.device, p.dtype),
                        "exp_avg_sq": nu.to(p.device, p.dtype)}
    return count


def umf_opt_to_dict(net: nn.Module, opt: torch.optim.Optimizer,
                    sched: torch.optim.lr_scheduler.LambdaLR) -> dict:
    """The UMF's ``AdamW`` and ``LambdaLR`` (``train.optim.umf_optimizer``)
    as the JAX package's optax state dict; the schedule's count is the
    scheduler's step."""
    d = _opt_to_dict(net, opt, _UMF_CHAIN)
    for label in LABELS:
        d["inner_states"][label]["inner_state"]["2"] = {
            "count": np.asarray(sched.last_epoch, np.int32)}
    return d


def restore_umf_opt(net: nn.Module, opt: torch.optim.Optimizer,
                    sched: torch.optim.lr_scheduler.LambdaLR,
                    d: Mapping) -> None:
    """Load the optax state dict ``d`` of a UMF optimizer into ``opt`` and
    ``sched`` (made by ``umf_optimizer`` for ``net``): the moments, the
    step, and the scheduler at the schedule's count, each group's rate at
    its base rate times the schedule there (a scheduler that restarted
    would rerun the 0.1x warm phase)."""
    _restore_opt(net, opt, d, _UMF_CHAIN)
    counts = {int(d["inner_states"][label]["inner_state"]["2"]["count"])
              for label in LABELS}
    if len(counts) != 1:
        raise ValueError(f"schedules stand at different counts {counts}")
    sched.last_epoch = counts.pop()
    for group, base, fn in zip(opt.param_groups, sched.base_lrs,
                               sched.lr_lambdas):
        group["lr"] = base * fn(sched.last_epoch)
    sched._last_lr = [group["lr"] for group in opt.param_groups]


def pmf_opt_to_dict(net: nn.Module, opt: torch.optim.Optimizer) -> dict:
    """The PMF's ``Adam`` (``train.optim.pmf_optimizer``) as the JAX
    package's optax state dict."""
    return _opt_to_dict(net, opt, _PMF_CHAIN)


def restore_pmf_opt(net: nn.Module, opt: torch.optim.Optimizer,
                    d: Mapping) -> None:
    """Load the optax state dict ``d`` of a PMF optimizer into ``opt``."""
    _restore_opt(net, opt, d, _PMF_CHAIN)


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


def train_bundle(res: Mapping, iteration: int, **extra) -> dict:
    """The bundle the JAX package's train_face and train_mouth CLIs write,
    from a ``train_face`` / ``train_mouth`` result: the state, both nets
    as flax trees, the Gaussian Adam and both optimizer states, and
    ``iteration`` (with ``extra`` entries, as the face's
    ``max_sh_degree``)."""
    return dict(state=state_to_dict(res["state"]),
                umf_params=flax_params(res["umf_net"]),
                pmf_params=flax_params(res["pmf_net"]),
                gopt=gopt_to_dict(res["gopt"]),
                umf_opt_state=res["umf_opt_state"],
                pmf_opt_state=res["pmf_opt_state"],
                iteration=iteration, **extra)


def fuse_bundle(res: Mapping, iteration: int) -> dict:
    """The bundle the JAX package's train_fuse_con CLI writes, from a
    ``train_fuse`` result (what the synthesize_fuse CLI reads)."""
    return dict(face_state=state_to_dict(res["face_state"]),
                mouth_state=state_to_dict(res["mouth_state"]),
                **{f"{k}_params": flax_params(res[f"{k}_net"])
                   for k in ("face_umf", "mouth_umf", "face_pmf",
                             "mouth_pmf")},
                iteration=iteration)


def branch_from_bundle(b: Mapping, branch: str,
                       audio_extractor: str = "deepspeech",
                       device: str | torch.device = "cuda") -> dict:
    """A loaded face or mouth bundle of either package as the port's
    ``state``, ``umf_net`` and ``pmf_net`` on ``device`` (what
    ``train_mouth`` and ``train_fuse`` take, and what a resumed run
    restarts from)."""
    dev = resolve_device(device)
    umf = (MotionNetwork if branch == "face" else MouthMotionNetwork)(
        audio_extractor)
    return dict(state=state_from_dict(b["state"], dev),
                umf_net=load_motion_net(umf, b["umf_params"], dev),
                pmf_net=load_motion_net(
                    PersonalizedMotionNetwork(branch, audio_extractor),
                    b["pmf_params"], dev))


def load_branch(path: str, branch: str, audio_extractor: str = "deepspeech",
                device: str | torch.device = "cuda") -> dict:
    """``branch_from_bundle`` of the bundle at ``path``."""
    return branch_from_bundle(load_bundle(path), branch, audio_extractor,
                              device)
