"""The process group and the placement helpers (counterparts of
instag_tpu/parallel/mesh.py's ``make_mesh``, ``replicate`` and
``shard_leading_axis``).

A JAX mesh is every chip of the process; here each rank of a
``torch.distributed`` group drives one device. ``init_distributed`` joins
the group that ``torchrun`` describes in the environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), or one
given by an explicit ``init_method`` (``file://`` or ``tcp://``), and
picks the backend:
  * NCCL when the ranks' tensors live on CUDA and each rank has its own
    card;
  * gloo on the CPU, and when ranks share a card (gloo then reduces CUDA
    tensors through the host).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch import nn

from ..device import resolve_device
from .comm import world


def _env_int(name: str, default: int | None = None) -> int | None:
    v = os.environ.get(name)
    return default if v is None else int(v)


def init_distributed(device: str | torch.device = "cuda",
                     init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     backend: str | None = None):
    """Join (or reuse) the default process group; returns ``(group,
    device)``. ``group`` is ``None`` when no group is described (no
    ``init_method``, no ``WORLD_SIZE`` in the environment): one process,
    on ``device``. A CUDA ``device`` without an index becomes
    ``cuda:LOCAL_RANK``, or ``cuda:(LOCAL_RANK % cards)`` when the ranks
    of a host outnumber its cards (they then share them over gloo);
    ``backend`` overrides the choice."""
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if not dist.is_initialized() and init_method is None \
            and world_size is None:
        return None, resolve_device(device)
    dev = torch.device(device)
    local = _env_int("LOCAL_RANK", rank or 0)
    shared = False
    if dev.type == "cuda":
        resolve_device(dev)
        cards = torch.cuda.device_count()
        local_ranks = _env_int("LOCAL_WORLD_SIZE", world_size or 1)
        shared = local_ranks > cards
        if dev.index is None:
            dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(dev)
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
        kw = {} if init_method is None else dict(init_method=init_method)
        if backend == "nccl":
            kw["device_id"] = dev
        dist.init_process_group(backend, rank=rank or 0,
                                world_size=world_size or 1, **kw)
    return dist.group.WORLD, dev


def shutdown() -> None:
    """Leave the default process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _leaves(tree) -> list:
    """The tensors of a tree of tensors, dicts, lists, tuples, dataclasses
    and modules (parameters, then buffers), in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return []


@torch.no_grad()
def replicate(tree, group, src: int = 0):
    """Give every rank rank ``src``'s values of ``tree``'s tensors, in
    place (the parameters of a module, the tensors of a dict, a list or a
    dataclass); returns ``tree``."""
    if world(group)[1] > 1:
        for t in _leaves(tree):
            dist.broadcast(t.data, src=src, group=group)
    return tree


def shard_rows(n: int, group) -> slice:
    """This rank's contiguous rows of ``n`` (``n`` divisible by the world
    size)."""
    rank, w = world(group)
    if n % w:
        raise ValueError(f"{n} rows do not divide over {w} ranks")
    per = n // w
    return slice(rank * per, (rank + 1) * per)


def shard_leading_axis(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous rows of ``x``'s leading axis."""
    return x[shard_rows(x.shape[0], group)]
