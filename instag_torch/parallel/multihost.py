"""The multi-process input pipeline and checkpoint I/O (counterpart of
instag_tpu/parallel/multihost.py).

A JAX multi-host run stitches every host's chips into one runtime with
global arrays; PyTorch has neither. Here every process is one rank of the
``torch.distributed`` default group, and:
  * **input**: each rank keeps only its contiguous shard of the frames in
    host memory (``frame_shard``, ``MultihostFrameStore``) and uploads
    the rows it trains; the "global batch" is this rank's local batch;
  * **checkpoints**: ``save_bundle_multihost`` gathers the leaves marked
    ``Shard`` (a rank's rows of a leaf split over the ranks) to every
    rank, rank 0 alone writes, and all wait at a barrier.
Every helper degrades to the local behaviour in one process.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from .comm import all_gather, collective_device, world
from .mesh import init_distributed


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   device: str | torch.device = "cuda") -> bool:
    """Join a multi-process run; returns whether more than one process
    takes part. The arguments default to the variables ``torchrun`` sets
    (``MASTER_ADDR``/``MASTER_PORT`` as ``tcp://``, ``WORLD_SIZE``,
    ``RANK``). Idempotent; without coordinator information (none given,
    none in the environment) it returns False and touches nothing."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    num_processes = num_processes or int(env.get("WORLD_SIZE", "0")) or None
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator is None and num_processes is None:
        return False
    init_distributed(device, init_method=coordinator, rank=process_id,
                     world_size=num_processes)
    return dist.get_world_size() > 1


def global_mesh(axis: str = "dp", n_devices: int | None = None):
    """The process group every rank belongs to (``None`` in one process),
    where the JAX package builds a mesh over every host's chips; ``axis``
    and ``n_devices`` have no counterpart, since one rank drives one
    device."""
    return dist.group.WORLD if dist.is_initialized() else None


def frame_shard(n_frames: int, process_index: int | None = None,
                process_count: int | None = None) -> slice:
    """The contiguous frames this rank keeps: balanced blocks, the first
    ``n % P`` ranks one frame more; their union is exactly [0, n)."""
    rank, size = world(global_mesh())
    p = rank if process_index is None else process_index
    P_ = size if process_count is None else process_count
    base, extra = divmod(n_frames, P_)
    start = p * base + min(p, extra)
    return slice(start, start + base + (1 if p < extra else 0))


def sample_local_rows(rng: np.random.Generator, shard: slice,
                      rows_per_host: int) -> np.ndarray:
    """A rank's curriculum draw, uniform over its shard (global
    indices)."""
    return rng.integers(shard.start, shard.stop, size=rows_per_host)


def make_global_batch(local_arrays: dict, group=None,
                      device: str | torch.device = "cuda"):
    """The FrameBatch of this rank's rows (numpy stacks by field, ``None``
    for absent priors) on ``device``. PyTorch has no global array: the
    batch a rank trains is its local batch, and the data-parallel step
    reduces its gradients over ``group``."""
    from ..device import resolve_device
    from ..train.common import FrameBatch
    dev = resolve_device(device)
    return FrameBatch(**{k: None if v is None else torch.from_numpy(
        np.ascontiguousarray(v)).to(dev) for k, v in local_arrays.items()})


class MultihostFrameStore:
    """This rank's shard of the frames in host memory (a
    ``train.common.HostFrameStore`` over ``records[frame_shard(...)]``).
    ``gather_global(local_idxs)`` returns the FrameBatch of those rows of
    the shard (shard-relative indices) on the store's device: this rank's
    part of the block, since no global array exists in PyTorch."""

    def __init__(self, records, with_priors: bool = False,
                 process_index: int | None = None,
                 process_count: int | None = None,
                 device: str | torch.device = "cuda"):
        from ..train.common import HostFrameStore
        rank, size = world(global_mesh())
        self.pi = rank if process_index is None else process_index
        self.pc = size if process_count is None else process_count
        self.shard = frame_shard(len(records), self.pi, self.pc)
        self.store = HostFrameStore(records[self.shard], with_priors, device)

    def gather_global(self, local_idxs, group=None):
        return self.store.gather(local_idxs)


@dataclasses.dataclass
class Shard:
    """A leaf split over the ranks along its leading axis: this rank's
    rows (a tensor or an array; the ranks' counts may differ)."""
    rows: object


def _gather_shard(rows, group) -> np.ndarray:
    x = torch.as_tensor(np.asarray(rows) if not isinstance(
        rows, torch.Tensor) else rows)
    dev = collective_device(group)
    is_bool = x.dtype == torch.bool
    x = x.to(dev, torch.uint8 if is_bool else x.dtype)
    counts = all_gather(torch.tensor(x.shape[0], device=dev), group)
    most = int(counts.max())
    pad = torch.cat([x, x.new_zeros((most - x.shape[0],) + x.shape[1:])])
    every = all_gather(pad, group)
    out = torch.cat([every[r, :int(c)] for r, c in enumerate(counts)])
    out = out.to(torch.bool) if is_bool else out
    return out.cpu().numpy()


def _gather_tree(tree, group):
    if isinstance(tree, Shard):
        return _gather_shard(tree.rows, group)
    if isinstance(tree, dict):
        return {k: _gather_tree(v, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gather_tree(v, group) for v in tree)
    return tree


def save_bundle_multihost(path: str, tree, group=None) -> None:
    """Write a bundle from a multi-process run: the ``Shard`` leaves are
    gathered in rank order (every rank takes part), rank 0 writes
    ``save_bundle``'s bytes of the whole tree, and every rank waits at a
    barrier until it has."""
    from ..io.checkpoints import save_bundle
    group = global_mesh() if group is None else group
    rank, size = world(group)
    host = _gather_tree(tree, group)
    if rank == 0:
        save_bundle(path, host)
    if size > 1:
        dist.barrier(group=group)
