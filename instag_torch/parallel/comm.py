"""The collectives of the port's parallel modes.

The JAX package writes no collective by hand: its ``shard_map`` and
sharding propagation let XLA insert them. Here each is explicit, and each
moves one flat bucket:

  * ``all_reduce_sum`` / ``all_reduce_mean`` over a list of tensors, which
    travel as one concatenated buffer;
  * ``all_gather(x)`` -> ``[W, *x.shape]``, one sum ``all_reduce`` over a
    zero-filled buffer in which each rank writes its own slot (``rank_slot``,
    which can also travel in a bucket of sums). Adding zeros
    leaves every value as it was (x + 0 = x), so the gather is exact, and
    it runs unchanged on NCCL and on gloo with CPU or CUDA tensors (gloo
    offers only ``broadcast`` and ``all_reduce`` for CUDA tensors; the
    native ``all_gather`` and ``reduce_scatter`` are not used on any
    backend, so that every backend runs the same code);
  * a maximum, as the gather followed by a local ``amax`` (its slots can
    travel in a bucket of sums: the adaptation step's radii do);
  * ``gather_rows``, a differentiable gather: its backward is the sum
    ``all_reduce`` of the cotangent followed by this rank's slot, the
    reduce-scatter that JAX's AD makes of ``all_gather``;
  * ``check_replicas``, which gathers a bit-level checksum of each
    replicated tensor and raises when the ranks hold different bits.

``group`` is a ``torch.distributed`` process group, or ``None`` for one
process, where every collective is the identity; a group of one rank
still runs its collectives (so that one NCCL rank exercises them).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def world(group) -> tuple[int, int]:
    """(this rank, the world size) of ``group`` (``(0, 1)`` for ``None``)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def collective_device(group) -> torch.device:
    """Where a host value of ``group``'s collectives travels: the current
    card for NCCL, else the host."""
    if group is not None and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _sum_(buf: torch.Tensor, group) -> torch.Tensor:
    if group is not None:           # a group of one rank runs it too
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def all_reduce_sum(tensors: list, group) -> list:
    """The element-wise sums over the ranks of ``tensors`` (one dtype), as
    new tensors, through one bucket (without a group, the tensors
    themselves, detached)."""
    if group is None or not tensors:
        return [t.detach() for t in tensors]
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    flat = _sum_(flat, group)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].view(t.shape))
        o += t.numel()
    return out


def all_reduce_mean(tensors: list, group) -> list:
    """The element-wise means over the ranks of ``tensors``."""
    w = world(group)[1]
    sums = all_reduce_sum(tensors, group)
    return sums if w == 1 else [s / w for s in sums]


def rank_slot(x: torch.Tensor, group) -> torch.Tensor:
    """``[W, *x.shape]`` zeros with ``x`` in this rank's slot: summed over
    the ranks (alone, or in a bucket with other sums), it is every rank's
    ``x`` in rank order, exactly (x + 0 = x, also for infinities)."""
    rank, w = world(group)
    buf = x.new_zeros((w,) + tuple(x.shape))
    buf[rank] = x.detach()
    return buf


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[W, *x.shape]``: every rank's ``x``, in rank order (exact)."""
    if group is None:
        return x.detach()[None]
    return _sum_(rank_slot(x, group), group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        rank = world(ctx.group)[0]
        return _sum_(g.contiguous().clone(), ctx.group)[rank], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather`` that autograd differentiates: the gradient reaching
    this rank's ``x`` is the sum over the ranks of their cotangents' slot
    of this rank."""
    if group is None:
        return x[None]
    return _GatherRows.apply(x, group)


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums over the bytes of ``t``: plain, and weighted by the
    position, so that moved bytes change it too."""
    b = t.detach().contiguous().reshape(-1)
    if b.dtype == torch.bool:
        b = b.to(torch.uint8)
    b = b.view(torch.uint8).to(torch.int64)
    pos = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return torch.stack([b.sum(), (b * pos).sum()])


def check_replicas(tensors: dict, group) -> None:
    """Raise ``RuntimeError`` unless every rank holds the same bits in each
    of ``tensors`` (name -> tensor); one gather of checksums."""
    if world(group)[1] == 1 or not tensors:
        return
    names = list(tensors)
    sums = torch.stack([_checksum(tensors[n]) for n in names])   # [n, 2]
    every = all_gather(sums, group)                               # [W, n, 2]
    bad = [n for j, n in enumerate(names)
           if not bool((every[:, j] == every[0, j]).all())]
    if bad:
        raise RuntimeError(f"replicated tensors differ across ranks: "
                           f"{', '.join(bad)}")
