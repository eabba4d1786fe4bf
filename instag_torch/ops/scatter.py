"""Tile -> splat scatter-add, the VJP of the per-tile feature gather
(counterpart of instag_tpu/ops/pallas_scatter.py).

``scatter_add_tiles`` launches the hand-written CUDA kernel
``csrc/scatter_add.cu`` on CUDA tensors and runs its plain PyTorch version
``scatter_add_tiles_plain`` on CPU tensors. Both compute

    acc = zeros([F, n]);  acc[:, ids[t, j]] += g[:, t, j]  for j < cnt[t]

for g [F, T, K] float32, ids [T, K] int32 (values in [0, n)) and cnt [T]
int32, the valid (depth-sorted prefix) slot counts. Slots >= cnt[t] are
ignored. The kernel adds with atomics, so the order of the adds to one
splat, and the last bits of its sums, change from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels


def scatter_add_tiles_plain(g: torch.Tensor, ids: torch.Tensor,
                            cnt: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version (same contract, any device)."""
    F, T, K = g.shape
    valid = (torch.arange(K, device=g.device)[None, :]
             < cnt.to(g.device)[:, None])                       # [T, K]
    return torch.zeros((F, n), dtype=torch.float32, device=g.device
                       ).index_add_(1, ids[valid].long(),
                                    g[:, valid].to(torch.float32))


def scatter_add_tiles(g: torch.Tensor, ids: torch.Tensor, cnt: torch.Tensor,
                      n: int) -> torch.Tensor:
    """The scatter-add: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (see the module docstring for the contract)."""
    if g.device.type == "cpu":
        return scatter_add_tiles_plain(g, ids, cnt, n)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    if g.dtype != torch.float32 or g.dim() != 3 or not g.is_contiguous():
        raise ValueError("g must be contiguous float32 [F, T, K]")
    F, T, K = g.shape
    for name, x, shape in (("ids", ids, (T, K)), ("cnt", cnt, (T,))):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")
        if x.shape != shape or x.device != g.device:
            raise ValueError(f"{name} shape {tuple(x.shape)} on {x.device} "
                             f"!= {shape} on {g.device}")
    acc = torch.empty((F, n), dtype=torch.float32, device=g.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    kernels.launch("scatter_add", [P, P, P, P, I, I, I, I, P],
                   g.data_ptr(), ids.data_ptr(), cnt.data_ptr(),
                   acc.data_ptr(), F, T, K, n,
                   torch.cuda.current_stream(g.device).cuda_stream)
    scatter_add_tiles.launches += 1
    return acc


scatter_add_tiles.launches = 0
