"""Tri-plane spatial encoders over the hash-grid op (counterpart of
instag_tpu/models/encoders.py): xyz is split into xy/yz/xz planes, each
encoded by its own 2-D multiresolution grid."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.hashgrid import (HashGridConfig, hashgrid_encode, split_xyz,
                            triplane_config)


class HashGridEncoder(nn.Module):
    """One multiresolution hash grid; its table is the ``embeddings``
    parameter [total_params, level_dim]."""

    def __init__(self, cfg: HashGridConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = nn.Parameter(
            torch.empty(cfg.total_params(), cfg.level_dim))

    def forward(self, x: torch.Tensor, bound: float = 1.0) -> torch.Tensor:
        return hashgrid_encode(self.cfg, self.embeddings, x, bound)


class TriplaneEncoder(nn.Module):
    """xy/yz/xz tri-plane encoding of [N, 3] points in [-bound, bound]."""

    def __init__(self, base_resolution: int = 16,
                 desired_resolution: float = 256 * 0.15,
                 num_levels: int = 12, level_dim: int = 1,
                 log2_hashmap_size: int = 17):
        super().__init__()
        cfg = triplane_config(base_resolution, desired_resolution,
                              num_levels, level_dim, log2_hashmap_size)
        self.encoder_xy = HashGridEncoder(cfg)
        self.encoder_yz = HashGridEncoder(cfg)
        self.encoder_xz = HashGridEncoder(cfg)
        self.output_dim = 3 * num_levels * level_dim

    def forward(self, xyz: torch.Tensor, bound: float) -> torch.Tensor:
        xy, yz, xz = split_xyz(xyz)
        return torch.cat([self.encoder_xy(xy, bound),
                          self.encoder_yz(yz, bound),
                          self.encoder_xz(xz, bound)], dim=-1)
