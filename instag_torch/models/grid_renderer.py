"""GridRenderer (counterpart of instag_tpu/models/grid_renderer.py): the
reference's vestigial NeRF head, a 3-D hash grid of 16 levels x 2 with a
2^19 table, a sigma MLP and a colour MLP over degree-4 SH directions.

The reference builds it beside every Gaussian model and never calls it in
a forward or loss; it exists so that bundles keep their layout. Its
submodule names are the flax module's, so ``io.checkpoints.flax_params``
gives the JAX init tree's keys and shapes and ``io.from_jax.
load_motion_net`` reads that tree back.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.hashgrid import HashGridConfig
from ..utils.sh import sh_basis
from .encoders import HashGridEncoder
from .nets import MLP


class GridRenderer(nn.Module):

    def __init__(self, bound: float = 1.0, num_layers: int = 2,
                 hidden_dim: int = 64, geo_feat_dim: int = 15,
                 num_layers_color: int = 3, hidden_dim_color: int = 64):
        super().__init__()
        self.bound = bound
        self.encoder = HashGridEncoder(HashGridConfig(
            input_dim=3, num_levels=16, level_dim=2, base_resolution=16,
            log2_hashmap_size=19, desired_resolution=512 * bound))
        self.sigma_net = MLP(self.encoder.cfg.output_dim, 1 + geo_feat_dim,
                             hidden_dim, num_layers)
        self.color_net = MLP(16 + geo_feat_dim, 3, hidden_dim_color,
                             num_layers_color)
        # the JAX module's initial table: uniform in [-1e-4, 1e-4]
        nn.init.uniform_(self.encoder.embeddings, -1e-4, 1e-4)

    def density(self, x: torch.Tensor):
        h = self.sigma_net(self.encoder(x, self.bound))
        return torch.exp(h[..., 0]), h[..., 1:]

    def forward(self, x: torch.Tensor, d: torch.Tensor):
        """x [N, 3] positions, d [N, 3] unit view directions -> (sigma [N],
        rgb [N, 3])."""
        sigma, geo = self.density(x)
        h = torch.cat([sh_basis(3, d), geo], dim=-1)
        return sigma, torch.sigmoid(self.color_net(h))
