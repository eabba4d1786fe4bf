"""Gaussian point-cloud state (counterpart of instag_tpu/models/gaussians.py,
state and activated views only).

The cloud lives at a fixed capacity with an ``alive`` mask, as in the JAX
package: dead slots are zero-padded and masked out of projection.
Activations: softplus scaling, sigmoid opacity, safe-normalized quaternion.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as Fn

from ..utils.general import safe_normalize


def softplus_inverse(y: torch.Tensor) -> torch.Tensor:
    return y + torch.log(-torch.expm1(-y))


@dataclasses.dataclass
class GaussianParams:
    """Per-point attributes, padded to capacity C."""
    xyz: torch.Tensor            # [C, 3]
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, (D+1)^2-1, 3]
    identity: torch.Tensor       # [C, 1]
    scaling: torch.Tensor        # [C, 3]  (pre-softplus)
    rotation: torch.Tensor       # [C, 4]  (pre-normalize)
    opacity: torch.Tensor        # [C, 1]  (pre-sigmoid)


@dataclasses.dataclass
class GaussianState:
    params: GaussianParams
    alive: torch.Tensor              # [C] bool
    active_sh_degree: int
    max_sh_degree: int = 2

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    def get_scaling(self) -> torch.Tensor:
        return Fn.softplus(self.params.scaling)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.params.opacity)

    def get_rotation(self) -> torch.Tensor:
        return safe_normalize(self.params.rotation)

    def get_features(self) -> torch.Tensor:
        return torch.cat([self.params.features_dc,
                          self.params.features_rest], dim=1)
