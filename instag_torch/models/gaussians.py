"""Gaussian point-cloud state (counterpart of instag_tpu/models/gaussians.py):
the state with its densification statistics, the activated views, the
per-attribute Adam and the per-step statistics updates.

The cloud lives at a fixed capacity with an ``alive`` mask, as in the JAX
package: dead slots are zero-padded and masked out of projection.
Activations: softplus scaling, sigmoid opacity, safe-normalized quaternion.
The updates are functional, as in the JAX package: each returns a new
state and leaves its inputs as they were.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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


PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(GaussianParams))


@dataclasses.dataclass
class GaussianState:
    """``max_radii2d``, ``xyz_grad_accum`` and ``denom`` default to zeros on
    ``alive``'s device; ``dropped_children`` counts children lost to a full
    capacity."""
    params: GaussianParams
    alive: torch.Tensor              # [C] bool
    active_sh_degree: int
    max_sh_degree: int = 2
    max_radii2d: torch.Tensor | None = None      # [C] f32
    xyz_grad_accum: torch.Tensor | None = None   # [C] f32
    denom: torch.Tensor | None = None            # [C] f32
    dropped_children: int = 0
    spatial_lr_scale: float = 1.0

    def __post_init__(self):
        for name in ("max_radii2d", "xyz_grad_accum", "denom"):
            if getattr(self, name) is None:
                setattr(self, name, torch.zeros(
                    self.alive.shape, dtype=torch.float32,
                    device=self.alive.device))

    def replace(self, **changes) -> "GaussianState":
        return dataclasses.replace(self, **changes)

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

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()


def one_up_sh_degree(state: GaussianState) -> GaussianState:
    return state.replace(active_sh_degree=min(state.active_sh_degree + 1,
                                              state.max_sh_degree))


# --------------------------------------------------------------------------
# Per-attribute Adam (eps 1e-15) with masked parameter updates.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class AdamState:
    mu: GaussianParams
    nu: GaussianParams
    step: int = 0


def adam_init(params: GaussianParams) -> AdamState:
    def zeros():
        return GaussianParams(**{n: torch.zeros_like(getattr(params, n))
                                 for n in PARAM_FIELDS})
    return AdamState(mu=zeros(), nu=zeros(), step=0)


@torch.no_grad()
def adam_update(params: GaussianParams, grads: GaussianParams,
                opt: AdamState, lrs: dict, alive: torch.Tensor,
                b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15) -> tuple[GaussianParams, AdamState]:
    """One Adam step with per-attribute learning rates ``lrs`` (name ->
    float or 0-d CPU tensor, so that no host-to-device copy waits on the
    card). The moments update in every slot, the parameters only where
    ``alive``; the bias correction is computed in float32, as the JAX
    package computes it."""
    step = opt.step + 1
    t = np.float32(step)
    c1 = float(np.float32(1.0) - np.float32(b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(b2) ** t)
    new_p, new_mu, new_nu = {}, {}, {}
    for n in PARAM_FIELDS:
        p, g = getattr(params, n), getattr(grads, n)
        mu = b1 * getattr(opt.mu, n) + (1 - b1) * g
        nu = b2 * getattr(opt.nu, n) + (1 - b2) * g * g
        upd = lrs[n] * (mu / c1) / (torch.sqrt(nu / c2) + eps)
        mask = alive.reshape((-1,) + (1,) * (p.dim() - 1))
        new_p[n] = torch.where(mask, p - upd, p)
        new_mu[n], new_nu[n] = mu, nu
    return (GaussianParams(**new_p),
            AdamState(mu=GaussianParams(**new_mu), nu=GaussianParams(**new_nu),
                      step=step))


# --------------------------------------------------------------------------
# Per-step densification statistics.
# --------------------------------------------------------------------------

@torch.no_grad()
def add_densification_stats(state: GaussianState, means2d_grad: torch.Tensor,
                            visible: torch.Tensor) -> GaussianState:
    """accum += ||pixel-space position grad||, denom += 1 for visible live
    points."""
    norm = torch.linalg.vector_norm(means2d_grad[:, :2], dim=-1)
    upd = visible & state.alive
    zero = torch.zeros_like(norm)
    return state.replace(
        xyz_grad_accum=state.xyz_grad_accum + torch.where(upd, norm, zero),
        denom=state.denom + upd.to(torch.float32))


@torch.no_grad()
def update_max_radii(state: GaussianState, radii: torch.Tensor,
                     visible: torch.Tensor) -> GaussianState:
    """The largest screen radius each visible point has had since the last
    densification."""
    r = torch.maximum(state.max_radii2d, radii.to(torch.float32))
    return state.replace(max_radii2d=torch.where(visible, r,
                                                 state.max_radii2d))
