"""Gaussian point-cloud state (counterpart of instag_tpu/models/gaussians.py):
the state with its densification statistics, the activated views, the
cloud made from points, the per-attribute Adam, the per-step statistics
updates (of one frame, or of a frame batch), densification and pruning,
and the capacity resize.

The cloud lives at a fixed capacity with an ``alive`` mask, as in the JAX
package: dead slots are zero-padded and masked out of projection.
Activations: softplus scaling, sigmoid opacity, safe-normalized quaternion.
The updates are functional, as in the JAX package: each returns a new
state and leaves its inputs as they were. Densification writes children
into free slots by masked scatters of static shape, so none of it waits
on the card; ``densify_and_prune`` reads one count back (the children a
full capacity dropped).

Thresholds compare in float32 as the JAX package's traced scalars do: a
product such as ``percent_dense * extent`` is rounded to float32 operands
and a float32 result before the comparison.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as Fn

from ..ops.knn import mean_knn_dist2
from ..utils.general import inverse_sigmoid, quat_to_rotmat, safe_normalize
from ..utils.sh import rgb2sh


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


def _map_params(fn, *trees: GaussianParams) -> GaussianParams:
    """``fn`` applied field by field across ``trees``."""
    return GaussianParams(**{n: fn(*(getattr(t, n) for t in trees))
                             for n in PARAM_FIELDS})


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

    def to(self, device) -> "GaussianState":
        return self.replace(
            params=_map_params(lambda x: x.to(device), self.params),
            **{n: getattr(self, n).to(device) for n in (
                "alive", "max_radii2d", "xyz_grad_accum", "denom")})

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


@torch.no_grad()
def create_from_points(points: torch.Tensor, colors: torch.Tensor,
                       capacity: int, max_sh_degree: int = 2,
                       spatial_lr_scale: float = 1.0) -> GaussianState:
    """A cloud of N points [N, 3] with colours [N, 3] in a capacity-C state:
    SH DC from the colours, log-scales log(sqrt(mean 3-NN distance^2)),
    identity rotation, opacity 0.1, active SH degree 0."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points do not fit capacity {capacity}")
    points = points.to(torch.float32)
    dist2 = torch.clamp_min(mean_knn_dist2(points), 1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].expand(n, 3)

    def pad(x):
        return torch.cat([x, x.new_zeros((capacity - n,) + x.shape[1:])])

    rest_k = (max_sh_degree + 1) ** 2 - 1
    rotation = points.new_zeros((n, 4))
    rotation[:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(points),
        features_dc=pad(rgb2sh(colors.to(torch.float32))[:, None, :]),
        features_rest=points.new_zeros((capacity, rest_k, 3)),
        identity=points.new_zeros((capacity, 1)),
        scaling=pad(scales),
        rotation=pad(rotation),
        opacity=pad(inverse_sigmoid(points.new_full((n, 1), 0.1))))
    return GaussianState(params=params,
                         alive=torch.arange(capacity, device=points.device) < n,
                         active_sh_degree=0, max_sh_degree=max_sh_degree,
                         spatial_lr_scale=spatial_lr_scale)


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

    def to(self, device) -> "AdamState":
        return AdamState(mu=_map_params(lambda x: x.to(device), self.mu),
                         nu=_map_params(lambda x: x.to(device), self.nu),
                         step=self.step)


def adam_init(params: GaussianParams) -> AdamState:
    return AdamState(mu=_map_params(torch.zeros_like, params),
                     nu=_map_params(torch.zeros_like, params), step=0)


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
def frame_stats(state: GaussianState, means2d_grads: torch.Tensor,
                radii: torch.Tensor, visible: torch.Tensor):
    """What a batch of frames adds to the densification statistics, from
    their [B, C, 2] pixel-space position gradients and [B, C] radii and
    visibility: ``(accum, denom, max_radii)``, each [C]. ``accum`` and
    ``denom`` sum each visible live point's gradient norm and count over
    the frames, as B serial steps add them; ``max_radii`` is each point's
    largest radius over the frames that see it (-inf where none does).
    Frames split over processes add their sums and maximum first."""
    norm = torch.linalg.vector_norm(means2d_grads[..., :2], dim=-1)
    upd = visible & state.alive
    neg = torch.full_like(norm, float("-inf"))
    return (torch.where(upd, norm, torch.zeros_like(norm)).sum(0),
            upd.to(torch.float32).sum(0),
            torch.where(visible, radii.to(torch.float32), neg).amax(0))


@torch.no_grad()
def add_frame_stats(state: GaussianState, accum: torch.Tensor,
                    denom: torch.Tensor,
                    max_radii: torch.Tensor) -> GaussianState:
    """The state with ``frame_stats``' increments added: accum += accum,
    denom += denom, and the largest screen radius each seen point has had
    since the last densification raised to ``max_radii``."""
    seen = max_radii > float("-inf")
    return state.replace(
        xyz_grad_accum=state.xyz_grad_accum + accum,
        denom=state.denom + denom,
        max_radii2d=torch.where(seen, torch.maximum(state.max_radii2d,
                                                    max_radii),
                                state.max_radii2d))


def add_densification_stats(state: GaussianState, means2d_grad: torch.Tensor,
                            radii: torch.Tensor,
                            visible: torch.Tensor) -> GaussianState:
    """One frame's statistics ([C, 2], [C], [C]) added: accum += ||pixel-
    space position grad||, denom += 1 for visible live points, and the
    visible points' largest radius raised."""
    return add_frame_stats(state, *frame_stats(
        state, means2d_grad[None], radii[None], visible[None]))


def _zero_moments_at(opt: AdamState, where: torch.Tensor) -> AdamState:
    """Zero both Adam moments in the slots where ``where`` [C] is True."""
    def z(x):
        return torch.where(where.reshape((-1,) + (1,) * (x.dim() - 1)),
                           torch.zeros_like(x), x)
    return AdamState(mu=_map_params(z, opt.mu), nu=_map_params(z, opt.nu),
                     step=opt.step)


def _zero_moments_field(opt: AdamState, name: str) -> AdamState:
    """Zero both Adam moments of one attribute."""
    def z(m: GaussianParams) -> GaussianParams:
        return dataclasses.replace(
            m, **{name: torch.zeros_like(getattr(m, name))})
    return AdamState(mu=z(opt.mu), nu=z(opt.nu), step=opt.step)


# --------------------------------------------------------------------------
# Densification and pruning as masked slot allocation.
# --------------------------------------------------------------------------

def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def _allocate(alive: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """A free slot for each wanted candidate (``want`` [C] over the slots'
    own indices), in slot order: dest [C] int64, ``capacity`` where the
    candidate is not wanted or no free slot is left. Free slots are taken
    in index order (a stable sort puts the dead slots first)."""
    cap = alive.shape[0]
    free_list = torch.argsort(alive.to(torch.uint8), stable=True)
    num_free = (~alive).sum()
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    ok = want & (rank < num_free)
    return torch.where(ok, free_list[rank.clamp(0, cap - 1)], cap)


def _scatter_rows(x: torch.Tensor, dest: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """``x`` with ``rows[j]`` written at ``dest[j]``; a ``dest`` equal to
    the capacity is dropped (it lands in a spare row that is cut off)."""
    out = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    return out.index_copy_(0, dest, rows)[:x.shape[0]]


def _taken(cap: int, dest: torch.Tensor, device) -> torch.Tensor:
    """[C] bool, True at the slots ``dest`` writes."""
    return _scatter_rows(torch.zeros(cap, dtype=torch.bool, device=device),
                         dest, torch.ones_like(dest, dtype=torch.bool))


@torch.no_grad()
def densify_and_prune(state: GaussianState, opt: AdamState,
                      noise: torch.Tensor, max_grad: float,
                      min_opacity: float, extent: float,
                      max_screen_size: float | None, percent_dense: float
                      ) -> tuple[GaussianState, AdamState]:
    """Clone, split and prune in one pass of static shape.

    ``noise`` [2, C, 3] holds the split's two standard-normal draws per slot
    (the JAX package draws them from its key inside). Points whose mean
    pixel-gradient norm reaches ``max_grad`` are cloned verbatim when their
    largest scale is at most ``percent_dense * extent``, and split into two
    children (drawn from the parent Gaussian, scales / 1.6) otherwise; the
    split parents die. Children take free slots in index order, with fresh
    Adam moments; those that find none are counted in ``dropped_children``.
    Then points below ``min_opacity`` die and, when ``max_screen_size`` is
    set, those larger than 0.1 extent in the world. The screen-size test
    reads the radii that densification has just zeroed, so it never fires,
    as in the reference. The statistics start again from zero."""
    p = state.params
    cap = state.capacity
    dev = p.xyz.device
    grads = torch.where(state.denom > 0, state.xyz_grad_accum / state.denom,
                        torch.zeros_like(state.denom))
    scal = Fn.softplus(p.scaling)
    max_scale = scal.max(-1).values
    small = max_scale <= _f32(np.float32(percent_dense) * np.float32(extent))
    hot = (grads >= _f32(max_grad)) & state.alive

    # clone: small high-gradient points, copied verbatim
    sel_clone = hot & small
    dest = _allocate(state.alive, sel_clone)
    dropped = (sel_clone & (dest >= cap)).sum()
    params = _map_params(lambda x: _scatter_rows(x, dest, x), p)
    taken = _taken(cap, dest, dev)
    alive = state.alive | taken
    opt = _zero_moments_at(opt, taken)

    # split: large high-gradient points -> 2 children from the parent
    sel_split = hot & ~small
    rot = quat_to_rotmat(safe_normalize(p.rotation))
    child_scaling = softplus_inverse(torch.clamp_min(scal / (0.8 * 2), 1e-6))
    for j in range(2):
        child_xyz = torch.einsum("nij,nj->ni", rot, noise[j] * scal) + p.xyz
        child = dataclasses.replace(p, xyz=child_xyz, scaling=child_scaling)
        dest = _allocate(alive, sel_split)
        dropped = dropped + (sel_split & (dest >= cap)).sum()
        params = _map_params(lambda x, c: _scatter_rows(x, dest, c),
                             params, child)
        taken = _taken(cap, dest, dev)
        alive = alive | taken
        opt = _zero_moments_at(opt, taken)
    alive = alive & ~sel_split

    prune = torch.sigmoid(params.opacity)[:, 0] < _f32(min_opacity)
    if max_screen_size:
        big = Fn.softplus(params.scaling).max(-1).values > _f32(
            np.float32(0.1) * np.float32(extent))
        prune = prune | big
    zeros = torch.zeros(cap, dtype=torch.float32, device=dev)
    return state.replace(
        params=params, alive=alive & ~prune, max_radii2d=zeros,
        xyz_grad_accum=zeros.clone(), denom=zeros.clone(),
        dropped_children=state.dropped_children + int(dropped)), opt


def prune_mask(state: GaussianState, opt: AdamState, mask: torch.Tensor
               ) -> tuple[GaussianState, AdamState]:
    """Kill the points where ``mask`` is True."""
    return state.replace(alive=state.alive & ~mask), opt


@torch.no_grad()
def reset_opacity(state: GaussianState, opt: AdamState
                  ) -> tuple[GaussianState, AdamState]:
    """Clamp opacity to at most 0.01 and zero its Adam moments."""
    opacity = inverse_sigmoid(torch.clamp_max(
        torch.sigmoid(state.params.opacity), 0.01))
    return (state.replace(params=dataclasses.replace(state.params,
                                                     opacity=opacity)),
            _zero_moments_field(opt, "opacity"))


# --------------------------------------------------------------------------
# Adaptive capacity: every padded op costs by capacity, not by live points,
# so the trainers pack the live slots into a power-of-two capacity that
# fits a few times the occupancy: grow eagerly, shrink only past a 2x band.
# --------------------------------------------------------------------------

def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def adaptive_start_capacity(init_num: int, cap_max: int,
                            min_cap: int = 4096) -> int:
    """A power of two that fits 2x the initial cloud, in [min_cap,
    cap_max]."""
    return min(max(_pow2ceil(2 * init_num), min_cap), cap_max)


def adaptive_capacity_target(n_alive: int, capacity: int, cap_max: int,
                             min_cap: int = 4096, headroom: int = 4,
                             allow_shrink: bool = True) -> int:
    """The next capacity for ``n_alive`` live slots (``capacity`` when no
    resize is due). Grow past 70 % occupancy, to at least 2x; shrink, when
    ``allow_shrink``, only to a target at most half the capacity."""
    want = min(max(_pow2ceil(headroom * max(n_alive, 1)), min_cap), cap_max)
    if n_alive > 0.7 * capacity:
        return min(max(capacity * 2, want), cap_max)
    if allow_shrink and want <= capacity // 2:
        return want
    return capacity


def _resize_take(state: GaussianState, new_capacity: int, keep_slots: bool):
    """The slot map of a resize: live slots packed to the front in index
    order (``keep_slots=False``), or every slot kept in place; then the
    tail cut or padded with zeros."""
    cap = state.capacity
    order = (None if keep_slots else
             torch.argsort((~state.alive).to(torch.uint8), stable=True))

    def take(x):
        y = x if order is None else x[order]
        if new_capacity <= cap:
            return y[:new_capacity].clone()
        return torch.cat([y, y.new_zeros((new_capacity - cap,) + y.shape[1:])])

    return take


def _resized(state: GaussianState, take) -> GaussianState:
    return state.replace(
        params=_map_params(take, state.params), alive=take(state.alive),
        max_radii2d=take(state.max_radii2d),
        xyz_grad_accum=take(state.xyz_grad_accum), denom=take(state.denom))


@torch.no_grad()
def pack_resize(state: GaussianState, opt: AdamState, new_capacity: int,
                keep_slots: bool = False) -> tuple[GaussianState, AdamState]:
    """Every [C, ...] buffer of the state and its Adam moments at
    ``new_capacity``: a permutation of slots plus dead-slot truncation or
    padding (the moments travel with their slots). The caller keeps the
    live slots within ``new_capacity``."""
    take = _resize_take(state, new_capacity, keep_slots)
    return _resized(state, take), AdamState(
        mu=_map_params(take, opt.mu), nu=_map_params(take, opt.nu),
        step=opt.step)


@torch.no_grad()
def pack_resize_state(state: GaussianState, new_capacity: int,
                      keep_slots: bool = False) -> GaussianState:
    """:func:`pack_resize` of a cloud without an optimizer."""
    return _resized(state, _resize_take(state, new_capacity, keep_slots))
