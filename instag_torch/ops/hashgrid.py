"""Multiresolution hash-grid encoding (counterpart of
instag_tpu/ops/hashgrid.py; Instant-NGP / torch-ngp semantics).

  * per level ``l``: scale = H * s**l - 1, resolution = ceil(scale) + 1;
  * coordinates in [0, 1] map to ``pos = x * scale + 0.5`` (align_corners
    False); D-linear interpolation over the 2**D cell corners;
  * corner index: dense (row-major, stride ``resolution + 1``) when the
    dense table fits the level's slot, else the spatial hash
    ``xor_d(coord_d * prime_d) % hashmap_size``;
  * out-of-bounds inputs produce zeros.

Every level of the shipped tri-planes is a dense 2-D level; such levels are
computed together, as one bilinear gather over all levels, with the same
indices and weights as the reference's axis-factorized product (one gather
instead of a loop over levels keeps the launches per encode few). The
spatial hash works modulo 2**32 there (uint32); here it is computed in int64
and masked with ``& 0xFFFFFFFF`` before ``% hashmap_size``, which gives the
same index.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils.spans import spanned

# torch-ngp coherent hashing primes
_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    per_level_scale: float = 2.0
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: float | None = None
    gridtype: str = "hash"  # "hash" | "tiled"
    align_corners: bool = False
    interpolation: str = "linear"  # "linear" | "smoothstep"

    def __post_init__(self):
        if self.desired_resolution is not None:
            s = np.exp2(np.log2(self.desired_resolution / self.base_resolution)
                        / (self.num_levels - 1))
            object.__setattr__(self, "per_level_scale", float(s))
            object.__setattr__(self, "desired_resolution", None)

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    def total_params(self) -> int:
        return level_offsets(self)[1]


def level_offsets(cfg: HashGridConfig) -> tuple[np.ndarray, int]:
    """Offsets table (len L+1) into the flat embedding array: per-level
    param count is min(2**log2_hashmap_size, side**D) rounded up to /8."""
    offsets = [0]
    offset = 0
    max_params = 2 ** cfg.log2_hashmap_size
    for i in range(cfg.num_levels):
        resolution = int(np.ceil(cfg.base_resolution * cfg.per_level_scale ** i))
        side = resolution if cfg.align_corners else resolution + 1
        params = min(max_params, side ** cfg.input_dim)
        params = int(np.ceil(params / 8) * 8)
        offset += params
        offsets.append(offset)
    return np.asarray(offsets, dtype=np.int64), offset


def init_hashgrid(cfg: HashGridConfig, generator: torch.Generator,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A level table [total_params, level_dim] drawn Uniform(-1e-4, 1e-4)
    from ``generator`` (the grid encoder's init), on its device."""
    u = torch.rand((cfg.total_params(), cfg.level_dim), generator=generator,
                   dtype=dtype, device=generator.device)
    return (u * 2.0 - 1.0) * 1e-4


def _level_static(cfg: HashGridConfig, level: int):
    """(scale, resolution, hashmap_size, use_hash, offset) of one level."""
    offsets, _ = level_offsets(cfg)
    scale = float(np.exp2(level * np.log2(cfg.per_level_scale))
                  * cfg.base_resolution - 1.0)
    resolution = int(np.ceil(scale)) + 1
    hashmap_size = int(offsets[level + 1] - offsets[level])
    # dense indexing while the running stride fits the level's slot
    stride = 1
    side = resolution if cfg.align_corners else resolution + 1
    for _ in range(cfg.input_dim):
        if stride > hashmap_size:
            break
        stride *= side
    use_hash = cfg.gridtype == "hash" and stride > hashmap_size
    return scale, resolution, hashmap_size, use_hash, int(offsets[level])


def _is_dense_2d(cfg: HashGridConfig, level: int) -> bool:
    _, resolution, hsize, use_hash, _ = _level_static(cfg, level)
    side = resolution if cfg.align_corners else resolution + 1
    return cfg.input_dim == 2 and not use_hash and side * side <= hsize + 8


@functools.lru_cache(maxsize=None)
def _dense_2d_levels(cfg: HashGridConfig, device: torch.device):
    """Per-level (scale [L] f32, side [L] i64, offset [L] i64) on ``device``
    when every level is a dense 2-D level, else None."""
    if not all(_is_dense_2d(cfg, l) for l in range(cfg.num_levels)):
        return None
    statics = [_level_static(cfg, l) for l in range(cfg.num_levels)]
    sides = [r if cfg.align_corners else r + 1 for _, r, _, _, _ in statics]
    with torch.inference_mode(False):        # cached: usable under autograd
        return (torch.tensor([s[0] for s in statics], dtype=torch.float32,
                             device=device),
                torch.tensor(sides, dtype=torch.int64, device=device),
                torch.tensor([s[4] for s in statics], dtype=torch.int64,
                             device=device))


def _encode_dense_2d(levels, embeddings, x01, shift: float, smooth: bool):
    """All dense 2-D levels at once: [N, 2] -> [N, L * level_dim]."""
    scale, side, off = levels
    # one rounding (fused multiply-add), as XLA computes it
    pos = torch.addcmul(torch.full_like(x01, shift)[:, None, :],
                        x01[:, None, :], scale[None, :, None])   # [N, L, 2]
    pos_floor = torch.floor(pos)
    frac = pos - pos_floor
    if smooth:
        frac = frac * frac * (3.0 - 2.0 * frac)
    # negative cells occur only for out-of-bounds points, which are zeroed
    # by the caller; clamping keeps their gather in range
    cell = pos_floor.clamp_min(0).to(torch.int64)
    last = side - 1
    x0 = torch.minimum(cell[..., 0], last)
    x1 = torch.minimum(cell[..., 0] + 1, last)
    y0 = torch.minimum(cell[..., 1], last) * side + off
    y1 = torch.minimum(cell[..., 1] + 1, last) * side + off
    fx, fy = frac[..., 0:1], frac[..., 1:2]
    # y-pair first, then x (the reference's contraction order)
    m0 = (1.0 - fy) * embeddings[x0 + y0] + fy * embeddings[x0 + y1]
    m1 = (1.0 - fy) * embeddings[x1 + y0] + fy * embeddings[x1 + y1]
    out = (1.0 - fx) * m0 + fx * m1                                # [N, L, C]
    return out.reshape(out.shape[0], -1)


@spanned("hashgrid.encode")
def hashgrid_encode(cfg: HashGridConfig, embeddings: torch.Tensor,
                    x: torch.Tensor, bound: float = 1.0) -> torch.Tensor:
    """embeddings [total_params, level_dim], x [N, input_dim] in
    [-bound, bound] -> [N, num_levels * level_dim]."""
    D = cfg.input_dim
    x01 = (x + bound) / (2.0 * bound)
    oob = torch.any((x01 < 0.0) | (x01 > 1.0), dim=-1, keepdim=True)
    shift = 0.0 if cfg.align_corners else 0.5
    zero = torch.zeros((), dtype=embeddings.dtype, device=x.device)

    levels = _dense_2d_levels(cfg, x.device)
    if levels is not None:
        out = _encode_dense_2d(levels, embeddings, x01, shift,
                               cfg.interpolation == "smoothstep")
        return torch.where(oob, zero, out)

    outs = []
    for level in range(cfg.num_levels):
        scale, resolution, hsize, use_hash, off = _level_static(cfg, level)
        table = embeddings[off:off + hsize]
        side = resolution if cfg.align_corners else resolution + 1

        # one rounding (fused multiply-add), as XLA computes it: at the
        # finest levels ulp(pos) ~ 4e-6 is the error of frac itself
        pos = torch.addcmul(torch.full_like(x01, shift), x01,
                            torch.full_like(x01, scale))
        pos_floor = torch.floor(pos)
        frac = pos - pos_floor
        if cfg.interpolation == "smoothstep":
            frac = frac * frac * (3.0 - 2.0 * frac)
        # negative cells occur only for out-of-bounds points, which are
        # zeroed below; clamping keeps their gather in range
        cell = pos_floor.clamp_min(0).to(torch.int64)

        acc = torch.zeros((x.shape[0], cfg.level_dim), dtype=embeddings.dtype,
                          device=x.device)
        for corner in range(1 << D):
            w = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
            coord = []
            for d in range(D):
                if (corner >> d) & 1:
                    w = w * frac[:, d]
                    coord.append(cell[:, d] + 1)
                else:
                    w = w * (1.0 - frac[:, d])
                    coord.append(cell[:, d])
            if use_hash:
                idx = torch.zeros_like(coord[0])
                for d in range(D):
                    idx = idx ^ ((coord[d] * (_PRIMES[d] & _U32)) & _U32)
            else:
                idx = coord[0]
                stride = side
                for d in range(1, D):
                    idx = (idx + coord[d] * stride) & _U32
                    stride *= side
            idx = idx % hsize
            acc = acc + w[:, None] * table[idx]
        outs.append(acc)

    return torch.where(oob, zero, torch.cat(outs, dim=-1))


def triplane_config(base_resolution: int, desired_resolution: float,
                    num_levels: int = 12, level_dim: int = 1,
                    log2_hashmap_size: int = 17) -> HashGridConfig:
    """The motion-field tri-plane config: one 2-D grid per xy/yz/xz plane."""
    return HashGridConfig(
        input_dim=2, num_levels=num_levels, level_dim=level_dim,
        base_resolution=base_resolution, log2_hashmap_size=log2_hashmap_size,
        desired_resolution=desired_resolution)


def split_xyz(x: torch.Tensor):
    """[N,3] -> xy, yz, xz 2-D slices."""
    return x[:, :2], x[:, 1:], torch.cat([x[:, :1], x[:, 2:]], dim=-1)
