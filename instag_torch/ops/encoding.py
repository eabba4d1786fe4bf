"""Encoder factory (counterpart of instag_tpu/ops/encoding.py): the encoding
name to ``(spec, output_dim)``. ``spec`` is a callable for the
parameter-free encoders and a ``HashGridConfig`` for the grid encoders,
whose tables are parameters (``models.encoders.HashGridEncoder``)."""

from __future__ import annotations

from functools import partial

from ..utils.sh import sh_basis
from .freq import freq_encode, freq_output_dim
from .hashgrid import HashGridConfig


def get_encoder(encoding: str, input_dim: int = 3, multires: int = 6,
                degree: int = 4, num_levels: int = 16, level_dim: int = 2,
                base_resolution: int = 16, log2_hashmap_size: int = 19,
                desired_resolution: float = 2048,
                align_corners: bool = False):
    """``(spec, output_dim)`` of the encoding ``None``, ``frequency``,
    ``sphere_harmonics`` (``degree`` - 1 is the SH degree, at most 4),
    ``hashgrid`` or ``tiledgrid``."""
    if encoding == "None":
        return (lambda x, **kw: x), input_dim
    if encoding == "frequency":
        return (partial(freq_encode, degree=multires),
                freq_output_dim(input_dim, multires))
    if encoding == "sphere_harmonics":
        if degree > 5:
            raise ValueError("the SH basis goes to degree 4 (degree <= 5)")
        return (lambda x, **kw: sh_basis(degree - 1, x)), degree ** 2
    if encoding in ("hashgrid", "tiledgrid"):
        cfg = HashGridConfig(
            input_dim=input_dim, num_levels=num_levels, level_dim=level_dim,
            base_resolution=base_resolution,
            log2_hashmap_size=log2_hashmap_size,
            desired_resolution=desired_resolution,
            gridtype="hash" if encoding == "hashgrid" else "tiled",
            align_corners=align_corners)
        return cfg, cfg.output_dim
    raise NotImplementedError(
        "Unknown encoding, choose from "
        "[None, frequency, sphere_harmonics, hashgrid, tiledgrid]")
