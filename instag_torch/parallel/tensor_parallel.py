"""Splat- and tile-sharded (tensor-parallel) rendering (counterpart of
instag_tpu/parallel/tensor_parallel.py), one band of the image a rank.

  1. **Projection sharded over splats**: each rank projects its N / W
     splats (EWA covariance, SH colours, screen radius), element-wise.
  2. **The projected rows gathered** (``comm.gather_rows``, 16 floats a
     splat): every later stage is then exact, since alpha compositing is
     order-dependent and independently composited splat subsets would not
     merge.
  3. **Selection and compositing sharded over tile rows**: rank r owns the
     band of ``tiles_y / W`` tile rows from ``r * band`` and runs the same
     ``ops.rasterize`` selection and kernel composite (the three Hopper
     kernels on the card) on it, a band being a shorter image whose splat
     y coordinates are shifted by the band's origin.
  4. **Outputs stay sharded**: the images are this rank's band (rows
     ``[r * band_h, (r + 1) * band_h)``, the last band cropped to the
     image), the radii this rank's splats.

The backward's only collective is the gather's transpose, a sum
``all_reduce`` of the gathered rows' cotangent of which each rank keeps
its slot: each rank ends up with its own splats' gradients.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.rasterize import (Projected, RasterizeConfig, RasterizeOutput,
                             _composite_tiles, _composite_tiles_kernel,
                             _tile_select, project_gaussians, sh_colors)
from .comm import gather_rows, world


def band_config(cfg: RasterizeConfig, n_shards: int) -> RasterizeConfig:
    """A rank's band: the image of ``tiles_y / n_shards`` tile rows at the
    full (tile-padded) width."""
    if cfg.tiles_y % n_shards:
        raise ValueError(
            f"tiles_y={cfg.tiles_y} must divide by the mesh axis size "
            f"{n_shards} (pad image_height to a multiple of "
            f"{cfg.tile * n_shards})")
    return dataclasses.replace(
        cfg, image_height=(cfg.tiles_y // n_shards) * cfg.tile,
        image_width=cfg.tiles_x * cfg.tile)


def rasterize_tensor_parallel(cfg: RasterizeConfig, group,
                              means3d: torch.Tensor,
                              opacities: torch.Tensor,
                              scales: torch.Tensor,
                              rotations: torch.Tensor,
                              viewmatrix: torch.Tensor,
                              projmatrix: torch.Tensor,
                              campos: torch.Tensor,
                              tanfovx, tanfovy, bg: torch.Tensor,
                              shs: torch.Tensor | None = None,
                              sh_degree: int = 0,
                              colors_precomp: torch.Tensor | None = None,
                              extra_attrs: torch.Tensor | None = None,
                              means2d_offset: torch.Tensor | None = None,
                              active: torch.Tensor | None = None
                              ) -> RasterizeOutput:
    """``ops.rasterize.rasterize`` over the ranks of ``group``: the
    per-splat inputs are this rank's shard (every rank the same count),
    the camera and ``bg`` are every rank's. Returns the 6-output
    ``RasterizeOutput`` of this rank's band (images [C, rows of the band
    inside the image, W]) and of its splats (radii)."""
    rank, w = world(group)
    cfgb = band_config(cfg, w)
    band_h = cfgb.image_height
    n = means3d.shape[0]
    opac = opacities.reshape(-1)
    extra = (torch.ones((n,), dtype=means3d.dtype, device=means3d.device)
             if extra_attrs is None else extra_attrs.reshape(-1))
    if means2d_offset is None:
        means2d_offset = means3d.new_zeros((n, 2))

    # ---- 1: projection of this rank's splats ----
    proj = project_gaussians(cfg, means3d, scales, rotations, viewmatrix,
                             projmatrix, campos, tanfovx, tanfovy, active)
    px = proj.px + means2d_offset[:, 0]
    py = proj.py + means2d_offset[:, 1]
    colors = (sh_colors(means3d, campos, shs, sh_degree)
              if colors_precomp is None else colors_precomp)
    radii = torch.where(proj.visible, proj.radius,
                        torch.zeros_like(proj.radius)).to(torch.int32)

    # ---- 2: gather the screen rows [F, N] ----
    rows = torch.stack([
        px, py, proj.depth, proj.conic[:, 0], proj.conic[:, 1],
        proj.conic[:, 2], proj.radius, proj.visible.to(px.dtype),
        proj.normal_cam[:, 0], proj.normal_cam[:, 1], proj.normal_cam[:, 2],
        colors[:, 0], colors[:, 1], colors[:, 2], opac, extra], dim=0)
    g = gather_rows(rows, group)                        # [W, F, N / W]
    g = g.permute(1, 0, 2).reshape(rows.shape[0], -1)   # [F, N]

    # ---- 3: this rank's band of tile rows ----
    band0 = float(rank * band_h)
    projb = Projected(
        px=g[0], py=g[1] - band0, depth=g[2],
        conic=torch.stack([g[3], g[4], g[5]], dim=-1), radius=g[6],
        visible=g[7] > 0.5,
        normal_cam=torch.stack([g[8], g[9], g[10]], dim=-1))
    ids, valid = _tile_select(cfgb, projb)
    composite = (_composite_tiles_kernel if cfg.backend == "kernel"
                 else _composite_tiles)
    out = composite(cfgb, projb.px, projb.py, projb, g[14],
                    torch.stack([g[11], g[12], g[13]], dim=-1), g[15], ids,
                    valid, bg)

    # ---- 4: the band inside the image, the radii of this rank's splats --
    rows_in = max(0, min(band_h, cfg.image_height - rank * band_h))
    W = cfg.image_width
    crop = lambda x: x[:, :rows_in, :W]                 # noqa: E731
    return RasterizeOutput(crop(out.image), crop(out.depth),
                           crop(out.normal), crop(out.alpha), radii,
                           crop(out.extra))
