"""Depth map to normal map (counterpart of instag_tpu/utils/normals.py),
for the val reporter's depth-normal panel."""

from __future__ import annotations

import torch


def depths_to_points(view_transform: torch.Tensor, tanfovx, tanfovy,
                     depth: torch.Tensor) -> torch.Tensor:
    """World-space points [H, W, 3] of a depth map [1, H, W] seen by the
    camera of the transposed world-to-view ``view_transform`` [4, 4]."""
    h, w = depth.shape[-2:]
    fx = w / (2.0 * tanfovx)
    fy = h / (2.0 * tanfovy)
    c2w = torch.linalg.inv(view_transform.T)
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=depth.dtype, device=depth.device),
        torch.arange(w, dtype=depth.dtype, device=depth.device),
        indexing="ij")
    dirs_cam = torch.stack([(gx - w / 2.0) / fx, (gy - h / 2.0) / fy,
                            torch.ones_like(gx)], -1)
    rays_d = dirs_cam @ c2w[:3, :3].T
    return depth[0][..., None] * rays_d + c2w[:3, 3]


def depth_to_normal(view_transform: torch.Tensor, tanfovx, tanfovy,
                    depth: torch.Tensor) -> torch.Tensor:
    """Normals [H, W, 3] from central differences of the depth map's
    points; the border pixels are zero."""
    points = depths_to_points(view_transform, tanfovx, tanfovy, depth)
    dx = points[2:, 1:-1] - points[:-2, 1:-1]
    dy = points[1:-1, 2:] - points[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                            1e-12)
    out = torch.zeros_like(points)
    out[1:-1, 1:-1] = n
    return out
