"""Brute-force splatting oracle (counterpart of
instag_tpu/ops/reference_splat.py) to hold the tiled rasterizer to.

Composites every visible splat at every pixel in strict global depth
order, with no tiling and no K cut: the sequential semantics of the
reference's CUDA rasterizer (forward), at a cost no training could pay. It
is plain PyTorch on purpose, so that it runs on the card beside the
kernels it checks: the projection and colours in float32 as the rasterizer
computes them, the walk in float64, one splat at a time.
"""

from __future__ import annotations

import math

import torch

from ..utils.sh import eval_sh
from .rasterize import RasterizeConfig, project_gaussians


@torch.no_grad()
def splat_reference(cfg: RasterizeConfig, means3d, opacities, scales,
                    rotations, viewmatrix, projmatrix, campos, tanfovx,
                    tanfovy, bg, shs=None, sh_degree=0, colors_precomp=None,
                    active=None, bbox_sigma: float | None = None):
    """(image [3, H, W], depth [1, H, W], normal [3, H, W], alpha [1, H, W])
    in float64 on the inputs' device, for ``rasterize``'s inputs.

    ``bbox_sigma`` limits each splat to its +-bbox_sigma standard-deviation
    pixel box. Any value >= 3.4 gives the full sweep's result exactly for
    opacity <= 1 (exp(-0.5 3.4^2) = 3.1e-3 is below the 1/255 alpha floor
    that skips a pixel anyway); None sweeps the whole frame for every
    splat."""
    H, W = cfg.image_height, cfg.image_width
    dev = means3d.device
    f64 = torch.float64
    proj = project_gaussians(cfg, means3d, scales, rotations, viewmatrix,
                             projmatrix, campos, tanfovx, tanfovy, active)
    if colors_precomp is None:
        dirs = means3d - campos[None, :]
        dirs = dirs / torch.clamp_min(
            torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), 1e-8)
        colors = torch.clamp_min(
            eval_sh(sh_degree, shs.transpose(-1, -2), dirs) + 0.5, 0.0)
    else:
        colors = colors_precomp

    # the per-splat scalars on the host, once: the walk sets its boxes from
    # them without reading the card
    order = torch.argsort(proj.depth, stable=True).tolist()
    px, py = proj.px.tolist(), proj.py.tolist()
    radii, vis = proj.radius.tolist(), proj.visible.tolist()
    conic = proj.conic.tolist()
    opac = opacities.reshape(-1).tolist()
    cols = colors.to(f64)
    depths = proj.depth.tolist()
    norms = proj.normal_cam.to(f64)

    ys, xs = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                            torch.arange(W, dtype=f64, device=dev),
                            indexing="ij")
    T = torch.ones((H, W), dtype=f64, device=dev)
    img = torch.zeros((3, H, W), dtype=f64, device=dev)
    dep = torch.zeros((H, W), dtype=f64, device=dev)
    nrm = torch.zeros((3, H, W), dtype=f64, device=dev)
    alp = torch.zeros((H, W), dtype=f64, device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)

    for i in order:
        if not vis[i]:
            continue
        if bbox_sigma is None:
            sl = (slice(None), slice(None))
        else:
            # |dx|, |dy| <= bbox_sigma sqrt(lambda_max) bounds the
            # bbox_sigma Mahalanobis ellipse; radius / 3 = sqrt(lambda_max)
            r = radii[i] / 3.0 * bbox_sigma
            y0 = max(int(math.floor(py[i] - r)), 0)
            y1 = min(int(math.ceil(py[i] + r)) + 1, H)
            x0 = max(int(math.floor(px[i] - r)), 0)
            x1 = min(int(math.ceil(px[i] + r)) + 1, W)
            if y0 >= y1 or x0 >= x1:
                continue
            sl = (slice(y0, y1), slice(x0, x1))
        dx = xs[sl] - px[i]
        dy = ys[sl] - py[i]
        A, B, C = conic[i]
        power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
        alpha = torch.clamp_max(opac[i] * torch.exp(power), 0.99)
        ok = (power <= 0.0) & (alpha >= 1.0 / 255.0) & ~done[sl]
        test_T = T[sl] * (1 - alpha)
        stop = ok & (test_T < 1e-4)
        ok = ok & (test_T >= 1e-4)
        w = torch.where(ok, alpha * T[sl], 0.0)
        img[(slice(None),) + sl] += cols[i][:, None, None] * w
        dep[sl] += depths[i] * w
        nrm[(slice(None),) + sl] += norms[i][:, None, None] * w
        alp[sl] += w
        T[sl] = torch.where(ok, test_T, T[sl])
        done[sl] |= stop

    img += bg.to(f64)[:, None, None] * T
    return img, dep[None], nrm, alp[None]
