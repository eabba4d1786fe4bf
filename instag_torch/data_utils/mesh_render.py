"""Differentiable triangle-mesh renderer for the photometric tracker
(counterpart of instag_tpu/data_utils/mesh_render.py), batched over frames.

The JAX package's algorithm, in plain torch: per 16x16 tile the triangles
whose screen box meets the tile, the front ``max_per_tile`` of them by
nearest-vertex depth (ties to the lower triangle index, as
``jax.lax.top_k`` keeps them), edge-function barycentrics with
``denom_safe``, and per pixel a hard z-argmin (the first minimum) over the
candidates that contain it. The selection carries no gradient; the
barycentric interpolation of the selected triangle does, in the vertices'
screen positions and in the colours, as the JAX renderer's
``stop_gradient`` on the argmin gives.

The selection runs without autograd in chunks of ``tile_chunk`` tiles (all
frames at once), so its ``[B, c, 256, K]`` temporaries live one chunk at a
time; the differentiable part is then one triangle a pixel, ``[B, H, W]``.

Camera convention: COLMAP-style, x right, y down, z forward; ``px = f
x / z + cx``; the vertices are already in camera space.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MeshRenderConfig:
    image_height: int
    image_width: int
    tile: int = 16
    max_per_tile: int = 64      # candidate triangles per tile
    tile_chunk: int = 64        # tiles per selection step
    z_near: float = 1e-3

    @property
    def tiles_y(self):
        return -(-self.image_height // self.tile)

    @property
    def tiles_x(self):
        return -(-self.image_width // self.tile)


def _corners(tris: torch.Tensor, px, py, z):
    """Each triangle's corner values [B, F] of the per-vertex [B, V]."""
    return [[a[:, tris[:, k]] for k in range(3)] for a in (px, py, z)]


def _barycentric(pxs, pys, x, y):
    """Edge-function barycentrics (w0, w1, w2) and the denominator of
    pixel centres against triangles with corners ``x``, ``y`` (the JAX
    renderer's formulas, which broadcast)."""
    dpx = pxs - x[2]
    dpy = pys - y[2]
    denom = (y[1] - y[2]) * (x[0] - x[2]) + (x[2] - x[1]) * (y[0] - y[2])
    denom_safe = torch.where(denom.abs() < 1e-9,
                             torch.full_like(denom, 1e-9), denom)
    w0 = ((y[1] - y[2]) * dpx + (x[2] - x[1]) * dpy) / denom_safe
    w1 = ((y[2] - y[0]) * dpx + (x[0] - x[2]) * dpy) / denom_safe
    return w0, w1, 1.0 - w0 - w1, denom


def _boxes(cfg: MeshRenderConfig, px, py, z, tris):
    """Each triangle's screen box [B, 1, F] (x min, x max, y min, y max),
    its key (minus its nearest depth, -inf behind the near plane) and its
    corners' x, y and z [B, F, 3]."""
    (x0, x1, x2), (y0, y1, y2), (z0, z1, z2) = _corners(tris, px, py, z)
    valid = (z0 > cfg.z_near) & (z1 > cfg.z_near) & (z2 > cfg.z_near)
    box = [torch.minimum(torch.minimum(x0, x1), x2)[:, None],
           torch.maximum(torch.maximum(x0, x1), x2)[:, None],
           torch.minimum(torch.minimum(y0, y1), y2)[:, None],
           torch.maximum(torch.maximum(y0, y1), y2)[:, None]]
    zmin = torch.minimum(torch.minimum(z0, z1), z2)
    neg_depth = torch.where(valid, -zmin, torch.full_like(zmin,
                                                          float("-inf")))
    corners = [torch.stack(c, -1) for c in ((x0, x1, x2), (y0, y1, y2),
                                             (z0, z1, z2))]
    return box, neg_depth[:, None], corners


def _candidates(cfg: MeshRenderConfig, box, neg_depth, tids):
    """The front ``max_per_tile`` triangles of the tiles ``tids`` by key,
    ties to the lower index: ids and whether each is a hit, [B, c, k]."""
    ty = (tids // cfg.tiles_x).to(neg_depth.dtype)
    tx = (tids % cfg.tiles_x).to(neg_depth.dtype)
    xa, xb = (tx * cfg.tile)[:, None], ((tx + 1) * cfg.tile)[:, None]
    ya, yb = (ty * cfg.tile)[:, None], ((ty + 1) * cfg.tile)[:, None]
    xmin, xmax, ymin, ymax = box
    hit = (xmax >= xa) & (xmin <= xb) & (ymax >= ya) & (ymin <= yb)
    keys = torch.where(hit, neg_depth, torch.full_like(neg_depth,
                                                       float("-inf")))
    vals, ids = torch.sort(keys, dim=-1, descending=True, stable=True)
    k = min(cfg.max_per_tile, keys.shape[-1])
    return ids[..., :k], vals[..., :k] > float("-inf")


@torch.no_grad()
def tile_candidates(cfg: MeshRenderConfig, px, py, z, tris, tids):
    """The candidate triangles of the tiles ``tids`` (ids and validity
    [B, c, k]) from the vertices' screen positions and depths [B, V]."""
    box, neg_depth, _ = _boxes(cfg, px, py, z, tris)
    return _candidates(cfg, box, neg_depth, tids)


@torch.no_grad()
def select_triangles(cfg: MeshRenderConfig, px: torch.Tensor,
                     py: torch.Tensor, z: torch.Tensor, tris: torch.Tensor):
    """The hard per-pixel selection: each pixel's triangle [B, Hp, Wp]
    (int64) and whether it covers the pixel [B, Hp, Wp] (bool), over the
    tile-padded frame, from the vertices' screen positions and depths
    [B, V] and the triangles [F, 3]."""
    B, tile = px.shape[0], cfg.tile
    box, neg_depth, corners = _boxes(cfg, px, py, z, tris)
    T = cfg.tiles_y * cfg.tiles_x
    off = torch.arange(tile, device=px.device, dtype=px.dtype)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    ox, oy = ox.reshape(-1), oy.reshape(-1)                     # [P]
    best_tri = torch.empty((B, T, tile * tile), dtype=torch.int64,
                           device=px.device)
    covered = torch.empty((B, T, tile * tile), dtype=torch.bool,
                          device=px.device)
    for s in range(0, T, cfg.tile_chunk):
        tids = torch.arange(s, min(s + cfg.tile_chunk, T), device=px.device)
        ids, gvalid = _candidates(cfg, box, neg_depth, tids)   # [B, c, k]
        # the hits sort first: columns past the most any tile has are
        # misses, which no pixel can select
        kk = max(1, int(gvalid.sum(-1).max()))
        ids, gvalid = ids[..., :kk], gvalid[..., :kk]
        c = ids.shape[1]
        flat = ids.reshape(B, c * kk, 1).expand(-1, -1, 3)
        gx, gy, gz = (a.gather(1, flat).reshape(B, c, kk, 3)
                      for a in corners)
        ty = (tids // cfg.tiles_x).to(px.dtype)
        tx = (tids % cfg.tiles_x).to(px.dtype)
        pxs = (tx[:, None] * tile + ox + 0.5)[None, :, :, None]  # [1,c,P,1]
        pys = (ty[:, None] * tile + oy + 0.5)[None, :, :, None]
        split = [g.unbind(-1) for g in (gx, gy, gz)]
        x, y, zz = ([v[:, :, None, :] for v in t] for t in split)
        w0, w1, w2, denom = _barycentric(pxs, pys, x, y)        # [B,c,P,kk]
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)
                  & (denom.abs() > 1e-9) & gvalid[:, :, None, :])
        zp = w0 * zz[0] + w1 * zz[1] + w2 * zz[2]
        zkey = torch.where(inside, zp, torch.full_like(zp, float("inf")))
        best = torch.argmin(zkey, dim=-1, keepdim=True)          # [B,c,P,1]
        covered[:, s:s + c] = inside.gather(-1, best)[..., 0]
        best_tri[:, s:s + c] = ids[:, :, None, :].expand(
            -1, -1, tile * tile, -1).gather(-1, best)[..., 0]

    def image(a):
        a = a.reshape(B, cfg.tiles_y, cfg.tiles_x, tile, tile)
        return a.permute(0, 1, 3, 2, 4).reshape(B, cfg.tiles_y * tile,
                                                cfg.tiles_x * tile)
    return image(best_tri), image(covered)


def render_mesh(cfg: MeshRenderConfig, verts_cam: torch.Tensor, tris,
                vert_colors: torch.Tensor, focal, cx, cy) -> torch.Tensor:
    """Rasterize meshes: camera-space vertices [(B,) V, 3] (z > 0 in
    front), triangles [F, 3] and per-vertex (lit) colours [(B,) V, 3] ->
    RGBA [(B,) H, W, 4], alpha 1 where a triangle covers the pixel;
    differentiable in ``verts_cam`` and ``vert_colors``."""
    single = verts_cam.dim() == 2
    if single:
        verts_cam, vert_colors = verts_cam[None], vert_colors[None]
    H, W = cfg.image_height, cfg.image_width
    tris = torch.as_tensor(tris, device=verts_cam.device).long()
    z = verts_cam[..., 2]
    safe_z = torch.clamp_min(z, cfg.z_near)
    px = focal * verts_cam[..., 0] / safe_z + cx
    py = focal * verts_cam[..., 1] / safe_z + cy

    best, covered = select_triangles(cfg, px.detach(), py.detach(),
                                     z.detach(), tris)
    best, covered = best[:, :H, :W], covered[:, :H, :W]
    B = verts_cam.shape[0]
    sel = tris[best.reshape(B, -1)]                            # [B, HW, 3]
    x = [px.gather(1, sel[..., k]) for k in range(3)]
    y = [py.gather(1, sel[..., k]) for k in range(3)]
    col = [vert_colors.gather(1, sel[..., k:k + 1].expand(-1, -1, 3))
           for k in range(3)]
    ys, xs = torch.meshgrid(
        torch.arange(H, device=px.device, dtype=px.dtype) + 0.5,
        torch.arange(W, device=px.device, dtype=px.dtype) + 0.5,
        indexing="ij")
    w0, w1, w2, _ = _barycentric(xs.reshape(1, -1), ys.reshape(1, -1), x, y)
    rgb = (w0[..., None] * col[0] + w1[..., None] * col[1]
           + w2[..., None] * col[2])
    cov = covered.reshape(B, -1, 1)
    rgb = torch.where(cov, rgb, torch.zeros_like(rgb))
    out = torch.cat([rgb, cov.to(rgb.dtype)], -1).reshape(B, H, W, 4)
    return out[0] if single else out
