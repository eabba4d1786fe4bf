"""3D Gaussian splatting rasterizer, forward (counterpart of
instag_tpu/ops/rasterize.py).

Outputs the same 6-tuple as the JAX package — (image, depth, normal, alpha,
radii, extra) composited over ``bg`` — from the same pieces:

  * ``project_gaussians``: EWA projection as element-wise math over [N];
  * ``_tile_select``: each 16x16 tile keeps its front-most ``max_per_tile``
    intersecting splats by depth (exact ``torch.topk``);
  * compositing, by ``RasterizeConfig.backend``:
      "kernel" (default) gathers per-tile feature rows [F, T, K]
      (``TileGather``, whose backward is ``ops.scatter.scatter_add_tiles``)
      and runs ``ops.composite.CompositeFunction`` — the hand-written CUDA
      kernels on the card, their plain PyTorch versions on the CPU;
      "plain" is the tensor formulation of the JAX package's XLA path
      (exclusive cumulative sum of log(1 - alpha) over the sorted K axis),
      differentiated by autograd.
  Both are differentiable, and both composite ``aux_colors`` with
  stop-gradient weights.

Selection is always exact. The JAX package's default ``approx_topk=True``
uses ``jax.lax.approx_max_k``, an operation of the TPU only; here
``approx_topk`` defaults to False and True raises. Parity with the JAX
package is defined against its ``approx_topk=False`` configuration.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..utils.sh import eval_sh
from ..utils.spans import span, spanned
from .composite import CompositeFunction
from .scatter import scatter_add_tiles

_SELECT_CHUNK = 128     # tiles per top-k sweep in _tile_select
_PLAIN_CHUNK = 32       # tiles per step of the "plain" composite


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    image_height: int
    image_width: int
    tile: int = 16
    max_per_tile: int = 256       # K front-most splats composited per tile
    depth_cull: float = 0.2       # view-space near cull (p_view.z <= 0.2)
    approx_topk: bool = False     # exact selection only (see module doc)
    backend: str = "kernel"       # "kernel" | "plain"

    def __post_init__(self):
        if self.approx_topk:
            raise ValueError(
                "approx_topk=True is the TPU's approx_max_k; the port "
                "selects exactly (approx_topk=False)")
        if self.backend not in ("kernel", "plain"):
            raise ValueError(f"unknown backend {self.backend!r}")

    @property
    def tiles_y(self) -> int:
        return -(-self.image_height // self.tile)

    @property
    def tiles_x(self) -> int:
        return -(-self.image_width // self.tile)

    @property
    def num_tiles(self) -> int:
        return self.tiles_y * self.tiles_x


class Projected(NamedTuple):
    px: torch.Tensor        # [N] pixel x of the 2-D mean
    py: torch.Tensor        # [N] pixel y
    depth: torch.Tensor     # [N] view-space z
    conic: torch.Tensor     # [N, 3] inverse 2-D covariance (A, B, C)
    radius: torch.Tensor    # [N] float screen radius (3 sigma)
    visible: torch.Tensor   # [N] bool
    normal_cam: torch.Tensor  # [N, 3] camera-space splat normal


class RasterizeOutput(NamedTuple):
    image: torch.Tensor     # [3, H, W]
    depth: torch.Tensor     # [1, H, W]
    normal: torch.Tensor    # [3, H, W]
    alpha: torch.Tensor     # [1, H, W]
    radii: torch.Tensor     # [N] int32 (0 => culled/invisible)
    extra: torch.Tensor     # [1, H, W] accumulated extra_attrs


@spanned("rasterize.project")
def project_gaussians(cfg: RasterizeConfig, means3d, scales, rotations,
                      viewmatrix, projmatrix, campos, tanfovx, tanfovy,
                      active=None, cov3d_precomp=None) -> Projected:
    """Project Gaussians to screen space with EWA covariance.
    ``viewmatrix``/``projmatrix`` are transposed (row-vector convention).
    ``cov3d_precomp`` [N, 6], the upper-triangular world covariance
    (c00, c01, c02, c11, c12, c22), overrides ``scales``/``rotations`` in
    the EWA; the splat normals still come from them."""
    H, W = cfg.image_height, cfg.image_width
    focal_x = W / (2.0 * tanfovx)
    focal_y = H / (2.0 * tanfovy)

    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    V, Pm = viewmatrix, projmatrix

    pvx = mx * V[0, 0] + my * V[1, 0] + mz * V[2, 0] + V[3, 0]
    pvy = mx * V[0, 1] + my * V[1, 1] + mz * V[2, 1] + V[3, 1]
    pvz = mx * V[0, 2] + my * V[1, 2] + mz * V[2, 2] + V[3, 2]

    phx = mx * Pm[0, 0] + my * Pm[1, 0] + mz * Pm[2, 0] + Pm[3, 0]
    phy = mx * Pm[0, 1] + my * Pm[1, 1] + mz * Pm[2, 1] + Pm[3, 1]
    phw = mx * Pm[0, 3] + my * Pm[1, 3] + mz * Pm[2, 3] + Pm[3, 3]
    # sign-preserving clamp: a splat crossing the camera plane can make
    # phw + 1e-7 exactly 0 (f32) -> inf px; visible splats never hit it
    denom = phw + 1e-7
    denom = torch.where(denom.abs() < 1e-6,
                        torch.where(denom < 0, -1e-6, 1e-6), denom)
    p_w = 1.0 / denom

    # ndc -> pixel: ((v + 1) * S - 1) * 0.5
    px = ((phx * p_w + 1.0) * W - 1.0) * 0.5
    py = ((phy * p_w + 1.0) * H - 1.0) * 0.5
    tz = pvz

    # rotation from the normalized quaternion (w, x, y, z); the 1e-24 keeps
    # the zero quaternions of dead padded slots finite
    qn = rotations / torch.sqrt(
        torch.sum(rotations * rotations, -1, keepdim=True) + 1e-24)
    qr, qx, qy, qz = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    R00 = 1 - 2 * (qy * qy + qz * qz)
    R01 = 2 * (qx * qy - qr * qz)
    R02 = 2 * (qx * qz + qr * qy)
    R10 = 2 * (qx * qy + qr * qz)
    R11 = 1 - 2 * (qx * qx + qz * qz)
    R12 = 2 * (qy * qz - qr * qx)
    R20 = 2 * (qx * qz - qr * qy)
    R21 = 2 * (qy * qz + qr * qx)
    R22 = 1 - 2 * (qx * qx + qy * qy)

    # Sigma = R S^2 R^T (6 unique entries)
    if cov3d_precomp is not None:
        c00, c01, c02, c11, c12, c22 = cov3d_precomp.unbind(-1)
    else:
        s0, s1, s2 = scales[:, 0] ** 2, scales[:, 1] ** 2, scales[:, 2] ** 2
        c00 = R00 * R00 * s0 + R01 * R01 * s1 + R02 * R02 * s2
        c11 = R10 * R10 * s0 + R11 * R11 * s1 + R12 * R12 * s2
        c22 = R20 * R20 * s0 + R21 * R21 * s1 + R22 * R22 * s2
        c01 = R00 * R10 * s0 + R01 * R11 * s1 + R02 * R12 * s2
        c02 = R00 * R20 * s0 + R01 * R21 * s1 + R02 * R22 * s2
        c12 = R10 * R20 * s0 + R11 * R21 * s1 + R12 * R22 * s2

    # EWA: clamp view-space angles to 1.3 * fov; tz clamps at the near-cull
    # depth (culled splats would otherwise overflow the Jacobian to NaN)
    safe_tz = torch.clamp_min(tz, cfg.depth_cull)
    limx, limy = 1.3 * tanfovx, 1.3 * tanfovy
    txz = torch.clamp(pvx / safe_tz, -limx, limx) * safe_tz
    tyz = torch.clamp(pvy / safe_tz, -limy, limy) * safe_tz
    z2 = safe_tz * safe_tz
    j00 = focal_x / safe_tz
    j02 = -(focal_x * txz) / z2
    j11 = focal_y / safe_tz
    j12 = -(focal_y * tyz) / z2

    t00 = j00 * V[0, 0] + j02 * V[0, 2]
    t01 = j00 * V[1, 0] + j02 * V[1, 2]
    t02 = j00 * V[2, 0] + j02 * V[2, 2]
    t10 = j11 * V[0, 1] + j12 * V[0, 2]
    t11 = j11 * V[1, 1] + j12 * V[1, 2]
    t12 = j11 * V[2, 1] + j12 * V[2, 2]

    # cov2d = T Sigma T^T (+ 0.3 px low-pass on the diagonal)
    a = (t00 * t00 * c00 + t01 * t01 * c11 + t02 * t02 * c22
         + 2 * (t00 * t01 * c01 + t00 * t02 * c02 + t01 * t02 * c12)) + 0.3
    b = (t00 * t10 * c00 + t01 * t11 * c11 + t02 * t12 * c22
         + (t00 * t11 + t01 * t10) * c01 + (t00 * t12 + t02 * t10) * c02
         + (t01 * t12 + t02 * t11) * c12)
    c = (t10 * t10 * c00 + t11 * t11 * c11 + t12 * t12 * c22
         + 2 * (t10 * t11 * c01 + t10 * t12 * c02 + t11 * t12 * c12)) + 0.3

    det = a * c - b * b
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))

    visible = (tz > cfg.depth_cull) & (det > 0) & (radius > 0)
    if active is not None:
        visible = visible & active

    # splat normal: shortest principal axis, oriented toward the camera,
    # in camera coordinates
    sx, sy, sz = scales[:, 0], scales[:, 1], scales[:, 2]
    sel0 = (sx <= sy) & (sx <= sz)
    sel1 = (~sel0) & (sy <= sz)
    w0 = sel0.to(means3d.dtype)
    w1 = sel1.to(means3d.dtype)
    w2 = 1.0 - w0 - w1
    nwx = w0 * R00 + w1 * R01 + w2 * R02
    nwy = w0 * R10 + w1 * R11 + w2 * R12
    nwz = w0 * R20 + w1 * R21 + w2 * R22
    dot_cam = (nwx * (campos[0] - mx) + nwy * (campos[1] - my)
               + nwz * (campos[2] - mz))
    flip = torch.where(dot_cam < 0, -1.0, 1.0)
    nwx, nwy, nwz = nwx * flip, nwy * flip, nwz * flip
    n_cam = torch.stack([
        nwx * V[0, 0] + nwy * V[1, 0] + nwz * V[2, 0],
        nwx * V[0, 1] + nwy * V[1, 1] + nwz * V[2, 1],
        nwx * V[0, 2] + nwy * V[1, 2] + nwz * V[2, 2],
    ], dim=-1)

    return Projected(px, py, tz, conic, radius, visible, n_cam)


def _tile_hits(cfg: RasterizeConfig, proj: Projected):
    """Per chunk of ``_SELECT_CHUNK`` tiles [t0, t1): (t0, t1, hit
    [t1 - t0, N]), where a splat hits a tile when its 3-sigma square
    overlaps the tile's closed pixel square."""
    T, tile = cfg.num_tiles, cfg.tile
    r = proj.radius
    xmin, xmax = proj.px - r, proj.px + r
    ymin, ymax = proj.py - r, proj.py + r
    for t0 in range(0, T, _SELECT_CHUNK):
        t1 = min(T, t0 + _SELECT_CHUNK)
        tids = torch.arange(t0, t1, device=proj.px.device)
        tx = (tids % cfg.tiles_x).to(proj.px.dtype)
        ty = (tids // cfg.tiles_x).to(proj.px.dtype)
        x0, x1 = tx * tile, (tx + 1) * tile
        y0, y1 = ty * tile, (ty + 1) * tile
        yield t0, t1, ((xmax[None, :] >= x0[:, None])
                       & (xmin[None, :] <= x1[:, None])
                       & (ymax[None, :] >= y0[:, None])
                       & (ymin[None, :] <= y1[:, None]))


@spanned("rasterize.select")
def _tile_select(cfg: RasterizeConfig, proj: Projected):
    """Per-tile front-most-K selection: (ids [T, K] int32, valid [T, K]
    bool), nearest first; valid is a prefix of each row."""
    T, K = cfg.num_tiles, cfg.max_per_tile
    N = proj.px.shape[0]
    dev = proj.px.device
    neg_inf = torch.tensor(float("-inf"), device=dev)
    neg_depth = torch.where(proj.visible, -proj.depth, neg_inf)
    kk = min(K, N)

    ids = torch.zeros((T, K), dtype=torch.int32, device=dev)
    valid = torch.zeros((T, K), dtype=torch.bool, device=dev)
    for t0, t1, hit in _tile_hits(cfg, proj):
        keys = torch.where(hit, neg_depth[None, :], neg_inf)     # [c, N]
        vals, idx = torch.topk(keys, kk, dim=-1)                 # nearest first
        ids[t0:t1, :kk] = idx.to(torch.int32)
        valid[t0:t1, :kk] = vals > float("-inf")
    return ids, valid


# public: the guarded refresh of select_auto selects fresh tile lists from a
# Prepared's projection
tile_select = _tile_select


@torch.no_grad()
def selection_stats(cfg: RasterizeConfig, means3d, scales, rotations,
                    viewmatrix, projmatrix, campos, tanfovx, tanfovy,
                    active=None) -> dict:
    """Per-tile hit counts of the visible splats, without selection: the
    mean and the largest count, and the fraction of tiles whose count
    exceeds ``max_per_tile`` (they composite only their front K), as 0-d
    tensors on the input's device."""
    proj = project_gaussians(cfg, means3d, scales, rotations, viewmatrix,
                             projmatrix, campos, tanfovx, tanfovy, active)
    hits = torch.cat([(hit & proj.visible[None, :]).sum(-1)
                      for _, _, hit in _tile_hits(cfg, proj)])
    return {"mean_hits": hits.to(torch.float32).mean(),
            "max_hits": hits.max(),
            "saturated_frac": (hits > cfg.max_per_tile).to(
                torch.float32).mean()}


class Prepared(NamedTuple):
    """Shared projection + per-tile selection."""
    proj: Projected
    px: torch.Tensor
    py: torch.Tensor
    ids: torch.Tensor
    valid: torch.Tensor


def prepare(cfg: RasterizeConfig, means3d, scales, rotations, viewmatrix,
            projmatrix, campos, tanfovx, tanfovy, means2d_offset=None,
            active=None, selection=None, cov3d_precomp=None) -> Prepared:
    """Projection + tile selection only. ``selection``: ``(ids, valid)`` from
    a previous frame to reuse instead of selecting (composite it with
    ``mask_invisible=True``), or a callable ``(proj, px, py) -> (ids,
    valid)`` that sees this frame's projection and picks the tile lists
    itself (the guarded refresh of ``synthesize``'s ``select_auto``).
    ``cov3d_precomp`` as in ``project_gaussians``."""
    proj = project_gaussians(cfg, means3d, scales, rotations, viewmatrix,
                             projmatrix, campos, tanfovx, tanfovy, active,
                             cov3d_precomp)
    px, py = proj.px, proj.py
    if means2d_offset is not None:
        px = px + means2d_offset[:, 0]
        py = py + means2d_offset[:, 1]
    if selection is None:
        ids, valid = _tile_select(cfg, proj)
    elif callable(selection):
        ids, valid = selection(proj, px, py)
    else:
        ids, valid = selection
    return Prepared(proj, px, py, ids, valid)


def composite_prepared(cfg: RasterizeConfig, prep: Prepared, opacities,
                       colors, bg, extra_attrs=None, light: bool = False,
                       aux_colors=None, mask_invisible: bool = False):
    """Composite an existing Prepared. ``light`` accumulates color + alpha
    only (depth/normal/extra come back zero); ``aux_colors`` [N, A] are
    extra channels composited with the same weights and returned as a
    second value [A, H, W]; ``mask_invisible`` zeroes the opacity of culled
    splats (needed for a reused selection)."""
    opac = opacities.reshape(-1)
    if mask_invisible:
        opac = torch.where(prep.proj.visible, opac, torch.zeros_like(opac))
    if extra_attrs is None:
        extra_attrs = torch.ones_like(opac)
    else:
        extra_attrs = extra_attrs.reshape(-1)
    composite = (_composite_tiles_kernel if cfg.backend == "kernel"
                 else _composite_tiles)
    return composite(cfg, prep.px, prep.py, prep.proj, opac, colors,
                     extra_attrs, prep.ids, prep.valid, bg, light, aux_colors)


def rasterize(cfg: RasterizeConfig, means3d, opacities, scales, rotations,
              viewmatrix, projmatrix, campos, tanfovx, tanfovy, bg,
              shs=None, sh_degree: int = 0, colors_precomp=None,
              extra_attrs=None, means2d_offset=None,
              active=None, cov3d_precomp=None) -> RasterizeOutput:
    """Rasterize N Gaussians: means3d [N,3], opacities [N,1] (post-sigmoid),
    scales [N,3] (post-softplus), rotations [N,4], transposed view/proj
    [4,4], campos [3], bg [3]; colors from ``shs`` [N,Ksh,3] at
    ``sh_degree`` or ``colors_precomp`` [N,3]; ``cov3d_precomp`` [N,6] (see
    ``project_gaussians``) in place of the scales' and rotations'
    covariance, differentiable."""
    prep = prepare(cfg, means3d, scales, rotations, viewmatrix, projmatrix,
                   campos, tanfovx, tanfovy, means2d_offset, active,
                   cov3d_precomp=cov3d_precomp)
    colors = (colors_precomp if colors_precomp is not None
              else sh_colors(means3d, campos, shs, sh_degree))
    return composite_prepared(cfg, prep, opacities, colors, bg, extra_attrs)


def _assemble(cfg: RasterizeConfig, out, proj: Projected, bg, light: bool,
              n_chan: int, n_aux: int):
    """Images from the channel-major per-tile sums ``out`` [T, C+2+A, P]
    (C channels, alpha, T_final, A aux), shared by both backends."""
    H, W = cfg.image_height, cfg.image_width
    to_image = lambda a, b: _tiles_to_image_cm(cfg, out[:, a:b], b - a)
    image = to_image(0, 3) + to_image(n_chan + 1, n_chan + 2) * bg[:, None, None]
    if light:
        depth = image.new_zeros((1, H, W))
        normal = image.new_zeros((3, H, W))
        extra = image.new_zeros((1, H, W))
    else:
        depth, normal, extra = to_image(3, 4), to_image(4, 7), to_image(7, 8)
    radii = torch.where(proj.visible, proj.radius,
                        torch.zeros_like(proj.radius)).to(torch.int32)
    res = RasterizeOutput(image, depth, normal, to_image(n_chan, n_chan + 1),
                          radii, extra)
    if n_aux:
        return res, to_image(n_chan + 2, n_chan + 2 + n_aux)
    return res


def _composite_tiles(cfg: RasterizeConfig, px, py, proj: Projected, opac,
                     colors, extra_attrs, ids, valid, bg, light: bool = False,
                     aux_colors=None):
    """Plain tensor composite over [chunk, P, K] (the JAX package's XLA
    path): transmittance is the exclusive cumulative sum of log1p(-alpha)."""
    tile, T = cfg.tile, cfg.num_tiles
    dev = px.device
    if light:
        feats = torch.cat([px[:, None], py[:, None], proj.conic,
                           opac[:, None], colors], dim=-1)        # [N, 9]
    else:
        feats = torch.cat([px[:, None], py[:, None], proj.conic,
                           opac[:, None], colors, proj.depth[:, None],
                           proj.normal_cam, extra_attrs[:, None]], dim=-1)
    n_chan = 3 if light else 8
    n_aux = 0 if aux_colors is None else aux_colors.shape[-1]
    P = tile * tile
    oy, ox = torch.meshgrid(torch.arange(tile, device=dev),
                            torch.arange(tile, device=dev), indexing="ij")
    off_x = ox.reshape(-1).to(px.dtype)
    off_y = oy.reshape(-1).to(px.dtype)
    zero = torch.zeros((), device=dev)

    out = torch.empty((T, n_chan + 2 + n_aux, P), dtype=torch.float32,
                      device=dev)
    for t0 in range(0, T, _PLAIN_CHUNK):
        t1 = min(T, t0 + _PLAIN_CHUNK)
        tids = torch.arange(t0, t1, device=dev)
        gids = ids[t0:t1].long()
        f = feats[gids]                                          # [c, K, 14]
        gx, gy = f[..., 0], f[..., 1]
        A, B, C = f[..., 2], f[..., 3], f[..., 4]
        tx = (tids % cfg.tiles_x).to(px.dtype)
        ty = (tids // cfg.tiles_x).to(px.dtype)
        pxs = tx[:, None] * tile + off_x[None, :]                # [c, P]
        pys = ty[:, None] * tile + off_y[None, :]
        dx = pxs[:, :, None] - gx[:, None, :]                    # [c, P, K]
        dy = pys[:, :, None] - gy[:, None, :]
        power = (-0.5 * (A[:, None, :] * dx * dx + C[:, None, :] * dy * dy)
                 - B[:, None, :] * dx * dy)
        alpha = torch.clamp_max(f[..., 5][:, None, :] * torch.exp(power), 0.99)
        ok = (power <= 0.0) & (alpha >= 1.0 / 255.0) & valid[t0:t1, None, :]
        alpha = torch.where(ok, alpha, zero)
        log_t = torch.log1p(-alpha)
        cum = torch.cumsum(log_t, dim=-1)
        t_incl = torch.exp(cum)
        t_excl = torch.exp(cum - log_t)
        contrib = t_incl >= 1e-4                 # prefix mask == early exit
        w = torch.where(contrib, alpha * t_excl, zero)
        chan = f[..., 6:]                                        # [c, K, 3|8]
        acc = torch.einsum("cpk,ckd->cdp", w, chan)
        if n_aux:
            # aux (attention) channels see stop-gradient weights
            aux = aux_colors[gids].to(chan.dtype)                # [c, K, A]
            acc = torch.cat([acc, torch.einsum("cpk,cka->cap", w.detach(),
                                               aux)], dim=1)
        out[t0:t1, :n_chan] = acc[:, :n_chan]
        out[t0:t1, n_chan] = w.sum(-1)
        out[t0:t1, n_chan + 1] = torch.exp(
            torch.where(contrib, log_t, zero).sum(-1))
        out[t0:t1, n_chan + 2:] = acc[:, n_chan:]
    return _assemble(cfg, out, proj, bg, light, n_chan, n_aux)


class TileGather(torch.autograd.Function):
    """``where(valid, feats[:, ids], 0)``: per-tile rows [F, T, K] of the
    splat features [F, N] (counterpart of the JAX package's
    ``_tile_gather``). Its backward is the tile -> splat scatter-add of the
    valid slots, ``scatter_add_tiles``; ``valid`` must be a prefix of each
    tile's K slots, as the depth-sorted selection gives."""

    @staticmethod
    def forward(ctx, feats, ids, valid):
        cnt = valid.sum(-1, dtype=torch.int32)
        ids = ids.to(torch.int32).contiguous()
        ctx.save_for_backward(ids, cnt)
        ctx.n = feats.shape[1]
        return torch.where(valid[None], feats[:, ids.long()],
                           torch.zeros((), device=feats.device,
                                       dtype=feats.dtype)).contiguous()

    @staticmethod
    def backward(ctx, g):
        ids, cnt = ctx.saved_tensors
        with span("scatter.add"):
            acc = scatter_add_tiles(g.contiguous(), ids, cnt, ctx.n)
        return acc, None, None


def tile_features(px, py, proj: Projected, opac, colors, extra_attrs, ids,
                  valid, light: bool = False, aux_colors=None):
    """The kernel's inputs: per-tile feature rows [F, T, K] (invalid slots
    zeroed in every row) and valid counts cnt [T] int32."""
    rows = [px, py, proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
            opac] + [colors[:, i] for i in range(3)]
    if not light:
        rows += [proj.depth, proj.normal_cam[:, 0], proj.normal_cam[:, 1],
                 proj.normal_cam[:, 2], extra_attrs]
    if aux_colors is not None:
        rows += [aux_colors[:, i] for i in range(aux_colors.shape[-1])]
    feats = torch.stack(rows, dim=0).to(torch.float32)           # [F, N]
    return (TileGather.apply(feats, ids, valid),
            valid.sum(-1, dtype=torch.int32))


def _composite_tiles_kernel(cfg: RasterizeConfig, px, py, proj: Projected,
                            opac, colors, extra_attrs, ids, valid, bg,
                            light: bool = False, aux_colors=None):
    """Kernel composite: ``tile_features`` then ``CompositeFunction``."""
    n_chan = 3 if light else 8
    n_aux = 0 if aux_colors is None else aux_colors.shape[-1]
    ftiles, cnt = tile_features(px, py, proj, opac, colors, extra_attrs, ids,
                                valid, light, aux_colors)
    out = CompositeFunction.apply(ftiles, cnt, cfg.tiles_x, n_chan, n_aux,
                                   cfg.tile)
    return _assemble(cfg, out, proj, bg, light, n_chan, n_aux)


def _tiles_to_image_cm(cfg: RasterizeConfig, flat, ch: int):
    """Channel-major [T, ch, P] tile pixels -> [ch, H, W] (crop padding)."""
    tile = cfg.tile
    img = flat.reshape(cfg.tiles_y, cfg.tiles_x, ch, tile, tile)
    img = img.permute(2, 0, 3, 1, 4).reshape(ch, cfg.tiles_y * tile,
                                             cfg.tiles_x * tile)
    return img[:, :cfg.image_height, :cfg.image_width]


@spanned("render.sh")
def sh_colors(means3d, campos, shs, sh_degree: int):
    """SH -> clamped RGB at per-splat view directions."""
    dirs = means3d - campos[None, :]
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, -1, keepdim=True) + 1e-16)
    return torch.clamp_min(
        eval_sh(sh_degree, shs.transpose(-1, -2), dirs) + 0.5, 0.0)
