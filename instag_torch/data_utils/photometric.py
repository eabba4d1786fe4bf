"""Photometric 3DMM fitting (counterpart of
instag_tpu/data_utils/photometric.py; reference face_tracker.py:159-350).

Given per-frame 68-point landmarks, frames and a PnP pose, fits a
``face_model.MorphableModel``'s id, expression, texture, SH lighting and
per-frame pose by the reference's staged schedule, with Adam (optax's
defaults: betas 0.9 / 0.999, eps 1e-8) in eager loops on the device:

  A. pose-only landmark fit                                    (:159-178)
  B. joint id + exp + pose landmark fit, L2 regs 0.5 / 0.4     (:181-203)
  C. texture + SH light photometric fit on a spread batch      (:210-280)
  D. per-batch fine fit of exp / pose / light with colour and landmark
     losses and the rigid vertices' temporal smoothness        (:290-350)

Camera model: COLMAP pixels (x right, y down, z forward), ``px = f x / z +
cx``: the raw PnP frame, before the tracker's OpenGL flip.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from .face_model import (MorphableModel, geometry, landmarks3d, sh_shading,
                         texture, to_device, vertex_normals)
from .mesh_render import MeshRenderConfig, render_mesh


def euler2rot(euler: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3]: R = Rx(theta) Ry(phi) Rz(psi), the
    reference's euler2rot (inverted by tracker.rot2euler)."""
    th, ph, ps = euler[..., 0], euler[..., 1], euler[..., 2]
    c, s = torch.cos, torch.sin
    one, zero = torch.ones_like(th), torch.zeros_like(th)
    rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, c(th), s(th)], -1),
                      torch.stack([zero, -s(th), c(th)], -1)], -2)
    ry = torch.stack([torch.stack([c(ph), zero, -s(ph)], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([s(ph), zero, c(ph)], -1)], -2)
    rz = torch.stack([torch.stack([c(ps), -s(ps), zero], -1),
                      torch.stack([s(ps), c(ps), zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    return rx @ ry @ rz


def transform_points(points: torch.Tensor, euler: torch.Tensor,
                     trans: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] model points -> camera space (R p + t)."""
    R = euler2rot(euler)
    return torch.einsum("...ij,...nj->...ni", R, points) + trans[..., None, :]


def project(points_cam: torch.Tensor, focal, cx, cy,
            z_near: float = 1e-3) -> torch.Tensor:
    z = torch.clamp_min(points_cam[..., 2], z_near)
    return torch.stack([focal * points_cam[..., 0] / z + cx,
                        focal * points_cam[..., 1] / z + cy], -1)


def _lan_loss(proj: torch.Tensor, lms: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum((proj - lms) ** 2, -1))


def _run_adam(loss_fn, params: dict, lr: float, iters: int,
              decay_every: int = 0, decay: float = 0.2):
    """``iters`` Adam steps on copies of ``params``; with ``decay_every``
    the rate falls by ``decay`` every that many steps, counted from step 0
    (optax's staircase ``exponential_decay``), else it stays constant.
    Returns the parameters and each step's loss before its update."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(list(p.values()), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = []
    for i in range(iters):
        if decay_every:
            opt.param_groups[0]["lr"] = lr * decay ** (i // decay_every)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(p)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    out = {k: v.detach() for k, v in p.items()}
    return out, (torch.stack(losses) if losses else torch.zeros(0))


def fit_photometric(model: MorphableModel, lms: np.ndarray,
                    images: np.ndarray, focal: float, cx: float, cy: float,
                    euler_init: np.ndarray, trans_init: np.ndarray,
                    iters=(400, 600, 60, 40), batch_size: int = 32,
                    render_cfg: MeshRenderConfig | None = None,
                    device: str | torch.device = "cuda") -> dict:
    """Run stages A-D on ``device``: ``lms`` [T, 68, 2], ``images`` [T, H,
    W, 3] float in [0, 1], the intrinsics and the initial pose (Euler
    angles and translations [T, 3]).

    Returns numpy id [n_id], exp [T, n_exp], tex [n_tex], euler [T, 3],
    trans [T, 3], light [T, 27], the final mean landmark error in pixels
    (``lan_err_px``), each of stages A-C's last loss (``stage_losses``)
    and each stage's wall in seconds (``stage_seconds``, host clock after
    the device finished)."""
    dev = resolve_device(device)
    walls, clock = {}, [time.perf_counter()]

    def lap(stage):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        walls[stage] = now - clock[0]
        clock[0] = now
    T, H, W = lms.shape[0], images.shape[1], images.shape[2]
    cfg = render_cfg or MeshRenderConfig(H, W)
    m = to_device(model, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    lms_t = torch.as_tensor(lms, **f32)
    n_id, n_exp, n_tex = model.n_id, model.n_exp, model.n_tex

    def lan_proj(id_p, exp_p, euler, trans):
        l3 = landmarks3d(m, id_p[None].expand(exp_p.shape[0], -1), exp_p)
        return project(transform_points(l3, euler, trans), focal, cx, cy)

    # ---- stage A: pose only ----
    zeros_id, zeros_exp = torch.zeros(n_id, **f32), torch.zeros(T, n_exp,
                                                                 **f32)

    def loss_a(p):
        return _lan_loss(lan_proj(zeros_id, zeros_exp, p["euler"],
                                  p["trans"]), lms_t)

    pa = {"euler": torch.as_tensor(euler_init, **f32),
          "trans": torch.as_tensor(trans_init, **f32)}
    pa, la = _run_adam(loss_a, pa, 1e-2, iters[0],
                       decay_every=iters[0] * 2 // 3)
    lap("a")

    # ---- stage B: id + exp + pose, L2 regs (0.5 / 0.4) ----
    def loss_b(p):
        return (_lan_loss(lan_proj(p["id"], p["exp"], p["euler"],
                                   p["trans"]), lms_t)
                + 0.5 * torch.mean(p["id"] ** 2)
                + 0.4 * torch.mean(p["exp"] ** 2))

    pb = {**pa, "id": zeros_id, "exp": zeros_exp}
    pb, lb = _run_adam(loss_b, pb, 5e-3, iters[1], decay_every=iters[1] // 2)
    lap("b")

    # ---- stage C: texture + SH light on a spread batch ----
    bs = min(batch_size, T)
    sel = torch.as_tensor(np.arange(0, T, max(1, T // bs))[:bs], device=dev)
    sel_imgs = torch.as_tensor(images, **f32)[sel]
    sel_lms = lms_t[sel]

    def render_batch(id_p, exp_p, euler, trans, tex_p, light):
        geo = geometry(m, id_p, exp_p)                      # [b, V, 3]
        vc = transform_points(geo, euler, trans)
        shade = torch.clamp_min(sh_shading(vertex_normals(vc, m.tris),
                                           light), 0.0)
        cols = torch.clamp(texture(m, tex_p) * shade, 0.0, 1.0)
        return render_mesh(cfg, vc, m.tris, cols, focal, cx, cy)

    def color_loss(rgba, target):
        mask = rgba[..., 3:].detach()
        return (torch.sum(((rgba[..., :3] - target) * mask) ** 2)
                / torch.clamp_min(torch.sum(mask), 1.0))

    def loss_c(p):
        exp_s = p["exp"][sel]
        proj = lan_proj(p["id"], exp_s, p["euler"][sel], p["trans"][sel])
        rgba = render_batch(p["id"], exp_s, p["euler"][sel],
                            p["trans"][sel], p["tex"], p["light"])
        return (color_loss(rgba, sel_imgs) + 0.05 * _lan_loss(proj, sel_lms)
                + 1.0 * torch.mean(p["id"] ** 2)
                + 0.8 * torch.mean(exp_s ** 2))

    light0 = torch.zeros(27, **f32)
    light0[:3] = 1.0
    pc = {**pb, "tex": torch.zeros(n_tex, **f32),
          "light": light0[None].repeat(bs, 1)}
    pc, lc = _run_adam(loss_c, pc, 2e-2, iters[2], decay_every=iters[2] // 2)
    lap("c")

    # ---- stage D: per-batch fine fit (exp / pose / light; id, tex fixed)
    id_f, tex_f = pc["id"], pc["tex"]
    exp_all, euler_all, trans_all = pc["exp"], pc["euler"], pc["trans"]
    light_all = pc["light"].mean(0)[None].repeat(T, 1)
    imgs = torch.as_tensor(images, **f32)
    rigid = m.rigid_idx

    def make_loss_d(idx):
        n = len(idx)

        def loss_d(p):
            proj = lan_proj(id_f, p["exp"], p["euler"], p["trans"])
            rgba = render_batch(id_f, p["exp"], p["euler"], p["trans"],
                                tex_f, p["light"])
            # temporal smoothness of the rigid vertices (the reference's
            # laplacian over the batch, :315-340)
            geo = geometry(m, id_f[None].expand(n, -1), p["exp"])
            gr = transform_points(geo[:, rigid], p["euler"], p["trans"])
            lap = gr[:-2] - 2 * gr[1:-1] + gr[2:]
            l_lap = (torch.mean(torch.sum(lap ** 2, -1)) if n > 2
                     else torch.zeros((), **f32))
            return (color_loss(rgba, imgs[idx])
                    + 0.05 * _lan_loss(proj, lms_t[idx])
                    + 0.3 * torch.mean(p["exp"] ** 2) + 10.0 * l_lap)
        return loss_d

    for start in range(0, T, bs):
        idx = np.arange(start, min(start + bs, T))
        if len(idx) < bs and T >= bs:
            idx = np.arange(T - bs, T)          # the last batch overlaps
        idx = torch.as_tensor(idx, device=dev)
        pd = {"exp": exp_all[idx], "euler": euler_all[idx],
              "trans": trans_all[idx], "light": light_all[idx]}
        pd, _ = _run_adam(make_loss_d(idx), pd, 2e-3, iters[3])
        exp_all[idx], euler_all[idx] = pd["exp"], pd["euler"]
        trans_all[idx], light_all[idx] = pd["trans"], pd["light"]
    lap("d")

    with torch.no_grad():
        proj = lan_proj(id_f, exp_all, euler_all, trans_all)
        err = float(torch.mean(torch.linalg.norm(proj - lms_t, dim=-1)))

    def host(t):
        return t.cpu().numpy()
    return dict(id=host(id_f), exp=host(exp_all), tex=host(tex_f),
                euler=host(euler_all), trans=host(trans_all),
                light=host(light_all), lan_err_px=err,
                stage_losses=dict(a=float(la[-1]), b=float(lb[-1]),
                                  c=float(lc[-1])), stage_seconds=walls)
