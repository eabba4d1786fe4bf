"""The plain reference of the face adaptation step, in PyTorch alone (a
frozen copy of the method as the program runs it at the start of an
adaptation): the cloud of ``init_num`` random points with its 3-NN scales,
the face branch rendered through the plain reference (``reference.py``)
under autograd, the L1 + 0.2 D-SSIM loss against the ground truth painted
green off the head and on the mouth, and the updates: the Gaussians' Adam
at their per-attribute rates (xyz on its exponential schedule, scaled by
the scene extent), the UMF's AdamW with its parameter groups and LambdaLR,
the PMF's Adam. It follows the first steps from iteration 1, where the
align, regulariser, prior, hair and LPIPS phases are all off, so their
terms (multiplied by 0 in the program) add nothing.

It imports nothing of the program. ``tf32=True`` is the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference as R

C0 = 0.28209479177387814
GREEN = (0.0, 1.0, 0.0)


def init_cloud(num: int, seed: int, max_sh: int, dev) -> dict:
    """The adaptation's starting cloud from the seed: points uniform in
    [-0.1, 0.1]³ with near-black SH colours, log scales of the root mean
    squared distance to the 3 nearest neighbours, identity rotations,
    opacity 0.1, SH degree 0 active."""
    rng = np.random.default_rng(seed)
    xyz = (rng.random((num, 3)) * 0.2 - 0.1).astype(np.float32)
    shs = rng.random((num, 3)).astype(np.float32) / 255.0
    colors = torch.from_numpy(shs * C0 + 0.5).to(dev)
    pts = torch.from_numpy(xyz).to(dev)
    sq = (pts * pts).sum(-1)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * (pts @ pts.T), 0.0)
    d2 = d2 + torch.diag(torch.full((num,), float("inf"), device=dev))
    dist2 = torch.clamp_min(torch.topk(d2, 3, dim=-1, largest=False)
                            .values.mean(-1), 1e-7)
    rot = torch.zeros((num, 4), device=dev)
    rot[:, 0] = 1.0
    rest = (max_sh + 1) ** 2 - 1
    op = torch.full((num, 1), 0.1, device=dev)
    return dict(
        xyz=pts, features_dc=((colors - 0.5) / C0)[:, None, :],
        features_rest=torch.zeros((num, rest, 3), device=dev),
        identity=torch.zeros((num, 1), device=dev),
        scaling=torch.log(torch.sqrt(dist2))[:, None].expand(num, 3)
        .contiguous(),
        rotation=rot, opacity=torch.log(op / (1 - op)),
        alive=torch.ones(num, dtype=torch.bool, device=dev))


FIELDS = ("xyz", "features_dc", "features_rest", "identity", "scaling",
          "rotation", "opacity")


def scene_extent(centers: np.ndarray) -> float:
    """1.1 times the largest distance of a camera centre from their mean."""
    c = np.asarray(centers, np.float64)
    return float(np.linalg.norm(c - c.mean(0), axis=1).max() * 1.1)


def first_frames(seed: int, n_frames: int, n_patch: int, steps: int):
    """The frames the curriculum draws for iterations 1 .. ``steps`` (< 10,
    where no window test applies): pops from a shuffled stack, with one
    LPIPS patch draw after each."""
    rng = np.random.default_rng(seed)
    stack, out = list(range(n_frames)), []
    for _ in range(steps):
        out.append(stack.pop(int(rng.integers(len(stack)))))
        rng.integers(n_patch)
    return out


def _blur_matrix(n: int, dev, window: int = 11, sigma: float = 1.5):
    xs = torch.arange(window, dtype=torch.float32, device=dev) - window // 2
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    idx = torch.arange(n, device=dev)
    off = idx[None, :] - idx[:, None]
    taps = g[torch.clamp(off + window // 2, 0, window - 1)]
    return torch.where(off.abs() <= window // 2, taps, torch.zeros_like(taps))


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of [C, H, W] images (11x11 Gaussian window, sigma 1.5,
    zero padding; variances clamped at 0, covariance to +-sqrt(v1 v2))."""
    c, h, w = a.shape
    bw, bh = _blur_matrix(w, a.device), _blur_matrix(h, a.device)

    def blur(x):
        return torch.einsum("ij,cjw->ciw", bh,
                            (x.reshape(c * h, w) @ bw).reshape(c, h, w))
    m1, m2 = blur(a), blur(b)
    zero = torch.zeros((), device=a.device)
    v1 = torch.maximum(blur(a * a) - m1 * m1, zero)
    v2 = torch.maximum(blur(b * b) - m2 * m2, zero)
    bound = torch.sqrt(v1 * v2 + 1e-12)
    cov = torch.minimum(torch.maximum(blur(a * b) - m1 * m2, -bound), bound)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean(((2 * m1 * m2 + c1) * (2 * cov + c2))
                      / ((m1 * m1 + m2 * m2 + c1) * (v1 + v2 + c2)))


def frame_loss(cloud: dict, umf: dict, frame: dict, size: int, k: int,
               max_sh: int, lambda_dssim: float = 0.2) -> torch.Tensor:
    """The step's loss on one frame (iteration <= 1000: the PMF's align
    weight is 0, so the UMF reads the unaligned positions)."""
    cam = frame["cam"]
    m = R.face_umf(umf, cloud["xyz"], frame["aud"], frame["exp"])
    means = cloud["xyz"] + m["d_xyz"]
    scales = torch.nn.functional.softplus(cloud["scaling"] + m["d_scale"])
    rots = R._safe_normalize(cloud["rotation"] + m["d_rot"])
    px, py, depth, conic, radius, vis = R.project(size, means, scales, rots,
                                                  cam, cloud["alive"])
    ids, valid = R.select(size, k, px, py, depth, radius, vis)
    feats = torch.cat([cloud["features_dc"], cloud["features_rest"] * 0.0], 1)
    colors = R.sh_colors(means, cam["center"], feats, max_sh)
    green = torch.tensor(GREEN, device=means.device)
    img, _, counts = R.composite(size, px, py, conic,
                                 torch.sigmoid(cloud["opacity"])[:, 0],
                                 colors, ids, valid, green)
    g = green[:, None, None]
    gt = frame["image"].float().permute(2, 0, 1) / 255.0
    gt = torch.where((frame["face"] | frame["hair"])[None], gt, g)
    gt = torch.where(frame["mouth"][None], g, gt)
    loss = torch.mean(torch.abs(img - gt)) + lambda_dssim * (1.0 - ssim(img, gt))
    return loss, counts


def _label(name: str) -> str:
    if "audio_att_net" in name:
        return "audio_att"
    if "encoder" in name and "exp_encode" not in name:
        return "encoder"
    if "align_net" in name:
        return "align"
    return "net"


def _net_opt(params: dict, cls, rates: dict, **kw):
    groups = {}
    for n, p in params.items():
        groups.setdefault(_label(n), []).append(p)
    return cls([dict(params=groups[lab], lr=lr, weight_decay=wd)
                for lab, (lr, wd) in rates.items() if lab in groups], **kw)


def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int):
    t = min(max(step / max_steps, 0.0), 1.0)
    return float(np.float32(math.exp(math.log(lr_init) * (1 - t)
                                     + math.log(lr_final) * t)))


def face_steps(cloud: dict, umf: dict, pmf: dict, frames: list, size: int,
               k: int, max_sh: int, extent: float, opt: dict,
               tf32: bool = False) -> dict:
    """Follow ``len(frames)`` steps from iteration 1. Returns each step's
    loss, each leaf's gradient norm as the optimizers hold it after the
    first step (first moment / (1 - beta1)), each leaf's change after the
    last, and the composite's counts of the first step."""
    dev = cloud["xyz"].device
    leaves = {n: cloud[n].clone().requires_grad_(True) for n in FIELDS}
    u = {n: t.clone().requires_grad_(True) for n, t in umf.items()}
    p = {n: t.clone().requires_grad_(True) for n, t in pmf.items()}
    start = {**{f"gaussians.{n}": v.detach().clone() for n, v in leaves.items()},
             **{f"umf.{n}": v.detach().clone() for n, v in u.items()},
             **{f"pmf.{n}": v.detach().clone() for n, v in p.items()}}
    umf_opt = _net_opt(u, torch.optim.AdamW, {
        "net": (5e-4, 0.0), "encoder": (5e-3, 0.01),
        "audio_att": (2.5e-3, 1e-4), "align": (2.5e-4, 0.0)},
        betas=(0.9, 0.99), eps=1e-8)
    warm = opt["warm_step"]
    sched = torch.optim.lr_scheduler.LambdaLR(
        umf_opt, lambda s: 0.1 if s < warm else 0.5 ** (s / opt["iterations"]))
    pmf_opt = _net_opt(p, torch.optim.Adam, {
        "net": (1e-4, 0.0), "encoder": (1e-3, 0.0),
        "audio_att": (5e-4, 1e-4), "align": (5e-5, 0.0)},
        betas=(0.9, 0.999), eps=1e-15)
    mu = {n: torch.zeros_like(v) for n, v in leaves.items()}
    nu = {n: torch.zeros_like(v) for n, v in leaves.items()}
    lr = dict(features_dc=opt["feature_lr"],
              features_rest=opt["feature_lr"] / 20.0,
              identity=opt["identity_lr"], opacity=opt["opacity_lr"],
              scaling=opt["scaling_lr"], rotation=opt["rotation_lr"])
    losses, grads, counts = [], {}, None
    with R.precision(tf32):
        for step, fr in enumerate(frames, start=1):
            cl = dict(leaves, alive=cloud["alive"])
            loss, c = frame_loss(cl, u, fr, size, k, max_sh)
            for t in [*leaves.values(), *u.values(), *p.values()]:
                t.grad = None
            loss.backward()
            losses.append(float(loss.detach()))
            counts = counts or c
            for t in [*u.values(), *p.values(), *leaves.values()]:
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
            lr["xyz"] = expon_lr(step, opt["position_lr_init"] * extent,
                                 opt["position_lr_final"] * extent,
                                 opt["position_lr_max_steps"])
            tt = np.float32(step)
            c1 = float(np.float32(1.0) - np.float32(0.9) ** tt)
            c2 = float(np.float32(1.0) - np.float32(0.999) ** tt)
            with torch.no_grad():
                for n, v in leaves.items():
                    mu[n] = 0.9 * mu[n] + (1 - 0.9) * v.grad
                    nu[n] = 0.999 * nu[n] + (1 - 0.999) * v.grad * v.grad
                    v -= lr[n] * (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + 1e-15)
            umf_opt.step()
            sched.step()
            pmf_opt.step()
            if step == 1:
                grads = {f"gaussians.{n}": float(mu[n].norm() / 0.1)
                         for n in leaves}
                for tag, o, d in (("umf", umf_opt, u), ("pmf", pmf_opt, p)):
                    for n, v in d.items():
                        grads[f"{tag}.{n}"] = float(
                            o.state[v]["exp_avg"].norm() / 0.1)
    now = {**{f"gaussians.{n}": v for n, v in leaves.items()},
           **{f"umf.{n}": v for n, v in u.items()},
           **{f"pmf.{n}": v for n, v in p.items()}}
    changes = {n: float((now[n].detach() - start[n]).norm()) for n in now}
    return dict(losses=losses, grads=grads, changes=changes, counts=counts)


def gaps(got: dict, ref: dict, floor: float = 1e-3) -> dict:
    """The compared numbers: the largest relative gap of a step's loss,
    and over the leaves the largest gap between the program's and the
    reference's norm of the first gradient and of the change after the
    steps, each against the larger of the reference's norm of that leaf
    and of the median leaf. Leaves whose reference gradient is under
    ``floor`` of the median leaf's move by round-off alone, and are left
    out of both."""
    out = dict(loss_gap=max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], ref["losses"])))
    med = float(np.median(list(ref["grads"].values())))
    keep = [n for n, g in ref["grads"].items() if g >= floor * med]
    for key in ("grads", "changes"):
        scale = float(np.median([ref[key][n] for n in keep]))
        out[key[:-1] + "_gap"] = max(
            abs(got[key][n] - ref[key][n]) / max(ref[key][n], scale)
            for n in keep)
    out["leaves"] = len(keep)
    return out
