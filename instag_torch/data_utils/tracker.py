"""Head-pose tracking from landmarks (task 8; counterpart of
instag_tpu/data_utils/tracker.py, its PnP path).

  1. a focal-length grid search (600-1400 px) by the mean landmark
     reprojection error of a frame subset;
  2. a pose per frame at the chosen focal, falling back to the previous
     frame's where a solve is not finite;
  3. the OpenGL flip, a moving average of the translations and
     ``track_params.npz``.

The PnP is the port's own, in place of OpenCV's EPnP +
``solvePnPRefineLM``: from two starts, a DLT over the 18 rigid points
projected to a rotation and the frontal pose, a fixed count of
Levenberg-Marquardt iterations on the reprojection error with every point
kept in front of the camera, in float64 on ``device``; every frame at every
focal candidate in one batch, with no host read inside the loop.

A 3D morphable model (``model_path``, ``INSTAG_3DMM`` or
``<base>/3DMM/3dmm_model.npz``) would start the JAX package's photometric
fit; that fit is not ported yet (ROADMAP.md "Still to port", item 2), and
the tracker refuses to run without it rather than skip it.

Output: track_params.npz with {euler [N,3], trans [N,3] (stored x10 like
the reference), focal [1], id [100], exp [N,79], light [N,27]}; the PnP
path leaves id, exp and light at zero.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..data.image_io import jpeg_size
from ..device import resolve_device

LM_ITERS = 40      # Levenberg-Marquardt iterations of a solve


def canonical_landmarks_3d() -> np.ndarray:
    """Approximate canonical 68-point 3-D face template, head ~0.25 units
    wide, centered at the origin, +y up, +z toward the camera."""
    P = np.zeros((68, 3), np.float32)
    # jaw (0-16): ellipse from left to right, receding in z toward the ears
    t = np.linspace(-np.pi / 2, np.pi / 2, 17)
    P[0:17, 0] = 1.10 * np.sin(t)
    P[0:17, 1] = -0.9 * np.cos(t) - 0.15
    P[0:17, 2] = -0.45 * np.abs(np.sin(t))
    # brows (17-26)
    bx = np.linspace(-0.75, -0.15, 5)
    P[17:22, 0] = bx
    P[17:22, 1] = 0.55
    P[17:22, 2] = 0.10 - 0.1 * np.abs(bx + 0.45)
    P[22:27, 0] = -bx[::-1]
    P[22:27, 1] = 0.55
    P[22:27, 2] = P[17:22, 2][::-1]
    # nose ridge (27-30) + base (31-35)
    P[27:31, 0] = 0.0
    P[27:31, 1] = np.linspace(0.42, -0.05, 4)
    P[27:31, 2] = np.linspace(0.18, 0.45, 4)
    P[31:36, 0] = np.linspace(-0.22, 0.22, 5)
    P[31:36, 1] = -0.18
    P[31:36, 2] = 0.30 - 0.25 * np.abs(np.linspace(-1, 1, 5))
    # eyes (36-41 left, 42-47 right)
    for k, ex in enumerate([-0.45, 0.45]):
        a = np.linspace(0, 2 * np.pi, 6, endpoint=False)
        P[36 + 6 * k: 42 + 6 * k, 0] = ex + 0.16 * np.cos(a)
        P[36 + 6 * k: 42 + 6 * k, 1] = 0.30 + 0.08 * np.sin(a)
        P[36 + 6 * k: 42 + 6 * k, 2] = 0.05
    # outer lips (48-59), inner lips (60-67)
    a = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    P[48:60, 0] = 0.32 * np.cos(a)
    P[48:60, 1] = -0.55 + 0.14 * np.sin(a)
    P[48:60, 2] = 0.22
    a = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    P[60:68, 0] = 0.20 * np.cos(a)
    P[60:68, 1] = -0.55 + 0.07 * np.sin(a)
    P[60:68, 2] = 0.24
    return P * 0.12  # head ~0.26 units wide


# pose-stable subset: brows excluded, mouth excluded (they deform)
_RIGID = np.array([0, 2, 4, 8, 12, 14, 16, 27, 28, 29, 30, 31, 33, 35,
                   36, 39, 42, 45])


def rot2euler(R: np.ndarray) -> np.ndarray:
    """Inverse of process.euler2rot (R = Rx(theta) Ry(phi) Rz(psi));
    batched."""
    phi = np.arcsin(-R[:, 0, 2])
    psi = np.arctan2(-R[:, 0, 1], R[:, 0, 0])
    theta = np.arctan2(R[:, 1, 2], R[:, 2, 2])
    return np.stack([theta, phi, psi], -1)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> the cross-product matrices [..., 3, 3]."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, [..., 3] -> [..., 3, 3], with the series near 0."""
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    safe = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th2 / 6, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(safe)) / safe ** 2)
    K = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def _project(R, t, X, f, c):
    """Camera points [B, P, 3] and pixels [B, P, 2] of the object points
    X [P, 3] under poses R [B, 3, 3], t [B, 3] and focals f [B]."""
    cam = X @ R.transpose(-1, -2) + t[:, None, :]
    return cam, f[:, None, None] * cam[..., :2] / cam[..., 2:] + c


def _dlt_start(X: torch.Tensor, uv: torch.Tensor, f: torch.Tensor,
               c: torch.Tensor):
    """The DLT pose: the 3x4 [R|t] (up to scale) that maps the centred and
    scaled object points to the normalized image points by least squares,
    its left block projected to the nearest rotation."""
    mu = X.mean(0)
    s = (X - mu).norm(dim=-1).mean() / np.sqrt(3.0)
    Xn = (X - mu) / s
    xy = (uv - c) / f[:, None, None]                       # [B, P, 2]
    B, P = xy.shape[:2]
    Xh = torch.cat([Xn, torch.ones_like(Xn[:, :1])], -1).expand(B, P, 4)
    zero = torch.zeros_like(Xh)
    A = torch.cat([
        torch.cat([Xh, zero, -xy[..., :1] * Xh], -1),
        torch.cat([zero, Xh, -xy[..., 1:] * Xh], -1)], 1)  # [B, 2P, 12]
    M = torch.linalg.svd(A, full_matrices=False).Vh[..., -1, :]
    M = M.reshape(B, 3, 4)
    # the sign and scale that make the left block's determinant 1
    det = torch.linalg.det(M[..., :3])
    M = M / (torch.sign(det) * det.abs().pow(1.0 / 3.0))[:, None, None]
    U, _, Vh = torch.linalg.svd(M[..., :3])
    d = torch.linalg.det(U @ Vh)
    R = torch.cat([U[..., :2], U[..., 2:] * d[:, None, None]], -1) @ Vh
    # R (X - mu) / s + t' is the camera point over s: t = s t' - R mu
    return R, M[..., 3] * s - R @ mu


def _frontal_start(X: torch.Tensor, uv: torch.Tensor, f: torch.Tensor,
                   c: torch.Tensor):
    """The head facing the camera (world +y up and +z toward the camera:
    R = diag(1, -1, -1)), at the depth where the object's spread matches
    the landmarks' and centred on them."""
    R = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=X.dtype,
                                device=X.device)).expand(len(f), 3, 3)
    mu, m = X.mean(0), uv.mean(1)                        # [3], [B, 2]
    spread_obj = (X[:, :2] - mu[:2]).norm(dim=-1).mean()
    spread_img = (uv - m[:, None]).norm(dim=-1).mean(-1)
    z = f * spread_obj / spread_img
    centre = torch.cat([(m - c) * (z / f)[:, None], z[:, None]], -1)
    return R, centre - R @ mu


def solve_pnp(obj: np.ndarray, uv: np.ndarray, focal: np.ndarray,
              cx: float, cy: float, device: str | torch.device = "cuda"):
    """Poses minimizing the landmarks' squared reprojection error with
    every point in front of the camera, one per row: object points [P, 3],
    image points [B, P, 2] (x, y) and focals [B] in pixels, principal
    point (cx, cy). Each row is solved from two starts, the DLT pose and
    the frontal pose, and keeps the better. Returns numpy float64 (R [B,
    3, 3] world-to-camera in the COLMAP convention, t [B, 3], the mean
    reprojection error [B] in pixels), NaN where no solve is finite."""
    dev = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    X = torch.as_tensor(np.asarray(obj, np.float64), **f64)
    u = torch.as_tensor(np.asarray(uv, np.float64), **f64)
    f = torch.as_tensor(np.asarray(focal, np.float64), **f64)
    c = torch.tensor([cx, cy], **f64)
    starts = [_dlt_start(X, u, f, c), _frontal_start(X, u, f, c)]
    B = len(f)
    R = torch.cat([s[0] for s in starts])
    t = torch.cat([s[1] for s in starts])
    u, f = u.repeat(2, 1, 1), f.repeat(2)

    def cost(R, t):
        cam, pix = _project(R, t, X, f, c)
        r = pix - u
        e = (r * r).sum((-1, -2))
        # a point behind the camera projects too, through the mirror
        return r, torch.where((cam[..., 2] > 0).all(-1), e,
                              torch.full_like(e, float("inf")))

    lam = torch.full_like(f, 1e-3)
    r, e = cost(R, t)
    for _ in range(LM_ITERS):
        cam = X @ R.transpose(-1, -2)                           # R X
        p = cam + t[:, None, :]
        iz = 1.0 / p[..., 2]
        # d(u, v)/dp: [[f/z, 0, -f x/z^2], [0, f/z, -f y/z^2]]
        dp = torch.zeros(p.shape[:2] + (2, 3), **f64)
        dp[..., 0, 0] = f[:, None] * iz
        dp[..., 1, 1] = f[:, None] * iz
        dp[..., :, 2] = -f[:, None, None] * p[..., :2] * iz[..., None] ** 2
        # dp/d(w, t) for R <- exp(w^) R: [-(R X)^ | I]
        dpdx = torch.cat([-_skew(cam), torch.eye(3, **f64).expand(
            cam.shape + (3,))], -1)                             # [B,P,3,6]
        J = (dp @ dpdx).reshape(len(f), -1, 6)
        H = J.transpose(-1, -2) @ J
        g = J.transpose(-1, -2) @ r.reshape(len(f), -1, 1)
        Hd = H + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(H, dim1=-2, dim2=-1))
        step = -torch.linalg.solve_ex(Hd, g)[0][..., 0]   # no error sync
        R_new = _exp_so3(step[:, :3]) @ R
        t_new = t + step[:, 3:]
        r_new, e_new = cost(R_new, t_new)
        ok = torch.isfinite(e_new) & (e_new < e)
        R = torch.where(ok[:, None, None], R_new, R)
        t = torch.where(ok[:, None], t_new, t)
        r = torch.where(ok[:, None, None], r_new, r)
        e = torch.where(ok, e_new, e)
        lam = torch.where(ok, lam * 0.1, lam * 10.0).clamp(1e-15, 1e15)
    pick = (e[B:] < e[:B]).long() * B + torch.arange(B, device=dev)
    R, t, e = R[pick], t[pick], e[pick]
    err = r[pick].norm(dim=-1).mean(-1)
    bad = ~(torch.isfinite(R).flatten(1).all(1) & torch.isfinite(t).all(1)
            & torch.isfinite(e))
    nan = torch.tensor(float("nan"), **f64)
    R = torch.where(bad[:, None, None], nan, R)
    t = torch.where(bad[:, None], nan, t)
    err = torch.where(bad, nan, err)
    return R.cpu().numpy(), t.cpu().numpy(), err.cpu().numpy()


def _find_model(base_dir: str, model_path: str | None) -> str | None:
    for cand in (model_path, os.environ.get("INSTAG_3DMM"),
                 os.path.join(base_dir, "3DMM", "3dmm_model.npz")):
        if cand and os.path.exists(cand):
            return cand
    return None


def track_poses(base_dir: str, ori_imgs_dir: str,
                focal_candidates=range(600, 1500, 100),
                smooth: int = 5, model_path: str | None = None,
                device: str | torch.device = "cuda") -> None:
    """Write ``<base_dir>/track_params.npz`` from the ``.lms`` landmark
    files under ``ori_imgs_dir`` (the frames' size from the first's JPEG),
    the PnP solved on ``device``."""
    mpath = _find_model(base_dir, model_path)
    if mpath is not None:
        raise NotImplementedError(
            f"a 3D morphable model was found at {mpath}, but the "
            "photometric 3DMM fit is not ported yet (ROADMAP.md 'Still to "
            "port', item 2: face_model, mesh_render, photometric); move the "
            "model away to track the pose from landmarks alone")
    lms_paths = sorted(glob.glob(os.path.join(ori_imgs_dir, "*.lms")),
                       key=lambda p: int(os.path.basename(p).split(".")[0]))
    if not lms_paths:
        raise FileNotFoundError(f"no .lms landmark files under "
                                f"{ori_imgs_dir}")
    lms = np.stack([np.loadtxt(p) for p in lms_paths])   # [N, 68, 2] (x, y)
    with open(lms_paths[0].replace(".lms", ".jpg"), "rb") as fh:
        h, w = jpeg_size(fh.read())
    cx, cy = w / 2.0, h / 2.0
    rigid_obj = canonical_landmarks_3d()[_RIGID]
    n, focals = len(lms), np.asarray(list(focal_candidates), np.float64)

    # every frame at every focal candidate, in one batch
    R, t, err = solve_pnp(rigid_obj, np.tile(lms[:, _RIGID], (len(focals),
                                                               1, 1)),
                          np.repeat(focals, n), cx, cy, device=device)
    R = R.reshape(len(focals), n, 3, 3)
    t = t.reshape(len(focals), n, 3)
    err = err.reshape(len(focals), n)

    # stage 1: the focal of the least mean error over a frame subset
    sub = err[:, ::max(1, n // 20)]
    best, best_err = None, np.inf
    for k in range(len(focals)):
        e = sub[k][np.isfinite(sub[k])]
        e = e.mean() if len(e) else np.inf
        if e < best_err:
            best, best_err = k, e
    if best is None:
        raise RuntimeError("no focal candidate gave a finite pose")
    best_focal = int(focals[best])
    print(f"[tracker] focal={best_focal} (reproj err {best_err:.2f}px)")

    # stage 2: the poses at that focal, a failed solve taking the last pose
    Rs, ts = R[best].copy(), t[best].copy()
    for i in range(1, n):
        if not (np.isfinite(Rs[i]).all() and np.isfinite(ts[i]).all()):
            Rs[i], ts[i] = Rs[i - 1], ts[i - 1]

    id_out = np.zeros((100,), np.float32)
    exp_out = np.zeros((n, 79), np.float32)
    light_out = np.zeros((n, 27), np.float32)

    # PnP gives world->COLMAP-camera (x right, y down, z forward); the
    # transforms json stores the OpenGL camera's, which the reader flips
    # back: negate the camera's y and z axes
    F = np.diag([1.0, -1.0, -1.0])
    Rs = F @ Rs
    ts = ts @ F.T

    # temporal smoothing of translations
    if smooth > 1:
        kernel = np.ones(smooth) / smooth
        pad = smooth // 2
        tp = np.pad(ts, ((pad, pad), (0, 0)), mode="edge")
        ts = np.stack([np.convolve(tp[:, i], kernel, "valid")
                       for i in range(3)], -1)

    euler = rot2euler(Rs)
    np.savez(os.path.join(base_dir, "track_params.npz"),
             euler=euler.astype(np.float32),
             trans=(ts * 10.0).astype(np.float32),
             focal=np.array([best_focal], np.float32),
             id=id_out, exp=exp_out, light=light_out)
    print(f"[tracker] wrote track_params.npz for {n} frames")
