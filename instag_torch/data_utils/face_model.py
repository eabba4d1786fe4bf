"""Linear morphable face model (BFM-2009 style) for the photometric tracker
(counterpart of instag_tpu/data_utils/face_model.py).

    geometry(id, exp) = mean + B_id @ id + B_exp @ exp      [V, 3]
    texture(tex)      = mean_tex + B_tex @ tex              [V, 3] in [0, 1]

with the landmarks, area-weighted vertex normals and the 9-coefficient SH
shading of the reference's Render_3DMM. The model's arrays stay numpy
(``load_model``, ``synthetic_model``, the converters); ``to_device`` gives
the same model with torch tensors on a device, and the math runs wherever
its parameter tensors are.

The real BFM basis cannot ship with the repository, so ``load_model``
reads a converted ``.npz`` (``convert_bfm_info`` maps the reference's
``3DMM_info.npy`` layout onto it; ``convert_bfm_mat`` builds that file from
the BFM release) and ``synthetic_model`` builds a small procedural head
with the same contract.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch


class MorphableModel(NamedTuple):
    mean_shape: np.ndarray     # [V, 3]
    id_basis: np.ndarray       # [V, 3, n_id]
    exp_basis: np.ndarray      # [V, 3, n_exp]
    mean_tex: np.ndarray       # [V, 3] in [0, 1]
    tex_basis: np.ndarray      # [V, 3, n_tex]
    tris: np.ndarray           # [F, 3] int32
    landmark_idx: np.ndarray   # [68] int32 vertex ids of the 68 landmarks
    rigid_idx: np.ndarray      # [R] int32 pose-stable vertex subset

    @property
    def n_id(self) -> int:
        return self.id_basis.shape[-1]

    @property
    def n_exp(self) -> int:
        return self.exp_basis.shape[-1]

    @property
    def n_tex(self) -> int:
        return self.tex_basis.shape[-1]


def to_device(model: MorphableModel,
              device: str | torch.device) -> MorphableModel:
    """The model with its arrays as tensors on ``device`` (float32, and
    int64 indices)."""
    def conv(a):
        a = np.asarray(a)
        dtype = torch.int64 if a.dtype.kind in "iu" else torch.float32
        return torch.as_tensor(a, dtype=dtype, device=device)
    return MorphableModel(*(conv(a) for a in model))


def _on(model: MorphableModel, like: torch.Tensor) -> MorphableModel:
    if isinstance(model.mean_shape, torch.Tensor) and \
            model.mean_shape.device == like.device:
        return model
    return to_device(model, like.device)


def _combine(basis: torch.Tensor, para: torch.Tensor) -> torch.Tensor:
    return torch.einsum("vck,...k->...vc", basis, para)


def geometry(model: MorphableModel, id_para: torch.Tensor,
             exp_para: torch.Tensor) -> torch.Tensor:
    """[..., n_id], [..., n_exp] -> vertices [..., V, 3]."""
    m = _on(model, id_para)
    return (m.mean_shape + _combine(m.id_basis, id_para)
            + _combine(m.exp_basis, exp_para))


def texture(model: MorphableModel, tex_para: torch.Tensor) -> torch.Tensor:
    m = _on(model, tex_para)
    return torch.clamp(m.mean_tex + _combine(m.tex_basis, tex_para), 0.0, 1.0)


def landmarks3d(model: MorphableModel, id_para: torch.Tensor,
                exp_para: torch.Tensor) -> torch.Tensor:
    """The 68 landmark vertices [..., 68, 3] (the geometry of those rows
    alone)."""
    m = _on(model, id_para)
    lm = m.landmark_idx
    return (m.mean_shape[lm] + _combine(m.id_basis[lm], id_para)
            + _combine(m.exp_basis[lm], exp_para))


def vertex_normals(verts: torch.Tensor, tris) -> torch.Tensor:
    """Area-weighted per-vertex normals. verts [..., V, 3], tris [F, 3]."""
    t = torch.as_tensor(tris, device=verts.device).long()
    p0, p1, p2 = (verts[..., t[:, k], :] for k in range(3))
    fn = torch.linalg.cross(p1 - p0, p2 - p0)       # [..., F, 3]
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn = vn.index_add(-2, t[:, k], fn)
    return vn / torch.clamp_min(torch.linalg.norm(vn, dim=-1, keepdim=True),
                                1e-8)


def sh_shading(normals: torch.Tensor, light: torch.Tensor) -> torch.Tensor:
    """9-coefficient-per-channel SH irradiance: normals [..., V, 3], light
    [..., 27] (9 SH coefficients x RGB) -> [..., V, 3] multiplicative
    shading."""
    x, y, z = normals[..., 0], normals[..., 1], normals[..., 2]
    basis = torch.stack([
        torch.ones_like(x) * 0.2820948,                       # l=0
        0.4886025 * y, 0.4886025 * z, 0.4886025 * x,          # l=1
        1.0925484 * x * y, 1.0925484 * y * z,
        0.3153916 * (3 * z * z - 1.0),
        1.0925484 * x * z, 0.5462742 * (x * x - y * y),       # l=2
    ], -1)                                                    # [..., V, 9]
    gamma = light.reshape(light.shape[:-1] + (9, 3))
    return torch.einsum("...vb,...bc->...vc", basis, gamma)


def load_model(path: str) -> MorphableModel:
    """Load a converted morphable model .npz (our field names)."""
    d = np.load(path)
    return MorphableModel(
        mean_shape=d["mean_shape"].astype(np.float32),
        id_basis=d["id_basis"].astype(np.float32),
        exp_basis=d["exp_basis"].astype(np.float32),
        mean_tex=d["mean_tex"].astype(np.float32),
        tex_basis=d["tex_basis"].astype(np.float32),
        tris=d["tris"].astype(np.int32),
        landmark_idx=d["landmark_idx"].astype(np.int32),
        rigid_idx=d["rigid_idx"].astype(np.int32))


def save_model(path: str, model: MorphableModel) -> None:
    """Write a model in ``load_model``'s layout."""
    np.savez(path, **model._asdict())


def convert_bfm_mat(model_dir: str) -> str:
    """Build ``3DMM_info.npy`` from the raw BFM-2009 release
    (``01_MorphableModel.mat`` with the AD-NeRF ``exp_info.npy`` and
    ``topology_info.npy`` in ``model_dir``), as the reference's
    convert_BFM.py does: bases ``[3V, 199]`` -> ``[199, V, 3]``, restricted
    to ``topology_info['sub_inds']``, flattened back to ``[199, 3V']``;
    the expression fields copied from exp_info.npy."""
    from scipy.io import loadmat

    bfm = loadmat(os.path.join(model_dir, "01_MorphableModel.mat"))
    topo = np.load(os.path.join(model_dir, "topology_info.npy"),
                   allow_pickle=True).item()
    sub_inds = topo["sub_inds"]

    def sub_basis(pc):
        b = pc.reshape(-1, 199).transpose(1, 0).reshape(199, -1, 3)
        return b[:, sub_inds, :].reshape(199, -1)

    def sub_mean(mu):
        return mu.reshape(-1, 3)[sub_inds, :].reshape(-1)

    exp_info = np.load(os.path.join(model_dir, "exp_info.npy"),
                       allow_pickle=True).item()
    out = os.path.join(model_dir, "3DMM_info.npy")
    np.save(out, {
        "mu_shape": sub_mean(bfm["shapeMU"]),
        "b_shape": sub_basis(bfm["shapePC"]),
        "sig_shape": bfm["shapeEV"].reshape(-1),
        "mu_exp": exp_info["mu_exp"],
        "b_exp": exp_info["base_exp"],
        "sig_exp": exp_info["sig_exp"],
        "mu_tex": sub_mean(bfm["texMU"]),
        "b_tex": sub_basis(bfm["texPC"]),
        "sig_tex": bfm["texEV"].reshape(-1),
    })
    return out


def convert_bfm_info(model_dir: str, out_path: str,
                     n_id: int = 100, n_exp: int = 79,
                     n_tex: int = 100) -> str:
    """Convert the reference's ``3DMM/`` model directory (``3DMM_info.npy``
    with flattened ``[3V]`` means, ``[K, 3V]`` bases and per-mode stddevs;
    ``keys_info.npy`` with ``keyinds`` and ``rigid_ids``;
    ``topology_info.npy`` with ``tris``) to ``load_model``'s ``.npz``.

    The reference facemodel.py's normalization is folded in, so ``mean + B
    @ para`` reproduces its ``(para * sig) @ (b / 1e5) + centered(mu /
    1e5)``: the mean is the centred (mu_shape + mu_exp) / 1e5, the id and
    exp bases ``[V, 3, K]`` scaled by sig / 1e5, the texture (0-255 in the
    file) mapped to [0, 1] with sig_tex folded in."""
    info = np.load(os.path.join(model_dir, "3DMM_info.npy"),
                   allow_pickle=True).item()
    keys = np.load(os.path.join(model_dir, "keys_info.npy"),
                   allow_pickle=True).item()
    topo = np.load(os.path.join(model_dir, "topology_info.npy"),
                   allow_pickle=True).item()
    v = info["mu_shape"].size // 3

    def basis(b, sig, k, scale):
        # [K_all, 3V] -> [V, 3, k], each mode scaled by its stddev
        bt = (b[:k].astype(np.float64)
              * sig[:k].reshape(-1, 1).astype(np.float64) * scale)
        return np.transpose(bt.reshape(k, v, 3), (1, 2, 0)).astype(np.float32)

    mu = (info["mu_shape"].astype(np.float64)
          + info["mu_exp"].astype(np.float64)).reshape(v, 3)
    mu = mu - mu.mean(axis=0, keepdims=True)     # facemodel.py:23-26
    mu = (mu / 100000.0).astype(np.float32)

    np.savez(
        out_path,
        mean_shape=mu,
        id_basis=basis(info["b_shape"], info["sig_shape"], n_id, 1e-5),
        exp_basis=basis(info["b_exp"], info["sig_exp"], n_exp, 1e-5),
        mean_tex=(info["mu_tex"].reshape(v, 3) / 255.0).astype(np.float32),
        tex_basis=basis(info["b_tex"], info["sig_tex"], n_tex, 1.0 / 255.0),
        tris=np.asarray(topo["tris"], np.int32).reshape(-1, 3),
        landmark_idx=np.asarray(keys["keyinds"], np.int32).reshape(-1),
        rigid_idx=np.asarray(keys["rigid_ids"], np.int32).reshape(-1))
    return out_path


def synthetic_model(n_theta: int = 24, n_phi: int = 18, n_id: int = 8,
                    n_exp: int = 12, n_tex: int = 6,
                    seed: int = 0) -> MorphableModel:
    """Procedural deformable head: an ellipsoid sphere-mesh with smooth
    random id/exp/tex modes. Same contract as a converted BFM; the arrays
    are the JAX package's (the same generator calls in the same order)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0.15, np.pi - 0.15, n_phi)
    ph = np.linspace(-np.pi * 0.75, np.pi * 0.75, n_theta)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    x = 0.11 * np.sin(tt) * np.sin(pp)
    y = 0.14 * np.cos(tt)
    z = 0.11 * np.sin(tt) * np.cos(pp)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    V = verts.shape[0]

    tris = []
    for i in range(n_phi - 1):
        for j in range(n_theta - 1):
            a = i * n_theta + j
            b = a + 1
            c = a + n_theta
            d = c + 1
            tris += [[a, b, c], [b, d, c]]
    tris = np.asarray(tris, np.int32)

    def smooth_modes(k, scale):
        # smooth low-frequency deformation fields over the surface
        modes = np.zeros((V, 3, k), np.float32)
        for m in range(k):
            f = rng.uniform(1.0, 3.0, (3,))
            phs = rng.uniform(0, 2 * np.pi, (3,))
            amp = rng.normal(size=(3, 3)) * scale
            base = np.stack([np.sin(f[0] * tt.reshape(-1) + phs[0]),
                             np.sin(f[1] * pp.reshape(-1) + phs[1]),
                             np.cos(f[2] * (tt + pp).reshape(-1) + phs[2])], -1)
            modes[:, :, m] = base @ amp
        return modes

    id_basis = smooth_modes(n_id, 0.004)
    exp_basis = smooth_modes(n_exp, 0.006)
    mean_tex = (0.45 + 0.25 * np.stack(
        [np.cos(tt.reshape(-1)), np.sin(pp.reshape(-1)),
         np.cos(pp.reshape(-1))], -1)).astype(np.float32).clip(0.05, 0.95)
    tex_basis = smooth_modes(n_tex, 0.06)

    # 68 landmark vertices: spread over the front of the head
    front = np.where(verts[:, 2] > 0.04)[0]
    landmark_idx = front[np.linspace(0, len(front) - 1, 68).astype(int)]
    rigid_idx = front[np.linspace(0, len(front) - 1, 40).astype(int)]
    return MorphableModel(verts, id_basis, exp_basis, mean_tex, tex_basis,
                          tris, landmark_idx.astype(np.int32),
                          rigid_idx.astype(np.int32))
