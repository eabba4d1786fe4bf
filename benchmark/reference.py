"""The plain reference of the synthesis frame, in PyTorch alone: the motion
nets (audio encoder, audio attention, tri-plane hash grids, MLPs), the EWA
projection, SH colours, exact front-K tile selection, the tensor composite,
the mouth dilation and the face/mouth fusion, down to uint8 frames.

It follows the published method as the program implements it (a frozen
copy of its plain paths, written over a flat dict of tensors) and imports
nothing of the program: it reads the same seeded inputs (``gen.py``) and
works everything out again from them. ``tf32=True`` computes the matrix
products and convolutions in TF32, the control of ``correct``.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as Fn

AUDIO_IN_DIM = {"deepspeech": 29, "hubert": 1024, "esperanto": 44}
TILE = 16
SELECT_CHUNK = 128
PLAIN_CHUNK = 32


# ---------------------------------------------------------------- nets
def _mlp_shapes(prefix, d_in, d_out, hidden, layers):
    dims = [d_in] + [hidden] * (layers - 1) + [d_out]
    return {f"{prefix}.net_{i}.weight": (dims[i + 1], dims[i])
            for i in range(layers)}


def _audio_shapes(extractor: str, audio_dim: int = 32):
    d_in = AUDIO_IN_DIM[extractor]
    width = 32 if d_in < 128 else 128
    chans = [d_in, width, width, 64, 64]
    s = {}
    for i in range(4):
        s[f"audio.audio_net.conv_{i}.weight"] = (chans[i + 1], chans[i], 3)
        s[f"audio.audio_net.conv_{i}.bias"] = (chans[i + 1],)
    s.update({"audio.audio_net.fc_0.weight": (64, 64),
              "audio.audio_net.fc_0.bias": (64,),
              "audio.audio_net.fc_1.weight": (audio_dim, 64),
              "audio.audio_net.fc_1.bias": (audio_dim,)})
    att = [audio_dim, 16, 8, 4, 2, 1]
    for i in range(5):
        s[f"audio.audio_att_net.att_conv_{i}.weight"] = (att[i + 1], att[i], 3)
        s[f"audio.audio_att_net.att_conv_{i}.bias"] = (att[i + 1],)
    s.update({"audio.audio_att_net.att_fc.weight": (8, 8),
              "audio.audio_att_net.att_fc.bias": (8,)})
    return s


# (base resolution, desired resolution) of each net's tri-plane
GRIDS = {"face_umf": (16, 256 * 0.15), "mouth_umf": (64, 384 * 0.15),
         "face_pmf": (16, 256 * 0.15), "mouth_pmf": (16, 256 * 0.15)}
LEVELS, LOG2_T = 12, 17
BOUND = 0.15


def grid_levels(base: int, desired: float):
    """Per level (scale, side, offset) of a dense 2-D multiresolution grid
    (Instant-NGP's: scale = base s**l - 1, side = ceil(scale) + 2, each
    level's table rounded up to 8 rows), and the table's total rows."""
    s = float(np.exp2(np.log2(desired / base) / (LEVELS - 1)))
    out, off = [], 0
    for lvl in range(LEVELS):
        res = int(np.ceil(base * s ** lvl))
        params = int(np.ceil(min(2 ** LOG2_T, (res + 1) ** 2) / 8) * 8)
        scale = float(np.exp2(lvl * np.log2(s)) * base - 1.0)
        side = int(np.ceil(scale)) + 2
        if side * side > params + 8:
            raise ValueError("a hashed level: the reference has dense ones")
        out.append((scale, side, off))
        off += params
    return out, off


def net_shapes(kind: str, extractor: str) -> dict:
    """Parameter names and shapes of one motion net, as the program's
    modules name them."""
    s = dict(_audio_shapes(extractor))
    _, rows = grid_levels(*GRIDS[kind])
    for plane in ("xy", "yz", "xz"):
        s[f"encoder.encoder_{plane}.embeddings"] = (rows, 1)
    enc = 3 * LEVELS
    if kind == "face_umf":
        s.update(_mlp_shapes("exp_encode_net", 5, 5, 16, 2))
        s.update(_mlp_shapes("eye_att_net", enc, 6, 16, 2))
        s.update(_mlp_shapes("sigma_net", enc + 32 + 6, 11, 64, 3))
        s.update(_mlp_shapes("aud_ch_att_net", enc, 32, 32, 2))
    elif kind == "mouth_umf":
        s.update(_mlp_shapes("sigma_net", enc + 32 + 3, 7, 32, 3))
        s.update(_mlp_shapes("scaler_net", enc + 3, 1, 16, 3))
    elif kind == "face_pmf":
        s.update(_mlp_shapes("exp_encode_net", 5, 5, 16, 2))
        s.update(_mlp_shapes("eye_att_net", enc, 6, 16, 2))
        s.update(_mlp_shapes("sigma_net", enc + 32 + 6, 11, 32, 3))
        s.update(_mlp_shapes("align_net", enc, 6, 32, 2))
        s.update(_mlp_shapes("aud_ch_att_net", enc, 32, 32, 2))
    elif kind == "mouth_pmf":
        s.update(_mlp_shapes("sigma_net", enc + 32, 7, 16, 3))
        s.update(_mlp_shapes("align_net", enc, 6, 16, 2))
        s.update(_mlp_shapes("aud_ch_att_net", enc, 32, 32, 2))
    else:
        raise ValueError(kind)
    return s


def _mlp(p, prefix, x):
    i = 0
    while f"{prefix}.net_{i}.weight" in p:
        if i:
            x = Fn.relu(x)
        x = Fn.linear(x, p[f"{prefix}.net_{i}.weight"])
        i += 1
    return x


def _audio(p, a):
    """[8, D, 16] window -> [1, 32]: the conv encoder of each of the 8
    frames, then their temporal attention."""
    x = a
    for i in range(4):
        x = Fn.leaky_relu(Fn.conv1d(x, p[f"audio.audio_net.conv_{i}.weight"],
                                    p[f"audio.audio_net.conv_{i}.bias"],
                                    stride=2, padding=1), 0.02)
    x = x[:, :, 0]
    x = Fn.leaky_relu(Fn.linear(x, p["audio.audio_net.fc_0.weight"],
                                p["audio.audio_net.fc_0.bias"]), 0.02)
    x = Fn.linear(x, p["audio.audio_net.fc_1.weight"],
                  p["audio.audio_net.fc_1.bias"])[None]       # [1, 8, 32]
    y = x.transpose(1, 2)
    for i in range(5):
        y = Fn.leaky_relu(Fn.conv1d(
            y, p[f"audio.audio_att_net.att_conv_{i}.weight"],
            p[f"audio.audio_att_net.att_conv_{i}.bias"], padding=1), 0.02)
    y = Fn.linear(y.reshape(1, 8), p["audio.audio_att_net.att_fc.weight"],
                  p["audio.audio_att_net.att_fc.bias"])
    y = torch.softmax(y, dim=1).reshape(1, 8, 1)
    return torch.sum(y * x, dim=1)


def _grid(table, levels, x2):
    """One plane: [N, 2] in [-BOUND, BOUND] -> [N, LEVELS] (bilinear,
    zero outside the bound)."""
    x01 = (x2 + BOUND) / (2.0 * BOUND)
    oob = torch.any((x01 < 0.0) | (x01 > 1.0), dim=-1, keepdim=True)
    outs = []
    for scale, side, off in levels:
        pos = torch.addcmul(torch.full_like(x01, 0.5), x01,
                            torch.full_like(x01, scale))
        fl = torch.floor(pos)
        frac = pos - fl
        cell = fl.clamp_min(0).to(torch.int64)
        x0 = torch.clamp_max(cell[:, 0], side - 1)
        x1 = torch.clamp_max(cell[:, 0] + 1, side - 1)
        y0 = torch.clamp_max(cell[:, 1], side - 1) * side + off
        y1 = torch.clamp_max(cell[:, 1] + 1, side - 1) * side + off
        fx, fy = frac[:, 0:1], frac[:, 1:2]
        m0 = (1.0 - fy) * table[x0 + y0] + fy * table[x0 + y1]
        m1 = (1.0 - fy) * table[x1 + y0] + fy * table[x1 + y1]
        outs.append((1.0 - fx) * m0 + fx * m1)
    return torch.where(oob, torch.zeros((), device=x2.device),
                       torch.cat(outs, dim=-1))


def _triplane(p, kind, x):
    levels, _ = grid_levels(*GRIDS[kind])
    planes = (x[:, :2], x[:, 1:], torch.cat([x[:, :1], x[:, 2:]], dim=-1))
    return torch.cat([_grid(p[f"encoder.encoder_{n}.embeddings"], levels, xp)
                      for n, xp in zip(("xy", "yz", "xz"), planes)], dim=-1)


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)


def _expression(p, enc_x, e):
    eye = torch.relu(_mlp(p, "eye_att_net", enc_x))
    enc_e = torch.cat([_mlp(p, "exp_encode_net", e[:-1]), e[-1:]], dim=-1)
    return enc_e[None, :] * eye, eye


def face_umf(p, x, a, e) -> dict:
    enc_x = _triplane(p, "face_umf", x)
    att = _mlp(p, "aud_ch_att_net", enc_x)
    enc_e, eye = _expression(p, enc_x, e)
    h = _mlp(p, "sigma_net", torch.cat([enc_x, _audio(p, a) * att, enc_e], -1))
    return dict(d_xyz=h[:, :3] * 1e-2, d_rot=h[:, 3:7], d_opa=h[:, 7:8],
                d_scale=h[:, 8:11], ambient_aud=_norm(att),
                ambient_eye=_norm(eye))


def mouth_umf(p, x, a, move) -> dict:
    enc_x = _triplane(p, "mouth_umf", x)
    n = enc_x.shape[0]
    mv = move.expand(n, -1)
    h = _mlp(p, "sigma_net", torch.cat([enc_x, _audio(p, a).expand(n, -1),
                                        mv], -1))
    tau = _mlp(p, "scaler_net", torch.cat([enc_x, mv], -1))
    damp = torch.tensor([0.2, 1.0, 0.2], device=h.device)
    return dict(d_xyz=h[:, :3] * 1e-2 * damp * torch.sigmoid(tau) * 2.0,
                d_rot=h[:, 3:])


def pmf(p, kind, x, a, e=None) -> dict:
    enc_x = _triplane(p, kind, x)
    att = _mlp(p, "aud_ch_att_net", enc_x)
    h = torch.cat([enc_x, _audio(p, a) * att], -1)
    if kind == "face_pmf":
        h = torch.cat([h, _expression(p, enc_x, e)[0]], -1)
    h = _mlp(p, "sigma_net", h)
    q = _mlp(p, "align_net", enc_x)
    return dict(d_xyz=h[:, :3] * 1e-2, p_xyz=q[:, :3] * 1e-2,
                p_scale=torch.tanh(q[:, 3:] / 5.0) * 0.25 + 1.0)


# ---------------------------------------------------------------- raster
def project(size: int, means, scales, rots, cam, alive):
    """EWA projection: (px, py, depth, conic [N, 3], radius, visible)."""
    H = W = size
    V, Pm, tan = cam["view"], cam["full"], cam["tan"]
    focal = W / (2.0 * tan)
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    pvx = mx * V[0, 0] + my * V[1, 0] + mz * V[2, 0] + V[3, 0]
    pvy = mx * V[0, 1] + my * V[1, 1] + mz * V[2, 1] + V[3, 1]
    pvz = mx * V[0, 2] + my * V[1, 2] + mz * V[2, 2] + V[3, 2]
    phx = mx * Pm[0, 0] + my * Pm[1, 0] + mz * Pm[2, 0] + Pm[3, 0]
    phy = mx * Pm[0, 1] + my * Pm[1, 1] + mz * Pm[2, 1] + Pm[3, 1]
    phw = mx * Pm[0, 3] + my * Pm[1, 3] + mz * Pm[2, 3] + Pm[3, 3]
    den = phw + 1e-7
    den = torch.where(den.abs() < 1e-6, torch.where(den < 0, -1e-6, 1e-6), den)
    pw = 1.0 / den
    px = ((phx * pw + 1.0) * W - 1.0) * 0.5
    py = ((phy * pw + 1.0) * H - 1.0) * 0.5
    q = rots / torch.sqrt(torch.sum(rots * rots, -1, keepdim=True) + 1e-24)
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = [[1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
         [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
         [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)]]
    s = [scales[:, i] ** 2 for i in range(3)]

    def cov(i, j):
        return R[i][0] * R[j][0] * s[0] + R[i][1] * R[j][1] * s[1] \
            + R[i][2] * R[j][2] * s[2]
    c00, c11, c22 = cov(0, 0), cov(1, 1), cov(2, 2)
    c01, c02, c12 = cov(0, 1), cov(0, 2), cov(1, 2)
    tz = torch.clamp_min(pvz, 0.2)
    lim = 1.3 * tan
    txz = torch.clamp(pvx / tz, -lim, lim) * tz
    tyz = torch.clamp(pvy / tz, -lim, lim) * tz
    z2 = tz * tz
    j00, j02 = focal / tz, -(focal * txz) / z2
    j11, j12 = focal / tz, -(focal * tyz) / z2
    t00, t01, t02 = (j00 * V[0, 0] + j02 * V[0, 2], j00 * V[1, 0] + j02 * V[1, 2],
                     j00 * V[2, 0] + j02 * V[2, 2])
    t10, t11, t12 = (j11 * V[0, 1] + j12 * V[0, 2], j11 * V[1, 1] + j12 * V[1, 2],
                     j11 * V[2, 1] + j12 * V[2, 2])
    a = (t00 * t00 * c00 + t01 * t01 * c11 + t02 * t02 * c22
         + 2 * (t00 * t01 * c01 + t00 * t02 * c02 + t01 * t02 * c12)) + 0.3
    b = (t00 * t10 * c00 + t01 * t11 * c11 + t02 * t12 * c22
         + (t00 * t11 + t01 * t10) * c01 + (t00 * t12 + t02 * t10) * c02
         + (t01 * t12 + t02 * t11) * c12)
    c = (t10 * t10 * c00 + t11 * t11 * c11 + t12 * t12 * c22
         + 2 * (t10 * t11 * c01 + t10 * t12 * c02 + t11 * t12 * c12)) + 0.3
    det = a * c - b * b
    inv = 1.0 / torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))
    visible = (pvz > 0.2) & (det > 0) & (radius > 0) & alive
    return px, py, pvz, conic, radius, visible


def select(size: int, k: int, px, py, depth, radius, visible):
    """Each 16x16 tile's front-most ``k`` splats whose 3-sigma square meets
    the tile: (ids [T, k], valid [T, k]), nearest first."""
    tiles_x = size // TILE
    T = tiles_x * tiles_x
    dev = px.device
    ninf = torch.tensor(float("-inf"), device=dev)
    key = torch.where(visible, -depth, ninf)
    kk = min(k, px.shape[0])
    ids = torch.zeros((T, k), dtype=torch.int64, device=dev)
    valid = torch.zeros((T, k), dtype=torch.bool, device=dev)
    for t0 in range(0, T, SELECT_CHUNK):
        t1 = min(T, t0 + SELECT_CHUNK)
        t = torch.arange(t0, t1, device=dev)
        x0 = (t % tiles_x).to(px.dtype) * TILE
        y0 = (t // tiles_x).to(px.dtype) * TILE
        hit = ((px + radius)[None] >= x0[:, None]) \
            & ((px - radius)[None] <= (x0 + TILE)[:, None]) \
            & ((py + radius)[None] >= y0[:, None]) \
            & ((py - radius)[None] <= (y0 + TILE)[:, None])
        vals, idx = torch.topk(torch.where(hit, key[None], ninf), kk, dim=-1)
        ids[t0:t1, :kk] = idx
        valid[t0:t1, :kk] = vals > float("-inf")
    return ids, valid


def composite(size: int, px, py, conic, opac, colors, ids, valid, bg):
    """Front-to-back alpha composite of each tile's selected splats:
    (image [3, H, W], alpha [1, H, W], counts), with the counts of the
    work the inputs need: valid slots, busy tiles and the (pixel, splat)
    pairs a front-to-back walk evaluates (up to and including each
    pixel's first slot past the 1e-4 transmittance cut)."""
    tiles_x = size // TILE
    T, P = tiles_x * tiles_x, TILE * TILE
    dev = px.device
    oy, ox = torch.meshgrid(torch.arange(TILE, device=dev),
                            torch.arange(TILE, device=dev), indexing="ij")
    ox, oy = ox.reshape(-1).float(), oy.reshape(-1).float()
    feats = torch.cat([px[:, None], py[:, None], conic, opac[:, None],
                       colors], -1)
    cnt = valid.sum(-1)
    out = torch.empty((T, 5, P), device=dev)      # RGB, T_final, alpha
    zero = torch.zeros((), device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for t0 in range(0, T, PLAIN_CHUNK):
        t1 = min(T, t0 + PLAIN_CHUNK)
        t = torch.arange(t0, t1, device=dev)
        f = feats[ids[t0:t1]]
        xs = ((t % tiles_x).float() * TILE)[:, None] + ox[None]
        ys = ((t // tiles_x).float() * TILE)[:, None] + oy[None]
        dx = xs[:, :, None] - f[..., 0][:, None]
        dy = ys[:, :, None] - f[..., 1][:, None]
        A, B, C = f[..., 2][:, None], f[..., 3][:, None], f[..., 4][:, None]
        power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
        alpha = torch.clamp_max(f[..., 5][:, None] * torch.exp(power), 0.99)
        ok = (power <= 0.0) & (alpha >= 1.0 / 255.0) & valid[t0:t1, None, :]
        alpha = torch.where(ok, alpha, zero)
        log_t = torch.log1p(-alpha)
        cum = torch.cumsum(log_t, -1)
        contrib = torch.exp(cum) >= 1e-4
        w = torch.where(contrib, alpha * torch.exp(cum - log_t), zero)
        out[t0:t1, :3] = torch.einsum("cpk,ckd->cdp", w, f[..., 6:9])
        out[t0:t1, 3] = torch.exp(torch.where(contrib, log_t, zero).sum(-1))
        out[t0:t1, 4] = w.sum(-1)
        pairs += torch.minimum(contrib.sum(-1) + 1, cnt[t0:t1, None]).sum()

    def img(x, ch):
        x = x.reshape(tiles_x, tiles_x, ch, TILE, TILE)
        return x.permute(2, 0, 3, 1, 4).reshape(ch, size, size)
    image = img(out[:, :3], 3) + img(out[:, 3:4], 1) * bg[:, None, None]
    counts = dict(valid=int(cnt.sum()), busy=int((cnt > 0).sum()),
                  pairs=int(pairs), tiles=T)
    return image, img(out[:, 4:5], 1), counts


def sh_colors(means, campos, shs, degree: int):
    """View-dependent RGB of SH coefficients [N, K, 3] (PlenOctree basis,
    degrees 0-2), clamped at 0."""
    d = means - campos[None]
    d = d / torch.sqrt(torch.sum(d * d, -1, keepdim=True) + 1e-16)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    basis = [torch.full_like(x, 0.28209479177387814)]
    if degree > 0:
        c1 = 0.4886025119029199
        basis += [-c1 * y, c1 * z, -c1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        basis += [1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
                  0.31539156525252005 * (2.0 * zz - xx - yy),
                  -1.0925484305920792 * x * z,
                  0.5462742152960396 * (xx - yy)]
    if degree > 2:
        raise ValueError("the reference's SH stops at degree 2")
    basis = torch.stack(basis, -1)
    k = basis.shape[-1]
    return torch.clamp_min(torch.einsum("...ck,...k->...c",
                                        shs.transpose(-1, -2)[..., :k], basis)
                           + 0.5, 0.0)


# ---------------------------------------------------------------- frame
def _features(cl: dict):
    return torch.cat([cl["features_dc"], cl["features_rest"]], 1)


def _safe_normalize(x):
    return x / torch.sqrt(torch.sum(x * x, -1, keepdim=True) + 1e-24)


def _move(face_d_xyz, alive, k: int = 10, k_max: int = 50):
    dy = face_d_xyz[:, 1]
    k_max = min(k_max, dy.shape[0])
    inf = torch.tensor(float("inf"), device=dy.device)
    hi = torch.topk(torch.where(alive, dy, -inf), k_max).values
    lo = torch.topk(-torch.where(alive, dy, inf), k_max).values
    kidx = torch.clamp(torch.clamp_max(alive.sum(), k) - 1, 0, k_max - 1)
    m_hi, m_lo = hi[kidx], -lo[kidx]
    zero = torch.zeros((), device=dy.device)
    m_hi = torch.where(torch.isfinite(m_hi), m_hi, zero)
    m_lo = torch.where(torch.isfinite(m_lo), m_lo, zero)
    return torch.stack([m_hi, m_lo, m_hi - m_lo])[None] * 1e2


def _branch(size, k, cl, means, scales, rots, cam, sh_degree, bg):
    px, py, depth, conic, radius, vis = project(size, means, scales, rots,
                                                cam, cl["alive"])
    ids, valid = select(size, k, px, py, depth, radius, vis)
    colors = sh_colors(means, cam["center"], _features(cl), sh_degree)
    return composite(size, px, py, conic, torch.sigmoid(cl["opacity"])[:, 0],
                     colors, ids, valid, bg)


def frame(model: dict, cam: dict, aud, exp, torso_u8, size: int, k: int,
          sh_degrees: tuple, dilate: bool = True):
    """One fused frame, uint8 [H, W, 3], and the composite's counts of the
    face and mouth branches. ``model``: ``face``/``mouth`` raw clouds and
    ``face_umf``/``mouth_umf``/``face_pmf``/``mouth_pmf`` weight dicts;
    ``sh_degrees``: the face's and the mouth's SH degrees."""
    face, mouth = model["face"], model["mouth"]
    green = torch.tensor([0.0, 1.0, 0.0], device=aud.device)
    # face branch: the PMF's align head moves the UMF's input and scales
    # its offsets; the splats move from the unaligned positions
    x0 = face["xyz"]
    pf = pmf(model["face_pmf"], "face_pmf", x0, aud, exp)
    m = face_umf(model["face_umf"], x0 + pf["p_xyz"], aud, exp)
    means = x0 + m["d_xyz"] * pf["p_scale"]
    f_img, f_alpha, f_counts = _branch(
        size, k, face, means, Fn.softplus(face["scaling"] + m["d_scale"]),
        _safe_normalize(face["rotation"] + m["d_rot"]), cam, sh_degrees[0],
        green)
    # mouth branch, conditioned on the face UMF's vertical motion range
    y0 = mouth["xyz"]
    pm = pmf(model["mouth_pmf"], "mouth_pmf", y0, aud)
    mm = mouth_umf(model["mouth_umf"], y0 + pm["p_xyz"], aud,
                   _move(m["d_xyz"], face["alive"]))
    m_img, m_alpha, m_counts = _branch(
        size, k, mouth, y0 + mm["d_xyz"], Fn.softplus(mouth["scaling"]),
        _safe_normalize(mouth["rotation"]), cam, sh_degrees[1], green)
    ma = Fn.max_pool2d(m_alpha[None], 13, stride=1, padding=6)[0] \
        if dilate else m_alpha
    torso_bg = torso_u8.float().permute(2, 0, 1) / 255.0
    g = green[:, None, None]
    mouth_full = m_img - g * (1.0 - ma) + torso_bg * (1.0 - ma)
    img = f_img - g * (1.0 - f_alpha) + mouth_full * (1.0 - f_alpha)
    u8 = (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8).permute(1, 2, 0)
    return u8, dict(face=f_counts, mouth=m_counts)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _tf32_mode():
    """A dispatch mode that rounds the operands of every matrix product and
    convolution, forward and backward, to TF32 and sums in float32, as the
    tensor cores do with TF32 on: on any device, so the control reads the
    same in kind on the CPU as on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    # the operands of each op, as autograd leaves them (decomposed) and as
    # inference mode does (whole); einsum's are the list in its argument 1
    operands = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
                aten.matmul.default: (0, 1), aten.linear.default: (0, 1),
                aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2),
                aten.convolution.default: (0, 1), aten.conv1d.default: (0, 1),
                aten.conv2d.default: (0, 1),
                aten.convolution_backward.default: (0, 1, 2),
                aten.einsum.default: (1,)}

    def rnd(a):
        if isinstance(a, (list, tuple)):
            return type(a)(rnd(x) for x in a)
        return tf32_round(a) if a.dtype == torch.float32 else a

    class TF32(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            which = operands.get(func)
            if which:
                args = tuple(rnd(a) if j in which else a
                             for j, a in enumerate(args))
            return func(*args, **(kwargs or {}))
    return TF32()


@contextlib.contextmanager
def precision(tf32: bool):
    """Full float32 (the configuration's precision), or TF32 matrix
    products and convolutions (the control)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mode = _tf32_mode() if tf32 else contextlib.nullcontext()
    try:
        with mode:
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
