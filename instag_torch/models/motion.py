"""Motion fields: Universal (face/mouth) and Personalized (counterpart of
instag_tpu/models/motion.py).

  * MotionNetwork (face UMF): tri-plane encoding (base 16, desired
    256*bound, bound 0.15) + audio code gated per Gaussian by a channel
    attention MLP + AU expression code gated by an eye attention MLP ->
    sigma MLP(74 -> 11) -> d_xyz*1e-2, d_rot, d_opa, d_scale.
  * MouthMotionNetwork: denser tri-plane (base 64, desired 384*bound);
    inputs add the 3-dim ``move`` feature; sigma MLP(71 -> 7) gives d_xyz
    (x/z divided by 5) and d_rot, d_xyz scaled by sigmoid(scaler_net)*2.
  * PersonalizedMotionNetwork: per-identity residual field; the face
    variant has expression gating and an 11-dim output, the mouth variant
    a 7-dim one, hidden 32/16; align_net gives p_xyz = *1e-2 and
    p_scale = tanh(/5)*0.25 + 1.

Module and parameter names match the flax trees (``audio.audio_net.conv_0``,
``encoder.encoder_xy.embeddings``, ``sigma_net.net_2``, ...). The mouth UMF
has no ``aud_ch_att_net``: the flax module declares one but never calls it,
so its parameter tree holds none.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .encoders import TriplaneEncoder
from .nets import MLP, AudioAttNet, AudioNet, AudioNetAVE

AUDIO_IN_DIM = {"esperanto": 44, "deepspeech": 29, "hubert": 1024, "ave": 32}


def _safe_norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2 norm with a finite gradient at zero."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def audio_in_dim(extractor: str) -> int:
    for key, dim in AUDIO_IN_DIM.items():
        if key in extractor:
            return dim
    raise NotImplementedError(f"unknown audio extractor: {extractor}")


class AudioFeature(nn.Module):
    """audio_net -> audio_att_net: [8, dim, 16] window -> [1, audio_dim]."""

    def __init__(self, audio_extractor: str = "deepspeech",
                 audio_dim: int = 32):
        super().__init__()
        if audio_extractor == "ave":
            self.audio_net = AudioNetAVE(audio_dim)
        else:
            self.audio_net = AudioNet(audio_in_dim(audio_extractor), audio_dim)
        self.audio_att_net = AudioAttNet(audio_dim)

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        return self.audio_att_net(self.audio_net(a)[None])


def _expression(exp_encode_net: MLP, eye_att_net: MLP, enc_x, e):
    """Eye-attention-gated AU code [N, 6] and the attention itself."""
    eye_att = torch.relu(eye_att_net(enc_x))
    enc_e = torch.cat([exp_encode_net(e[:-1]), e[-1:]], dim=-1)
    return enc_e[None, :] * eye_att, eye_att


class MotionNetwork(nn.Module):
    """Face-branch Universal Motion Field."""

    def __init__(self, audio_extractor: str = "deepspeech",
                 audio_dim: int = 32, bound: float = 0.15):
        super().__init__()
        self.bound = bound
        self.audio = AudioFeature(audio_extractor, audio_dim)
        self.encoder = TriplaneEncoder(base_resolution=16,
                                       desired_resolution=256 * bound)
        in_dim = self.encoder.output_dim              # 36
        eye_dim = 6
        self.exp_encode_net = MLP(eye_dim - 1, eye_dim - 1, 16, 2)
        self.eye_att_net = MLP(in_dim, eye_dim, 16, 2)
        self.sigma_net = MLP(in_dim + audio_dim + eye_dim, 11, 64, 3)
        self.aud_ch_att_net = MLP(in_dim, audio_dim, 32, 2)

    def forward(self, x, a, e) -> dict:
        """x [N,3] canonical positions, a audio window, e [6] AU vector."""
        enc_x = self.encoder(x, self.bound)
        enc_a = self.audio(a)
        aud_ch_att = self.aud_ch_att_net(enc_x)
        enc_w = enc_a * aud_ch_att
        enc_e, eye_att = _expression(self.exp_encode_net, self.eye_att_net,
                                     enc_x, e)
        h = self.sigma_net(torch.cat([enc_x, enc_w, enc_e], dim=-1))
        return {
            "d_xyz": h[..., :3] * 1e-2,
            "d_rot": h[..., 3:7],
            "d_opa": h[..., 7:8],
            "d_scale": h[..., 8:11],
            "ambient_aud": _safe_norm(aud_ch_att),
            "ambient_eye": _safe_norm(eye_att),
        }


class MouthMotionNetwork(nn.Module):
    """Mouth-branch Universal Motion Field."""

    def __init__(self, audio_extractor: str = "deepspeech",
                 audio_dim: int = 32, bound: float = 0.15):
        super().__init__()
        self.bound = bound
        self.audio = AudioFeature(audio_extractor, audio_dim)
        self.encoder = TriplaneEncoder(base_resolution=64,
                                       desired_resolution=384 * bound)
        in_dim = self.encoder.output_dim
        self.sigma_net = MLP(in_dim + audio_dim + 3, 7, 32, 3)
        self.scaler_net = MLP(in_dim + 3, 1, 16, 3)

    def forward(self, x, a, move) -> dict:
        """move [1, 3]: the face-motion range feature from the renderer."""
        enc_x = self.encoder(x, self.bound)
        n = enc_x.shape[0]
        enc_w = self.audio(a).expand(n, -1)
        mv = move.expand(n, -1)
        h = self.sigma_net(torch.cat([enc_x, enc_w, mv], dim=-1))
        tau = self.scaler_net(torch.cat([enc_x, mv], dim=-1))
        damp = torch.tensor([0.2, 1.0, 0.2], dtype=h.dtype, device=h.device)
        d_xyz = h[..., :3] * 1e-2 * damp                 # x, z divided by 5
        return {
            "d_xyz": d_xyz * torch.sigmoid(tau) * 2.0,
            "d_rot": h[..., 3:],
        }


class PersonalizedMotionNetwork(nn.Module):
    """Per-identity residual motion field (PMF)."""

    def __init__(self, kind: str = "face", audio_extractor: str = "deepspeech",
                 audio_dim: int = 32, bound: float = 0.15):
        super().__init__()
        self.kind = kind
        self.bound = bound
        self.audio = AudioFeature(audio_extractor, audio_dim)
        self.encoder = TriplaneEncoder(base_resolution=16,
                                       desired_resolution=256 * bound)
        in_dim = self.encoder.output_dim
        hidden = 32 if kind == "face" else 16
        out_dim = 11 if kind == "face" else 7
        eye_dim = 6
        sigma_in = in_dim + audio_dim
        if kind == "face":
            self.exp_encode_net = MLP(eye_dim - 1, eye_dim - 1, 16, 2)
            self.eye_att_net = MLP(in_dim, eye_dim, 16, 2)
            sigma_in += eye_dim
        self.sigma_net = MLP(sigma_in, out_dim, hidden, 3)
        self.align_net = MLP(in_dim, 6, hidden, 2)
        self.aud_ch_att_net = MLP(in_dim, audio_dim, 32, 2)

    def forward(self, x, a, e=None) -> dict:
        enc_x = self.encoder(x, self.bound)
        enc_a = self.audio(a)
        aud_ch_att = self.aud_ch_att_net(enc_x)
        h = torch.cat([enc_x, enc_a * aud_ch_att], dim=-1)

        ambient_eye = None
        face = self.kind == "face"
        if face:
            enc_e, eye_att = _expression(self.exp_encode_net,
                                         self.eye_att_net, enc_x, e)
            h = torch.cat([h, enc_e], dim=-1)
            ambient_eye = _safe_norm(eye_att)

        h = self.sigma_net(h)
        p = self.align_net(enc_x)
        return {
            "d_xyz": h[..., :3] * 1e-2,
            "d_rot": h[..., 3:7],
            "d_opa": h[..., 7:8] if face else None,
            "d_scale": h[..., 8:11] if face else None,
            "ambient_aud": _safe_norm(aud_ch_att),
            "ambient_eye": ambient_eye,
            "p_xyz": p[..., :3] * 1e-2,
            "p_scale": torch.tanh(p[..., 3:] / 5.0) * 0.25 + 1.0,
        }


@torch.no_grad()
def init_motion_params(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``: hash tables U(-1e-4, 1e-4) (the
    grid encoder's init), weights U(+-sqrt(3/fan_in)) (variance 1/fan_in,
    flax's lecun default), biases zero."""
    for name, p in net.named_parameters():
        if name.endswith("embeddings"):
            bound = 1e-4
        elif name.endswith("bias"):
            p.zero_()
            continue
        else:
            fan_in = p.shape[1] * math.prod(p.shape[2:])
            bound = math.sqrt(3.0 / fan_in)
        u = torch.rand(p.shape, generator=generator, dtype=p.dtype)
        p.copy_((u * 2.0 - 1.0) * bound)
    return net
