"""Small neural blocks: MLP, audio feature extractors, audio attention
(counterpart of instag_tpu/models/nets.py).

Submodule names follow the flax modules (``net_0``, ``conv_0``, ``fc_0``,
``att_conv_0``, ``att_fc``) so weights carry across by a mechanical rename
(io/from_jax.py). Layouts are PyTorch's: Conv1d over [B, C, T].
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as Fn


class MLP(nn.Module):
    """Bias-free ReLU MLP."""

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int,
                 num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for layer in range(num_layers):
            d_in = dim_in if layer == 0 else dim_hidden
            d_out = dim_out if layer == num_layers - 1 else dim_hidden
            setattr(self, f"net_{layer}", nn.Linear(d_in, d_out, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in range(self.num_layers):
            x = getattr(self, f"net_{layer}")(x)
            if layer != self.num_layers - 1:
                x = Fn.relu(x)
        return x


class AudioNet(nn.Module):
    """Temporal conv encoder: [B, dim_in, 16] -> [B, dim_aud]. Four stride-2
    Conv1d (k=3, pad 1) + LeakyReLU(0.02), then a 64 -> 64 -> dim_aud head."""

    def __init__(self, dim_in: int = 29, dim_aud: int = 32,
                 win_size: int = 16):
        super().__init__()
        self.win_size = win_size
        width = 32 if dim_in < 128 else 128
        chans = [dim_in, width, width, 64, 64]
        for i in range(4):
            setattr(self, f"conv_{i}", nn.Conv1d(chans[i], chans[i + 1], 3,
                                                 stride=2, padding=1))
        self.fc_0 = nn.Linear(64, 64)
        self.fc_1 = nn.Linear(64, dim_aud)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half_w = self.win_size // 2
        x = x[:, :, 8 - half_w: 8 + half_w]      # central window
        for i in range(4):
            x = Fn.leaky_relu(getattr(self, f"conv_{i}")(x), 0.02)
        x = x[:, :, 0]                           # T collapsed 16->8->4->2->1
        x = Fn.leaky_relu(self.fc_0(x), 0.02)
        return self.fc_1(x)


class AudioAttNet(nn.Module):
    """Temporal attention over an 8-frame window: [1, seq, dim] -> [1, dim].
    The conv stack squeezes channels dim->16->8->4->2->1, then a softmax
    over the sequence weighs the frames."""

    def __init__(self, dim_aud: int = 32, seq_len: int = 8):
        super().__init__()
        self.seq_len = seq_len
        chans = [dim_aud, 16, 8, 4, 2, 1]
        for i in range(5):
            setattr(self, f"att_conv_{i}", nn.Conv1d(chans[i], chans[i + 1], 3,
                                                     stride=1, padding=1))
        self.att_fc = nn.Linear(seq_len, seq_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.transpose(1, 2)                    # [1, dim, seq]
        for i in range(5):
            y = Fn.leaky_relu(getattr(self, f"att_conv_{i}")(y), 0.02)
        y = self.att_fc(y.reshape(1, self.seq_len))
        y = torch.softmax(y, dim=1).reshape(1, self.seq_len, 1)
        return torch.sum(y * x, dim=1)


class AudioNetAVE(nn.Module):
    """AVE feature head: [B, 1, 512] -> 256 -> 128 -> [B, dim_aud] with
    LeakyReLU(0.02)."""

    def __init__(self, dim_aud: int = 32):
        super().__init__()
        self.dim_aud = dim_aud
        self.fc_0 = nn.Linear(512, 256)
        self.fc_1 = nn.Linear(256, 128)
        self.fc_2 = nn.Linear(128, dim_aud)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = Fn.leaky_relu(self.fc_0(x), 0.02)
        x = Fn.leaky_relu(self.fc_1(x), 0.02)
        return self.fc_2(x).reshape(x.shape[0], self.dim_aud)
