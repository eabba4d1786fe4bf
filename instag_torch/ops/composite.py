"""Fused per-tile Gaussian compositing, forward and backward (counterpart
of instag_tpu/ops/pallas_composite.py).

``composite_fwd`` and ``composite_bwd`` launch the hand-written CUDA
kernels ``csrc/composite_fwd.cu`` and ``csrc/composite_bwd.cu`` on CUDA
tensors and run their plain PyTorch versions ``composite_fwd_plain`` and
``composite_bwd_plain`` on CPU tensors. ``CompositeFunction`` joins the two
as one differentiable operation.

Contract ([F, T, K], splats on the last axis):
  feats rows 0 px, 1 py, 2 conicA, 3 conicB, 4 conicC, 5 opacity (0 where
  invalid), 6..6+C-1 composited channels, then A aux channels (F may carry
  extra rows, which are ignored); cnt [T] int32 valid counts, valid slots
  being a depth-sorted prefix of K.
Returns channel-major [T, C+2+A, tile*tile]: C accumulated channels, alpha,
T_final, A aux channels. An empty tile gives zeros with T_final = 1.
The backward takes the cotangent g of that output and returns dfeats
[F, T, K]: zero in rows past 6+C+A and in slots that do not contribute.

Per tile-local pixel (x, y) and slot k < cnt, front to back:
power = -1/2 (A dx^2 + C dy^2) - B dx dy; alpha = min(0.99, op e^power),
dropped unless power <= 0 and alpha >= 1/255; the log transmittance
sums log1p(-alpha); a splat contributes iff exp(that sum) >= 1e-4, with
weight T_excl * alpha. T_final integrates the contributing splats only.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from ..utils.spans import span

ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
MAX_VALUES = 16          # C + A rows the kernel accumulates per pixel


def _pixel_grid(tile: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    p = torch.arange(tile * tile, device=device)
    return ((p % tile).to(torch.float32), (p // tile).to(torch.float32))


class _Chunk(NamedTuple):
    """The front-to-back chain of tiles t0:t1 over [c, P, K] (pixels, slots)."""
    t0: int
    t1: int
    f: torch.Tensor         # [F, c, K] feature rows
    dx: torch.Tensor        # pixel minus splat centre, tile-local
    dy: torch.Tensor
    pre: torch.Tensor       # op e^power, before the 0.99 clamp
    ok: torch.Tensor        # power <= 0, alpha >= 1/255, slot < cnt
    alpha: torch.Tensor     # 0 where not ok
    log_t: torch.Tensor     # log1p(-alpha)
    t_incl: torch.Tensor    # transmittance after the slot
    contrib: torch.Tensor   # t_incl >= 1e-4 (a prefix of K)
    w: torch.Tensor         # T_excl alpha where contrib, else 0


def _chunks(feats: torch.Tensor, cnt: torch.Tensor, tiles_x: int, tile: int):
    """The chain per chunk of tiles, sized to keep [c, P, K] near 2^24."""
    F, T, K = feats.shape
    dev = feats.device
    xs, ys = _pixel_grid(tile, dev)
    slot = torch.arange(K, device=dev)
    zero = torch.zeros((), device=dev)
    step = max(1, (1 << 24) // (tile * tile * K))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        f = feats[:, t0:t1].to(torch.float32)                    # [F, c, K]
        tid = torch.arange(t0, t1, device=dev)
        txf = ((tid % tiles_x) * tile).to(torch.float32)[:, None]
        tyf = ((tid // tiles_x) * tile).to(torch.float32)[:, None]
        gx = (f[0] - txf)[:, None, :]                            # [c, 1, K]
        gy = (f[1] - tyf)[:, None, :]
        ca, cb, cc = f[2][:, None, :], f[3][:, None, :], f[4][:, None, :]
        op = f[5][:, None, :]
        dx = xs[None, :, None] - gx                               # [c, P, K]
        dy = ys[None, :, None] - gy
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        pre = op * torch.exp(power)
        alpha = torch.clamp_max(pre, 0.99)
        live = (slot[None, :] < cnt[t0:t1, None])[:, None, :]
        ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & live
        alpha = torch.where(ok, alpha, zero)
        log_t = torch.log1p(-alpha)
        t_incl = torch.exp(torch.cumsum(log_t, dim=-1))
        contrib = t_incl >= T_MIN                                 # prefix mask
        w = torch.where(contrib, t_incl * alpha / (1.0 - alpha), zero)
        yield _Chunk(t0, t1, f, dx, dy, pre, ok, alpha, log_t, t_incl,
                     contrib, w)


def composite_fwd_plain(feats: torch.Tensor, cnt: torch.Tensor, tiles_x: int,
                        n_chan: int, n_aux: int = 0, tile: int = 16,
                        count_pairs: bool = False):
    """Plain PyTorch version of the kernel (same contract, any device).

    With ``count_pairs`` also returns the number of (pixel, splat) pairs a
    front-to-back walk must evaluate: per pixel, the slots up to and
    including its first non-contributing one (or cnt).
    """
    F, T, K = feats.shape
    nv = n_chan + n_aux
    out = torch.empty((T, nv + 2, tile * tile), dtype=torch.float32,
                      device=feats.device)
    pairs = 0
    for ch in _chunks(feats, cnt, tiles_x, tile):
        t0, t1, w = ch.t0, ch.t1, ch.w
        acc = torch.einsum("cpk,vck->cvp", w, ch.f[6:6 + nv])
        out[t0:t1, :n_chan] = acc[:, :n_chan]
        out[t0:t1, n_chan] = w.sum(-1)
        out[t0:t1, n_chan + 1] = torch.exp(
            torch.where(ch.contrib, ch.log_t, torch.zeros_like(w)).sum(-1))
        out[t0:t1, n_chan + 2:] = acc[:, n_chan:]
        if count_pairs:
            n_ok = ch.contrib.sum(-1)                             # [c, P]
            stop = torch.minimum(n_ok + 1,
                                 cnt[t0:t1, None].to(n_ok.dtype))
            pairs += int(stop.sum())
    return (out, pairs) if count_pairs else out


def composite_bwd_plain(feats: torch.Tensor, cnt: torch.Tensor,
                        g: torch.Tensor, tiles_x: int, n_chan: int,
                        n_aux: int = 0, tile: int = 16) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: the analytic VJP of
    ``composite_fwd`` for the cotangent ``g`` [T, C+2+A, P] of its output.

    Term for term as instag_tpu/ops/pallas_composite.py:_bwd_kernel, for
    pixel p and slot i (front to back):
      G_i      = sum_c g_c chan_ci + g_alpha        (aux rows excluded)
      S_i      = sum_{j>i} G_j w_j
      dalpha_i = [contrib] (G_i T_excl_i - (S_i + g_T T_final) / (1 - alpha_i))
      dpow_i   = dalpha_i op e^power where ok and op e^power < 0.99, else 0
    and summed over the tile's pixels: d(px, py) from the dpow-weighted
    offsets, d conic from their second moments, d op = sum(dpow) / op, and
    d chan_c = sum(g_c w). Aux rows get sum(g_aux w) and add nothing to
    dalpha: their weights are stop-gradient.
    """
    F, T, K = feats.shape
    nv = n_chan + n_aux
    dfeats = torch.zeros((F, T, K), dtype=torch.float32, device=feats.device)
    for ch in _chunks(feats, cnt, tiles_x, tile):
        t0, t1, f, w = ch.t0, ch.t1, ch.f, ch.w
        gt = g[t0:t1].to(torch.float32)                           # [c, nv+2, P]
        zero = torch.zeros_like(w)
        one_m = 1.0 - ch.alpha
        t_excl = ch.t_incl / one_m
        t_final = torch.exp(torch.where(ch.contrib, ch.log_t, zero).sum(-1))
        btf = (gt[:, n_chan + 1] * t_final)[:, :, None]           # [c, P, 1]
        G = (torch.einsum("cvp,vck->cpk", gt[:, :n_chan], f[6:6 + n_chan])
             + gt[:, n_chan][:, :, None])                         # dL/dw
        Gw = G * w
        # S_i = sum_{j>i} Gw_j: the suffix sum one slot on, no subtraction
        suffix = torch.flip(torch.cumsum(torch.flip(Gw, [-1]), -1), [-1])
        S = torch.cat([suffix[..., 1:], zero[..., :1]], dim=-1)
        dalpha = torch.where(ch.contrib, G * t_excl - (S + btf) / one_m, zero)
        dpow = torch.where(ch.ok & (ch.pre < 0.99), dalpha * ch.pre, zero)
        dx, dy = ch.dx, ch.dy
        m1 = dpow.sum(1)                                          # [c, K]
        mx = (dpow * dx).sum(1)
        my = (dpow * dy).sum(1)
        ca, cb, cc, op = f[2], f[3], f[4], f[5]
        out = dfeats[:, t0:t1]
        out[0] = ca * mx + cb * my
        out[1] = cc * my + cb * mx
        out[2] = -0.5 * (dpow * dx * dx).sum(1)
        out[3] = -(dpow * dx * dy).sum(1)
        out[4] = -0.5 * (dpow * dy * dy).sum(1)
        out[5] = torch.where(op > 0.0, m1 / torch.clamp_min(op, 1e-20),
                             torch.zeros_like(op))
        vrows = torch.cat([gt[:, :n_chan], gt[:, n_chan + 2:]], dim=1)
        out[6:6 + nv] = torch.einsum("cvp,cpk->vck", vrows, w)
    return dfeats


def _check(feats: torch.Tensor, cnt: torch.Tensor, n_chan: int, n_aux: int,
           tile: int):
    if feats.dtype != torch.float32 or not feats.is_contiguous():
        raise ValueError("feats must be contiguous float32 [F, T, K]")
    if cnt.dtype != torch.int32 or not cnt.is_contiguous():
        raise ValueError("cnt must be contiguous int32 [T]")
    if cnt.device != feats.device:
        raise ValueError("feats and cnt must share a device")
    F, T, K = feats.shape
    if cnt.shape != (T,):
        raise ValueError(f"cnt shape {tuple(cnt.shape)} != ({T},)")
    if tile != 16:
        raise ValueError("the kernel composites 16x16 tiles")
    if not 1 <= n_chan + n_aux <= MAX_VALUES or F < 6 + n_chan + n_aux:
        raise ValueError(f"bad channel counts C={n_chan} A={n_aux} for F={F}")


_P, _I = ctypes.c_void_p, ctypes.c_int


def composite_fwd(feats: torch.Tensor, cnt: torch.Tensor, tiles_x: int,
                  n_chan: int, n_aux: int = 0, tile: int = 16) -> torch.Tensor:
    """Per-tile fused composite: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see module docstring for the contract). On the
    card one call launches csrc/composite_fwd.cu's pair of kernels (the
    split kernel and its programmatic dependent), counted as one launch."""
    if feats.device.type == "cpu":
        return composite_fwd_plain(feats, cnt, tiles_x, n_chan, n_aux, tile)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    _check(feats, cnt, n_chan, n_aux, tile)
    F, T, K = feats.shape
    out = torch.empty((T, n_chan + 2 + n_aux, tile * tile),
                      dtype=torch.float32, device=feats.device)
    kernels.launch("composite_fwd", [_P, _P, _P, _I, _I, _I, _I, _I, _P],
                   feats.data_ptr(), cnt.data_ptr(), out.data_ptr(), T, K,
                   tiles_x, n_chan, n_aux,
                   torch.cuda.current_stream(feats.device).cuda_stream)
    composite_fwd.launches += 1
    return out


composite_fwd.launches = 0


def composite_bwd(feats: torch.Tensor, cnt: torch.Tensor, g: torch.Tensor,
                  tiles_x: int, n_chan: int, n_aux: int = 0,
                  tile: int = 16) -> torch.Tensor:
    """The composite's backward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``feats``, ``cnt`` are the forward's inputs and
    ``g`` [T, C+2+A, tile*tile] the cotangent of its output; returns
    dfeats [F, T, K]."""
    if feats.device.type == "cpu":
        return composite_bwd_plain(feats, cnt, g, tiles_x, n_chan, n_aux,
                                   tile)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    _check(feats, cnt, n_chan, n_aux, tile)
    F, T, K = feats.shape
    if g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("g must be contiguous float32 [T, C+2+A, P]")
    if g.device != feats.device or g.shape != (T, n_chan + 2 + n_aux,
                                               tile * tile):
        raise ValueError(f"g shape {tuple(g.shape)} on {g.device} does not "
                         f"match the forward's output")
    dfeats = torch.empty_like(feats)
    kernels.launch("composite_bwd",
                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                   feats.data_ptr(), cnt.data_ptr(), g.data_ptr(),
                   dfeats.data_ptr(), F, T, K, tiles_x, n_chan, n_aux,
                   torch.cuda.current_stream(feats.device).cuda_stream)
    composite_bwd.launches += 1
    return dfeats


composite_bwd.launches = 0


class CompositeFunction(torch.autograd.Function):
    """``composite_fwd`` with ``composite_bwd`` as its gradient with respect
    to ``feats`` (``cnt`` is not differentiable)."""

    @staticmethod
    def forward(ctx, feats, cnt, tiles_x: int, n_chan: int, n_aux: int,
                tile: int = 16):
        ctx.save_for_backward(feats, cnt)
        ctx.static = (tiles_x, n_chan, n_aux, tile)
        with span("composite.fwd"):
            return composite_fwd(feats, cnt, tiles_x, n_chan, n_aux, tile)

    @staticmethod
    def backward(ctx, g):
        feats, cnt = ctx.saved_tensors
        with span("composite.bwd"):
            dfeats = composite_bwd(feats, cnt, g.contiguous(), *ctx.static)
        return dfeats, None, None, None, None, None
