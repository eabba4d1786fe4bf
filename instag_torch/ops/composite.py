"""Fused per-tile Gaussian compositing, forward (counterpart of
instag_tpu/ops/pallas_composite.py's forward).

``composite_fwd`` launches the hand-written CUDA kernel
``csrc/composite_fwd.cu`` on CUDA tensors and runs the plain PyTorch
version ``composite_fwd_plain`` of the same function on CPU tensors.

Contract ([F, T, K], splats on the last axis):
  feats rows 0 px, 1 py, 2 conicA, 3 conicB, 4 conicC, 5 opacity (0 where
  invalid), 6..6+C-1 composited channels, then A aux channels (F may carry
  extra rows, which are ignored); cnt [T] int32 valid counts, valid slots
  being a depth-sorted prefix of K.
Returns channel-major [T, C+2+A, tile*tile]: C accumulated channels, alpha,
T_final, A aux channels. An empty tile gives zeros with T_final = 1.

Per tile-local pixel (x, y) and slot k < cnt, front to back:
power = -1/2 (A dx^2 + C dy^2) - B dx dy; alpha = min(0.99, op e^power),
dropped unless power <= 0 and alpha >= 1/255; the log transmittance
sums log1p(-alpha); a splat contributes iff exp(that sum) >= 1e-4, with
weight T_excl * alpha. T_final integrates the contributing splats only.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
MAX_VALUES = 16          # C + A rows the kernel accumulates per pixel


def _pixel_grid(tile: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    p = torch.arange(tile * tile, device=device)
    return ((p % tile).to(torch.float32), (p // tile).to(torch.float32))


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
    P = tile * tile
    dev = feats.device
    xs, ys = _pixel_grid(tile, dev)
    slot = torch.arange(K, device=dev)
    out = torch.empty((T, nv + 2, P), dtype=torch.float32, device=dev)
    pairs = 0
    step = max(1, (1 << 24) // (P * K))          # tiles per [t, P, K] chunk
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
        alpha = torch.clamp_max(op * torch.exp(power), 0.99)
        live = (slot[None, :] < cnt[t0:t1, None])[:, None, :]
        ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & live
        alpha = torch.where(ok, alpha, torch.zeros((), device=dev))
        log_t = torch.log1p(-alpha)
        t_incl = torch.exp(torch.cumsum(log_t, dim=-1))
        contrib = t_incl >= T_MIN                                 # prefix mask
        w = torch.where(contrib, t_incl * alpha / (1.0 - alpha),
                        torch.zeros((), device=dev))
        vals = f[6:6 + nv]                                        # [nv, c, K]
        acc = torch.einsum("cpk,vck->cvp", w, vals)
        out[t0:t1, :n_chan] = acc[:, :n_chan]
        out[t0:t1, n_chan] = w.sum(-1)
        out[t0:t1, n_chan + 1] = torch.exp(
            torch.where(contrib, log_t, torch.zeros((), device=dev)).sum(-1))
        out[t0:t1, n_chan + 2:] = acc[:, n_chan:]
        if count_pairs:
            n_ok = contrib.sum(-1)                                # [c, P]
            stop = torch.minimum(n_ok + 1,
                                 cnt[t0:t1, None].to(n_ok.dtype))
            pairs += int(stop.sum())
    return (out, pairs) if count_pairs else out


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


def composite_fwd(feats: torch.Tensor, cnt: torch.Tensor, tiles_x: int,
                  n_chan: int, n_aux: int = 0, tile: int = 16) -> torch.Tensor:
    """Per-tile fused composite: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (see module docstring for the contract)."""
    if feats.device.type == "cpu":
        return composite_fwd_plain(feats, cnt, tiles_x, n_chan, n_aux, tile)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    _check(feats, cnt, n_chan, n_aux, tile)
    F, T, K = feats.shape
    out = torch.empty((T, n_chan + 2 + n_aux, tile * tile),
                      dtype=torch.float32, device=feats.device)
    lib = _library()
    err = lib.composite_fwd_launch(
        feats.data_ptr(), cnt.data_ptr(), out.data_ptr(), T, K, tiles_x,
        n_chan, n_aux, torch.cuda.current_stream(feats.device).cuda_stream)
    if err != 0:
        raise RuntimeError("composite_fwd launch failed: "
                           + lib.composite_error_string(err).decode())
    composite_fwd.launches += 1
    return out


composite_fwd.launches = 0


def _library() -> ctypes.CDLL:
    lib = kernels.load("composite_fwd")
    fn = lib.composite_fwd_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.composite_error_string.argtypes = [ctypes.c_int]
        lib.composite_error_string.restype = ctypes.c_char_p
    return lib
