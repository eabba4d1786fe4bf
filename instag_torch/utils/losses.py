"""Image losses (counterpart of instag_tpu/utils/losses.py): L1, SSIM with
an 11x11 sigma-1.5 Gaussian window, PSNR and min-max depth normalisation.
"""

from __future__ import annotations

import torch


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - y))


def psnr(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """PSNR over all pixels of one image in [0, 1]."""
    mse = torch.mean((img - gt) ** 2)
    return 20 * torch.log10(1.0 / torch.sqrt(mse))


def _banded(n: int, window_size: int, sigma: float, device) -> torch.Tensor:
    """[n, n] 'same' blur along one axis: the Gaussian taps on the band
    |col - row| <= window_size // 2, zero elsewhere (zero padding)."""
    xs = torch.arange(window_size, dtype=torch.float32,
                      device=device) - window_size // 2
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    idx = torch.arange(n, device=device)
    off = idx[None, :] - idx[:, None]
    k = window_size // 2
    taps = g[torch.clamp(off + k, 0, window_size - 1)]
    return torch.where(off.abs() <= k, taps, torch.zeros_like(taps))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two [C, H, W] images in [0, 1]. The separable blur is
    two banded-matrix products. The variances are clamped at 0 and the
    covariance to +-sqrt(var1 var2 + 1e-12): the blur(x^2) - mu^2 form
    cancels in float32 for large values, and the SSIM ratio is unbounded
    without the clamps."""
    c, h, w = img1.shape
    bw = _banded(w, window_size, 1.5, img1.device)
    bh = _banded(h, window_size, 1.5, img1.device)

    def blur(x):
        y = (x.reshape(c * h, w) @ bw).reshape(c, h, w)
        return torch.einsum("ij,cjw->ciw", bh, y)

    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = torch.clamp_min(blur(img1 * img1) - mu1_sq, 0.0)
    sigma2_sq = torch.clamp_min(blur(img2 * img2) - mu2_sq, 0.0)
    sigma12 = blur(img1 * img2) - mu1_mu2
    bound = torch.sqrt(sigma1_sq * sigma2_sq + 1e-12)
    sigma12 = torch.clamp(sigma12, -bound, bound)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def normalize_depth(depth: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Min-max normalise a depth map."""
    lo, hi = torch.amin(depth), torch.amax(depth)
    return (depth - lo) / (hi - lo + eps)
