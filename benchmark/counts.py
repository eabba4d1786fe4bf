"""The yardstick: the card's published peaks, and the operations and bytes
that the work of a frame or a step needs, counted from shapes and from the
plain reference's counts (never from the program's). Frozen with the
benchmark; copied from ``chip_smoke.py``'s ``bound``, ``kernel_bound``,
``scatter_bound`` and ``bwd_bound``, with the backward counting only the
busy tiles' work.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
PIXELS = 256                     # a 16x16 tile


def bound(bytes_: float, ops: float) -> float:
    """The least seconds for ``bytes_`` moved and ``ops`` fp32 operations."""
    return max(bytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def composite_fwd_bound(valid: int, tiles: int, pairs: int,
                        n_chan: int) -> float:
    """The forward composite's least seconds: each valid slot's used
    feature row (position, conic, opacity and the ``n_chan`` channels)
    read once, each tile's count read once, the output (channels, alpha,
    T_final of each pixel) written once; 26 + 2 C fp32 operations per
    evaluated (pixel, splat) pair (``csrc/composite_fwd.cu``). ``n_chan``
    is what the caller needs: 3 colours in synthesis."""
    bytes_ = 4 * ((6 + n_chan) * valid + tiles + tiles * (n_chan + 2) * PIXELS)
    return bound(bytes_, pairs * (26 + 2 * n_chan))


def composite_bwd_bound(valid: int, busy: int, tiles: int, pairs: int,
                        n_chan: int, n_aux: int, n_feat: int) -> float:
    """The backward composite's least seconds on the busy tiles' work
    alone: each valid slot's feature row and each busy tile's cotangent
    [C + 2 + A, P] read once, the counts read once, each valid slot's
    ``n_feat`` gradient rows written once; per evaluated pair a forward
    recompute (26 + 2 (C + A)) and the gradient terms (23 + 4 C + 2 A).
    The idle tiles' zero rows are not work the inputs need."""
    nv = n_chan + n_aux
    bytes_ = 4 * ((6 + nv) * valid + tiles + busy * (nv + 2) * PIXELS
                  + n_feat * valid)
    return bound(bytes_, pairs * (49 + 6 * n_chan + 4 * n_aux))


def scatter_add_bound(valid: int, tiles: int, n_feat: int,
                      n_splats: int) -> float:
    """The tile -> splat scatter-add's least seconds: each valid slot's
    gradient rows and id read once, the counts read once, the [F, N]
    accumulator written once; one add per valid element."""
    bytes_ = 4 * (n_feat * valid + valid + tiles + n_feat * n_splats)
    return bound(bytes_, n_feat * valid)


# ------------------------------------------------------------ FLOPs
def mlp_flops(dims) -> int:
    """Multiply-adds of a bias-free MLP over one point, times two."""
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def audio_flops(d_in: int) -> int:
    """The audio encoder over an 8-frame window (four stride-2 k=3 convs
    over 16 steps, the 64-64-32 head) and its temporal attention."""
    width = 32 if d_in < 128 else 128
    chans, steps, f = [d_in, width, width, 64, 64], 16, 0
    for a, b in zip(chans[:-1], chans[1:]):
        steps //= 2
        f += 2 * 3 * a * b * steps
    f += 2 * (64 * 64 + 64 * 32)
    f *= 8
    att = [32, 16, 8, 4, 2, 1]
    f += sum(2 * 3 * a * b * 8 for a, b in zip(att[:-1], att[1:])) + 2 * 64
    return f


GRID_FLOPS = 3 * 12 * 12          # 3 planes x 12 levels x a bilinear lookup

# per point: the MLPs of each net (widths as in models/motion.py)
NET_POINT_FLOPS = {
    "face_umf": mlp_flops([36, 32, 32]) + mlp_flops([36, 16, 6])
    + mlp_flops([74, 64, 64, 11]) + 32 + 6 + GRID_FLOPS,
    "face_pmf": mlp_flops([36, 32, 32]) + mlp_flops([36, 16, 6])
    + mlp_flops([74, 32, 32, 11]) + mlp_flops([36, 32, 6]) + 32 + 6
    + GRID_FLOPS,
    "mouth_umf": mlp_flops([71, 32, 32, 7]) + mlp_flops([39, 16, 16, 1])
    + GRID_FLOPS,
    "mouth_pmf": mlp_flops([36, 32, 32]) + mlp_flops([68, 16, 16, 7])
    + mlp_flops([36, 16, 6]) + 32 + GRID_FLOPS,
}
PROJECT_FLOPS = 160               # EWA projection of one splat
SH_FLOPS = {0: 8, 1: 30, 2: 70}   # view direction and the SH sum


def pair_flops(n_chan: int) -> int:
    return 26 + 2 * n_chan


def frame_flops(face_live: int, mouth_live: int, sh_degrees: tuple,
                pairs: int, d_in: int, size: int) -> float:
    """The fused frame's fp32 operations: both branches' motion nets over
    the live splats, four audio encoders, projection and SH colours, the
    composite's evaluated pairs (3 colours), the dilation and fusion."""
    nets = face_live * (NET_POINT_FLOPS["face_umf"]
                        + NET_POINT_FLOPS["face_pmf"]) \
        + mouth_live * (NET_POINT_FLOPS["mouth_umf"]
                        + NET_POINT_FLOPS["mouth_pmf"]) + 4 * audio_flops(d_in)
    raster = face_live * (PROJECT_FLOPS + SH_FLOPS[sh_degrees[0]]) \
        + mouth_live * (PROJECT_FLOPS + SH_FLOPS[sh_degrees[1]])
    # the 13x13 max-pool as two separable passes, and the fusion
    return nets + raster + pairs * pair_flops(3) + size * size * (24 + 12)


def step_flops(live: int, sh_degree: int, pairs: int, d_in: int,
               size: int) -> float:
    """A face adaptation step's fp32 operations at the start of an
    adaptation: the UMF over the live splats, its audio encoder, projection
    and SH, forward and backward (the backward counted as twice the
    forward), the composite's evaluated pairs forward (26 + 2 C) and
    backward (49 + 6 C, 3 colours), and the loss: L1 and SSIM's five
    separable 11-tap blurs, forward and backward."""
    fwd = live * (NET_POINT_FLOPS["face_umf"] + PROJECT_FLOPS
                  + SH_FLOPS[sh_degree]) + audio_flops(d_in)
    comp = pairs * (pair_flops(3) + 49 + 6 * 3)
    loss = 3 * size * size * (5 * 2 * 2 * 11 + 30)
    return 3.0 * fwd + comp + 3.0 * loss
