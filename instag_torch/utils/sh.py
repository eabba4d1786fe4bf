"""Real spherical harmonics, degrees 0-8 (counterpart of
instag_tpu/utils/sh.py).

The PlenOctree basis with the (-y, +z, -x) degree-1 sign pattern (real SH
with Condon-Shortley phase, m ordered -l..l). Degrees 0-4 use the hard-coded
polynomials; degrees 5-8 the associated-Legendre recurrence in the same
convention.
"""

from __future__ import annotations

import math

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def sh_basis(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """[..., 3] unit directions -> [..., (deg+1)**2] basis values."""
    assert 0 <= deg <= 8
    if deg > 4:
        return _sh_basis_recurrence(deg, dirs)
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, C0)]
    if deg > 0:
        out += [-C1 * y, C1 * z, -C1 * x]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if deg > 2:
        out += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    if deg > 3:
        out += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1),
            C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3),
            C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def _sh_basis_recurrence(deg: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis for any degree via the associated-Legendre recurrence:
    for m > 0, Y_{l,+-m} = sqrt(2) K(l,m) Q_l^m(z) * {A_m, B_m} with the
    Chebyshev recurrence A_m = x A_{m-1} - y B_{m-1},
    B_m = x B_{m-1} + y A_{m-1}."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    one = torch.ones_like(x)

    def K(l, m):
        return math.sqrt((2 * l + 1) / (4 * math.pi)
                         * math.factorial(l - m) / math.factorial(l + m))

    # Q_l^m(z): P_l^m with the sin^m(theta) factor removed
    Q = {}
    for m in range(0, deg + 1):
        qmm = ((-1) ** m) * math.prod(range(1, 2 * m, 2))  # (-1)^m (2m-1)!!
        Q[(m, m)] = qmm * one
        if m + 1 <= deg:
            Q[(m + 1, m)] = (2 * m + 1) * qmm * z
        for l in range(m + 2, deg + 1):
            Q[(l, m)] = (((2 * l - 1) * z * Q[(l - 1, m)]
                          - (l + m - 1) * Q[(l - 2, m)]) / (l - m))

    A = [one]
    B = [torch.zeros_like(x)]
    for m in range(1, deg + 1):
        A.append(x * A[m - 1] - y * B[m - 1])
        B.append(x * B[m - 1] + y * A[m - 1])

    out = []
    s2 = math.sqrt(2.0)
    for l in range(deg + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            if m == 0:
                out.append(K(l, 0) * Q[(l, 0)])
            elif m > 0:
                out.append(s2 * K(l, am) * Q[(l, am)] * A[am])
            else:
                out.append(s2 * K(l, am) * Q[(l, am)] * B[am])
    return torch.stack(out, dim=-1)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh [..., C, K] (K >= (deg+1)**2) at dirs [..., 3] -> [..., C]."""
    basis = sh_basis(deg, dirs)
    k = basis.shape[-1]
    return torch.einsum("...ck,...k->...c", sh[..., :k], basis)


def rgb2sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / C0


def sh2rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * C0 + 0.5
