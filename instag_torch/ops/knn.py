"""kNN initial-scale estimate (counterpart of instag_tpu/ops/knn.py).

``mean_knn_dist2(points)`` is, per point, the mean squared distance to its
k nearest neighbours other than itself: the initial log-scale of a cloud
made from points is log(sqrt(dist2)). It runs once per cloud, so a blocked
brute-force pass is enough: per block of rows, |a|^2 + |b|^2 - 2 a.b as one
matmul (in full float32: ``device.resolve_device`` turns TF32 off), self
distances set to +inf, then the k smallest.
"""

from __future__ import annotations

import torch


def mean_knn_dist2(points: torch.Tensor, k: int = 3,
                   block: int = 4096) -> torch.Tensor:
    """[N, 3] -> [N] mean of the squared distances to the k nearest
    neighbours."""
    n = points.shape[0]
    sq = (points * points).sum(-1)
    cols = torch.arange(n, device=points.device)
    out = []
    for r0 in range(0, n, block):
        rows = points[r0:r0 + block]
        d2 = sq[r0:r0 + block, None] + sq[None, :] - 2.0 * (rows @ points.T)
        d2 = torch.clamp_min(d2, 0.0)
        d2 = torch.where(cols[r0:r0 + block, None] == cols[None, :],
                         torch.full_like(d2, float("inf")), d2)
        out.append(torch.topk(d2, k, dim=-1, largest=False).values.mean(-1))
    return torch.cat(out)
