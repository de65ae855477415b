"""Mean squared distance to the three nearest neighbours, for model init.

Counterpart of ``gs2d_tpu/ops/knn.py`` (the reference's
``simple_knn._C.distCUDA2``, ``scene/gaussian_model.py:134``): an exact
blockwise search, ‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b over row blocks, then the
three smallest. That form loses digits to cancellation (up to ~1e-4
relative on uniform clouds of a few thousand points, here and in the JAX
package), so the three chosen distances are taken again as Σ(a−b)²,
which agrees with a float64 search to ~1e-7 as the JAX package's native
grid search does. It runs once, at init, in plain torch on the points'
device; memory stays O(N·block).
"""

from __future__ import annotations

import torch


def mean_sq_dist3(points: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """points (N, 3) float32 → (N,) mean of the squared distances to the 3
    nearest other points (inf where fewer than 3 exist)."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    sq = torch.sum(pts * pts, dim=-1)
    cols = torch.arange(n, device=pts.device)
    out = []
    for s in range(0, n, block):
        rows = pts[s:s + block]
        d2 = sq[s:s + block, None] + sq[None, :] - 2.0 * (rows @ pts.T)
        same = cols[s:s + block, None] == cols[None, :]
        d2 = torch.where(same, torch.inf, d2)
        if n < 3:      # fewer than 3 neighbours: the missing ones are inf
            d2 = torch.cat([d2, torch.full((d2.shape[0], 3 - n), torch.inf,
                                           device=pts.device)], dim=1)
        top = torch.topk(d2, 3, dim=1, largest=False)
        nb = pts[torch.clamp(top.indices, max=n - 1)]        # (block, 3, 3)
        exact = torch.sum((rows[:, None, :] - nb) ** 2, dim=-1)
        exact = torch.where(torch.isinf(top.values), torch.inf, exact)
        out.append(torch.mean(exact, dim=-1))
    if not out:
        return torch.zeros(0, dtype=torch.float32, device=pts.device)
    return torch.cat(out)
