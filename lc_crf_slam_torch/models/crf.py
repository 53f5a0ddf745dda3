"""CRF helpers (counterpart of lc_crf_slam_tpu/models/crf.py).

Only `masked_median` is ported so far: tracking's miss-corroboration bar
reads it. The labeler itself (unaries, kNN graph, mean field) is not.
"""

from __future__ import annotations

import torch


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x over mask (upper median; 0 when mask is empty)."""
    s = torch.sort(torch.where(mask, x, float("inf"))).values
    n = torch.sum(mask.to(torch.int32))
    i = torch.clamp(n // 2, 0, x.shape[0] - 1).long()
    v = s.index_select(0, i.reshape(1))[0]
    return torch.where(n > 0, v, 0.0)
