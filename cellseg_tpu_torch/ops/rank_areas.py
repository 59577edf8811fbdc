"""Per-component areas from dense ranks (port of ops/rank_areas.py).

Ported by semantics. The TPU builds its histograms from one-hot einsums
on the MXU, tiered by rank count with a sort fallback; on the GPU a
bincount over dense ranks plus one gather does the same for any number of
components.
"""

from __future__ import annotations

import torch


def dense_region_ranks(roots: torch.Tensor):
    """Per-pixel dense component rank from a converged region-root plane.

    roots: ops/cc.py:region_roots output. With R = cumsum(is_root) in
    raster order, R is non-decreasing in the linear index, so a
    component's rank is R at its root: one gather. Returns (dense ranks in
    [1, K] as an int32 plane, the R plane)."""
    h, w = roots.shape
    lin = torch.arange(h * w, dtype=torch.int32, device=roots.device)
    flat = roots.reshape(-1)
    r_plane = torch.cumsum(flat == lin, 0, dtype=torch.int32)
    dense = r_plane[flat.long()].view(h, w)
    return dense, r_plane.view(h, w)


def small_mask_by_rank(dense: torch.Tensor, domain: torch.Tensor,
                       threshold: int) -> torch.Tensor:
    """Domain pixels whose component (by dense rank) has fewer than
    `threshold` domain pixels (rank_areas.small_mask_guarded)."""
    ranks = torch.where(domain, dense, 0).long()
    counts = torch.bincount(ranks[domain], minlength=1)
    return domain & (counts[ranks] < threshold)
