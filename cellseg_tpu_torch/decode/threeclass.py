"""3-class instance decoding: interior probability -> instance labels.

Port of cellseg_tpu/decode/threeclass.py (decode="cc"). Reference chain:
P(interior) > 0.5 -> fill holes < 64 px (4-conn) -> drop objects < 16 px
(4-conn) -> label 8-conn. The device path runs it on the tensor's device;
the host path is the scipy golden.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cc import INF, _propagate, region_roots, sequential_from_ranks
from ..ops.host_morphology import (
    connected_components,
    remove_small_holes,
    remove_small_objects,
)
from ..ops.rank_areas import dense_region_ranks, small_mask_by_rank


def decode_interior_prob(prob_interior: torch.Tensor) -> torch.Tensor:
    """(H, W) interior probability -> (H, W) int32 instance labels.

    One region propagation labels the 4-conn components of the mask and
    of its complement together; dense ranks give both area filters. After
    the hole fill, object components are merged across the filled holes
    by a warm-started propagation, and the surviving ranks seed the final
    8-conn labeling. Bit-identical to the reference chain."""
    mask = prob_interior > 0.5
    roots = region_roots(mask)
    dense, r_plane = dense_region_ranks(roots)

    # hole fill: background 4-conn components with area < 64
    filled = mask | small_mask_by_rank(dense, ~mask, 64)

    # merge object components across the filled holes (ranks are monotone
    # in root index, so the merged component takes its min-root rank)
    merged = _propagate(torch.where(filled, dense, INF), filled,
                        connectivity=1)

    # small-object removal on the filled mask
    mask2 = filled & ~small_mask_by_rank(merged, filled, 16)

    # final 8-conn labeling seeded by the surviving merged ranks
    lab = _propagate(torch.where(mask2, merged, INF), mask2, connectivity=2)
    return sequential_from_ranks(lab, r_plane, roots, mask2)


def decode_interior_prob_host(prob_interior: np.ndarray) -> np.ndarray:
    """Host golden path with identical semantics (scipy.ndimage)."""
    mask = prob_interior > 0.5
    mask = remove_small_holes(mask, area_threshold=64, connectivity=1)
    mask = remove_small_objects(mask, min_size=16, connectivity=1)
    return connected_components(mask, connectivity=2)
