"""3-class instance decoding: class probabilities -> instance labels.

Port of cellseg_tpu/decode/threeclass.py. `decode_interior_prob` is the
reference chain: P(interior) > 0.5 -> fill holes < 64 px (4-conn) -> drop
objects < 16 px (4-conn) -> label 8-conn; its host twin is the scipy
golden. `decode_boundary_watershed` splits touching cells: seeds are the
cell cores where P(interior) - P(boundary) > 0.7, grown by a marker
watershed on -P(interior) over the same filtered mask. The device paths
run on the tensor's device; `cc_route` names the route of every CC
propagation in them (ops/cc.py: CC_ROUTES, the same labels either way).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cc import (
    INF,
    _propagate,
    label_components,
    region_roots,
    remove_small_objects_torch,
    sequential_from_ranks,
)
from ..ops.host_morphology import (
    connected_components,
    remove_small_holes,
    remove_small_objects,
)
from ..ops.rank_areas import dense_region_ranks, small_mask_by_rank
from ..ops.watershed import watershed


def _filtered_mask(prob_interior: torch.Tensor, hole_area: int = 64,
                   object_area: int = 16, cc_route: str = "global"):
    """The interior mask with holes < hole_area px filled and objects <
    object_area px dropped (4-conn), i.e. remove_small_objects(
    remove_small_holes(p > 0.5)), plus what the CC decode labels it with:
    (mask, the merged 4-conn ranks, the R plane, the region roots). This
    is the port's only hole fill.

    One region propagation labels the 4-conn components of the mask and
    of its complement together; dense ranks give both area filters. After
    the hole fill, object components are merged across the filled holes
    by a warm-started propagation."""
    mask = prob_interior > 0.5
    roots = region_roots(mask, route=cc_route)
    dense, r_plane = dense_region_ranks(roots)

    # hole fill: background 4-conn components with area < hole_area
    filled = mask | small_mask_by_rank(dense, ~mask, hole_area)

    # merge object components across the filled holes (ranks are monotone
    # in root index, so the merged component takes its min-root rank)
    merged = _propagate(torch.where(filled, dense, INF), filled,
                        connectivity=1, route=cc_route)

    # small-object removal on the filled mask
    mask2 = filled & ~small_mask_by_rank(merged, filled, object_area)
    return mask2, merged, r_plane, roots


def decode_interior_prob(prob_interior: torch.Tensor,
                         cc_route: str = "global") -> torch.Tensor:
    """(H, W) interior probability -> (H, W) int32 instance labels.

    The surviving merged ranks of the filtered mask seed the final 8-conn
    labeling. Bit-identical to the reference chain."""
    mask2, merged, r_plane, roots = _filtered_mask(prob_interior,
                                                   cc_route=cc_route)
    lab = _propagate(torch.where(mask2, merged, INF), mask2, connectivity=2,
                     route=cc_route)
    return sequential_from_ranks(lab, r_plane, roots, mask2)


def boundary_watershed_markers(prob_interior: torch.Tensor,
                               prob_boundary: torch.Tensor,
                               th_seed: float = 0.7,
                               cc_route: str = "global"):
    """(seeds, mask) of the boundary watershed: the filtered interior mask,
    and the 8-conn labels of the cores where P(interior) - P(boundary) >
    th_seed inside it, without cores < 4 px (4-conn)."""
    mask = _filtered_mask(prob_interior, cc_route=cc_route)[0]
    core = ((prob_interior - prob_boundary) > th_seed) & mask
    core = remove_small_objects_torch(core, min_size=4, connectivity=1,
                                      route=cc_route)
    return label_components(core, connectivity=2, route=cc_route), mask


def decode_boundary_watershed(prob_interior: torch.Tensor,
                              prob_boundary: torch.Tensor,
                              th_seed: float = 0.7,
                              route: str = "plain",
                              cc_route: str = "global") -> torch.Tensor:
    """(H, W) interior and boundary probabilities -> (H, W) int32 labels:
    a marker watershed on -P(interior) grows the seeds of
    boundary_watershed_markers over its mask. route: the watershed's
    ("plain", the JAX package's off the TPU, or "stripe", its route on the
    TPU; ops/watershed.py)."""
    seeds, mask = boundary_watershed_markers(prob_interior, prob_boundary,
                                             th_seed, cc_route)
    return watershed(-prob_interior.to(torch.float32), seeds, mask,
                     route=route)


def decode_interior_prob_host(prob_interior: np.ndarray) -> np.ndarray:
    """Host golden path with identical semantics (scipy.ndimage)."""
    mask = prob_interior > 0.5
    mask = remove_small_holes(mask, area_threshold=64, connectivity=1)
    mask = remove_small_objects(mask, min_size=16, connectivity=1)
    return connected_components(mask, connectivity=2)
