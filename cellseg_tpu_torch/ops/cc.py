"""Connected-components labeling by label propagation (port of ops/cc.py).

Labels start as linear pixel indices and are lowered to a fixed point by
row/column segmented min-scans (csrc/scans.cu) and, for 8-connectivity
and for slow-converging masks, neighbour-min sweeps (csrc/sweeps.cu). A
fixed point (no pixel changed) is exact convergence, and a component's
converged label is its minimum linear index, i.e. its first pixel in
raster order, so sequential ids reproduce scipy/skimage label order.

Two routes to the same fixed point, on the caller's choice (`route=`):

- "global" (default, the JAX package's route with CELLSEG_LOCALCC unset):
  up to 12 cheap iterations (a 3x3 sweep for 8-conn, the row and column
  scans), then iterations whose 16 sweeps run as one kernel pass.
- "stripe" (the JAX package's block-local route, CELLSEG_LOCALCC=1 in
  cellseg_tpu/ops/cc.py:_propagate and _propagate_region): every row
  stripe converges
  in shared memory (csrc/local_cc.cu), then one full-height column scan
  and, for 8-conn, one global 3x3 sweep cross the stripe edges, until that
  body changes nothing. It is taken on the JAX gate's shapes only
  (`stripe_route_supported`: W a multiple of 128, H of 8, H <= 3072, a
  stripe height that fits); elsewhere the global route runs.

The fixed point is unique (a component's min linear index), so both
routes give the same labels. What the JAX package did only because of TPU
costs is not carried over: the relabel tails here are one cumsum and one
gather instead of a seeded propagation, the area filters are a labeling
plus one bincount instead of sorts, and the coarse-seed route is absent.
Every propagation loop checks convergence on the host once per iteration.
"""

from __future__ import annotations

import torch

from .kernels.local_cc import cc_stripe, stripe_converge
from .kernels.scans import (
    INF,
    col_segmented_min_scan,
    row_segmented_min_scan,
)
from .kernels.sweeps import fused_sweeps

# phase-2 sweeps per propagation iteration (ops/cc.py:_fused_sweeps_config)
FUSED_K = 16
CC_ROUTES = ("global", "stripe")


def check_route(route: str) -> None:
    if route not in CC_ROUTES:
        raise ValueError(f"unknown CC route {route!r}: "
                         f"{' or '.join(CC_ROUTES)}")


def stripe_route_supported(h: int, w: int) -> bool:
    """Whether the stripe route runs on an (h, w) plane: the JAX package's
    gate (local_cc.py:local_cc_supported with scans.py:scans_supported),
    with the port's stripe height. Decided from the shape alone."""
    return (w > 0 and w % 128 == 0 and h % 8 == 0 and h <= 3072
            and cc_stripe(h, w) is not None)


def _lin(h: int, w: int, device) -> torch.Tensor:
    return torch.arange(h * w, dtype=torch.int32, device=device).view(h, w)


def _sweep_min(lab: torch.Tensor, mask: torch.Tensor,
               connectivity: int) -> torch.Tensor:
    """One masked neighbour-min sweep (one pass of the sweeps kernel)."""
    return fused_sweeps(lab, mask, k=1, connectivity=connectivity)


def _segmented_min_scan(lab: torch.Tensor, mask: torch.Tensor,
                        axis: int) -> torch.Tensor:
    """Min label over each masked run along `axis` (1 = rows, 0 = cols)."""
    scan = row_segmented_min_scan if axis == 1 else col_segmented_min_scan
    return scan(lab, mask)


def _region_min_scan(lab: torch.Tensor, m: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """Min label over each run of equal `m` along `axis`."""
    scan = row_segmented_min_scan if axis == 1 else col_segmented_min_scan
    return scan(lab, m, region=True)


def _scan_rows_cols(lab: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return col_segmented_min_scan(row_segmented_min_scan(lab, mask), mask)


def _scan_rows_cols_region(lab: torch.Tensor,
                           m: torch.Tensor) -> torch.Tensor:
    lab = row_segmented_min_scan(lab, m, region=True)
    return col_segmented_min_scan(lab, m, region=True)


def _stripe_body_region(lab: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    lab = stripe_converge(lab, m, region=True)
    return col_segmented_min_scan(lab, m, region=True)


def _changed(new: torch.Tensor, old: torch.Tensor) -> bool:
    return bool(torch.any(new != old))


def _propagate_region(lab: torch.Tensor, m: torch.Tensor,
                      max_iters: int = 1024,
                      route: str = "global") -> torch.Tensor:
    """Propagate labels to the fixed point over 4-conn regions of equal m.

    body(S) == S forces the row and column region scans to be identities:
    every horizontal/vertical neighbour with the same m value already
    shares the pixel's label. On the stripe route the body is the stripe
    convergence (identity covers every horizontal pair: full-width rows)
    then the full-height column region scan (every vertical pair)."""
    check_route(route)
    body = _scan_rows_cols_region
    if route == "stripe" and stripe_route_supported(*lab.shape):
        body = _stripe_body_region
    for _ in range(max_iters):
        new = body(lab, m)
        done = not _changed(new, lab)
        lab = new
        if done:
            break
    return lab


def region_roots(mask: torch.Tensor, max_iters: int = 1024,
                 route: str = "global") -> torch.Tensor:
    """4-conn component roots of the mask AND of its complement, in one
    propagation: every pixel gets the min linear index of its 4-conn
    equal-mask-value component."""
    h, w = mask.shape
    return _propagate_region(_lin(h, w, mask.device), mask, max_iters, route)


def _cheap_body(lab: torch.Tensor, mask: torch.Tensor,
                connectivity: int) -> torch.Tensor:
    """Leading 3x3 sweep for 8-conn, then row/col segmented scans. Every
    step is monotone non-increasing, so a fixed point of the body is a
    fixed point of each step: exact CC for the connectivity."""
    if connectivity == 2:
        lab = _sweep_min(lab, mask, connectivity)
    return _scan_rows_cols(lab, mask)


def _heavy_body(lab: torch.Tensor, mask: torch.Tensor,
                connectivity: int) -> torch.Tensor:
    """FUSED_K sweeps in one kernel pass, then the scans (phase 2)."""
    lab = fused_sweeps(lab, mask, k=FUSED_K, connectivity=connectivity)
    return _scan_rows_cols(lab, mask)


def _stripe_body(lab: torch.Tensor, mask: torch.Tensor,
                 connectivity: int) -> torch.Tensor:
    """The stripe route's body: every stripe to its local fixed point, the
    full-height column scan, and for 8-conn one global 3x3 sweep for the
    diagonal pairs across stripe edges. All steps are non-increasing, so
    a fixed point of the body is exact CC, as for _cheap_body."""
    lab = stripe_converge(lab, mask, connectivity=connectivity)
    lab = col_segmented_min_scan(lab, mask)
    if connectivity == 2:
        lab = _sweep_min(lab, mask, connectivity)
    return lab


def _propagate(lab: torch.Tensor, mask: torch.Tensor, connectivity: int,
               max_iters: int = 1024, cheap_iters: int = 12,
               route: str = "global") -> torch.Tensor:
    """Run label propagation to the exact fixed point.

    Global route, phase 1: up to `cheap_iters` cheap iterations, which
    converge compact cell masks. Phase 2, only for masks still unconverged
    (labyrinths, inverted backgrounds): iterations whose FUSED_K sweeps
    run as one kernel pass. Both phases share the `max_iters` budget. The
    stripe route (on its shapes) has one body instead of two phases."""
    check_route(route)
    if route == "stripe" and stripe_route_supported(*mask.shape):
        for _ in range(max_iters):
            new = _stripe_body(lab, mask, connectivity)
            done = not _changed(new, lab)
            lab = new
            if done:
                break
        return lab
    it = 0
    changed = True
    while changed and it < min(cheap_iters, max_iters):
        new = _cheap_body(lab, mask, connectivity)
        changed = _changed(new, lab)
        lab = new
        it += 1
    while changed and it < max_iters:
        new = _heavy_body(lab, mask, connectivity)
        changed = _changed(new, lab)
        lab = new
        it += 1
    return lab


def label_components(mask: torch.Tensor, connectivity: int = 2,
                     max_iters: int = 1024,
                     route: str = "global") -> torch.Tensor:
    """Label connected components of a bool mask, skimage order 1..K.

    connectivity: 1 -> 4-neighbourhood, 2 -> 8-neighbourhood; route: one
    of CC_ROUTES (module docstring), the same labels either way. Returns
    int32 labels (0 off the mask)."""
    h, w = mask.shape
    lab = torch.where(mask, _lin(h, w, mask.device), INF)
    lab = _propagate(lab, mask, connectivity, max_iters, route=route)
    return sequential_from_roots(lab, mask)


def sequential_from_roots(lab: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Converged root-index labels -> sequential ids 1..K in raster order
    of the roots: a cumsum over root pixels and one gather."""
    h, w = mask.shape
    flat = lab.reshape(-1)
    is_root = (flat == _lin(h, w, mask.device).reshape(-1)) & mask.reshape(-1)
    seq = torch.cumsum(is_root, 0, dtype=torch.int32)
    idx = torch.where(mask.reshape(-1), flat, 0).long()
    return torch.where(mask, seq[idx].view(h, w), 0)


def sequential_from_ranks(lab_ranks: torch.Tensor, r_plane: torch.Tensor,
                          roots: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Sequential 1..K relabel when the converged plane holds dense ranks.

    A pixel represents its final component iff it is a region root whose
    own rank won the merge (lab_ranks == r_plane there). Ranks are
    monotone in the root's linear index, so the id of rank r is the number
    of representatives with rank <= r: cumsum(bincount(...))[rank]."""
    h, w = mask.shape
    is_rep = mask & (roots == _lin(h, w, mask.device)) & (lab_ranks == r_plane)
    ranks = torch.where(mask, lab_ranks, 0).long()
    hist = torch.bincount(ranks[is_rep], minlength=1)
    table = torch.cumsum(hist, 0).to(torch.int32)
    return torch.where(mask, table[ranks], 0)


def remove_small_objects_torch(mask: torch.Tensor, min_size: int = 16,
                               connectivity: int = 1,
                               route: str = "global") -> torch.Tensor:
    """Drop components with area < min_size (remove_small_objects_jax):
    one labeling, then one bincount over the mask's pixels only (the
    background's would all pile onto bin 0)."""
    lab = label_components(mask, connectivity, route=route).long()
    counts = torch.bincount(lab[mask], minlength=1)
    return mask & (counts[lab] >= min_size)
