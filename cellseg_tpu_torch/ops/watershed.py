"""Marker-based minimax-path watershed (port of ops/watershed.py).

Each masked pixel goes to the marker with the lexicographically least
(minimax path elevation, steps at that maximum, marker id), found by
8-neighbour relaxation to a fixed point. The JAX package has two routes to
a fixed point, and where (cost, hops) tie they can reach different ones;
the port runs either, on the caller's choice:

- "plain" (default): `relax_once` until nothing changes, the route of
  every JAX run off the TPU and of every JAX test. On the card the sweeps
  are the fused sweeps kernel (csrc/ws_sweeps.cu), up to 8 per launch,
  bit-equal to as many `relax_once` calls.
- "stripe": the JAX package's route on the TPU (ops/pallas/ws_local.py):
  each row stripe relaxes to its own fixed point (csrc/ws_local.cu), then
  one global `relax_once` carries fronts across the stripe edges, until
  that pair changes nothing. It needs the TPU's shapes (W a multiple of
  128, H of 8, a stripe height that divides H); on other shapes the TPU,
  and the port, take the plain route.

`watershed_plain` is the same in plain PyTorch on any device, the
reference the card's kernels are held to. `watershed_host` is the
sequential golden (heapq priority flood with skimage's (value, age)
order), copied from the JAX package.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from .kernels.ws_local import (
    stripe_ws_converge,
    stripe_ws_converge_plain,
    ws_stripe,
)
from .kernels.ws_sweeps import (
    BIG,
    INF_HOPS,
    MAX_K_PER_LAUNCH,
    fused_ws_sweeps,
    fused_ws_sweeps_plain,
)

ROUTES = ("plain", "stripe")


def relax_once(cost: torch.Tensor, hops: torch.Tensor, label: torch.Tensor,
               e: torch.Tensor, mask: torch.Tensor):
    """One 8-neighbour lexicographic relaxation sweep (one pass of the
    fused sweeps kernel)."""
    return fused_ws_sweeps(e, mask, cost, hops, label, k=1)


def stripe_route_supported(h: int, w: int) -> bool:
    """Whether the JAX package takes the stripe route on the TPU for an
    (h, w) plane (ws_local.py:ws_local_supported)."""
    return (w > 0 and w % 128 == 0 and h % 8 == 0
            and ws_stripe(h, w) is not None)


def _changed(a, b) -> bool:
    return bool(torch.any((a[2] != b[2]) | (a[1] != b[1]) | (a[0] != b[0])))


def _flood(image, markers, mask, max_iters, route, converge, sweeps):
    if route not in ROUTES:
        raise ValueError(f"unknown watershed route {route!r}: "
                         f"{' or '.join(ROUTES)}")
    mask = mask != 0
    e = torch.where(mask, image.to(torch.float32), BIG)
    seeded = markers > 0
    state = (torch.where(seeded, e, BIG),
             torch.where(seeded, 0, INF_HOPS).to(torch.int32),
             torch.where(seeded, markers.to(torch.int32), 0))
    if route == "stripe" and stripe_route_supported(*e.shape):
        # one outer iteration: every stripe to its local fixed point, then
        # one global sweep across the stripe edges; a pass that changes
        # nothing is a fixed point of relax_once, as on the plain route
        for _ in range(max_iters):
            new = sweeps(e, mask, *converge(e, mask, *state), 1)
            done = not _changed(new, state)
            state = new
            if done:
                break
    else:
        it = 0
        while it < max_iters:
            k = min(MAX_K_PER_LAUNCH, max_iters - it)
            new = sweeps(e, mask, *state, k)
            done = not _changed(new, state)
            state = new
            it += k
            if done:
                break
    return torch.where(mask, state[2], 0)


def watershed(image: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor,
              max_iters: int = 512, route: str = "plain") -> torch.Tensor:
    """Minimax-path watershed with first-arrival plateau splitting.

    image: (H, W) elevation (lower floods first, e.g. -interior
    probability); markers: (H, W) integer seed labels (0 = none); mask:
    (H, W) bool region to label; route: "plain" or "stripe" (module
    docstring). max_iters bounds the sweeps of the plain route, checked
    once per launch (the last launch is cut to the budget, and sweeps past
    the fixed point change nothing), and the outer iterations of the
    stripe route, as in the JAX package. Returns int32 labels, 0 off the
    mask."""
    return _flood(image, markers, mask, max_iters, route,
                  stripe_ws_converge, fused_ws_sweeps)


def watershed_plain(image: torch.Tensor, markers: torch.Tensor,
                    mask: torch.Tensor, max_iters: int = 512,
                    route: str = "plain") -> torch.Tensor:
    """`watershed` through the kernels' plain versions, on any device."""
    return _flood(image, markers, mask, max_iters, route,
                  stripe_ws_converge_plain, fused_ws_sweeps_plain)


def watershed_host(image: np.ndarray, markers: np.ndarray,
                   mask: np.ndarray) -> np.ndarray:
    """Sequential priority-flood watershed (skimage-order golden)."""
    h, w = image.shape
    labels = np.where(mask, markers.astype(np.int64), 0)
    heap: list[tuple[float, int, int, int]] = []
    age = 0
    ys, xs = np.nonzero((markers > 0) & mask)
    for y, x in zip(ys, xs):
        heapq.heappush(heap, (float(image[y, x]), age, int(y), int(x)))
        age += 1
    in_queue = np.zeros((h, w), dtype=bool)
    in_queue[ys, xs] = True
    while heap:
        _, _, y, x = heapq.heappop(heap)
        lab = labels[y, x]
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                ny, nx = y + dy, x + dx
                if not (0 <= ny < h and 0 <= nx < w):
                    continue
                if not mask[ny, nx] or labels[ny, nx] or in_queue[ny, nx]:
                    continue
                labels[ny, nx] = lab
                in_queue[ny, nx] = True
                heapq.heappush(
                    heap, (float(image[ny, nx]), age, ny, nx)
                )
                age += 1
    return labels
