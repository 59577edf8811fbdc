"""Block-local watershed convergence: CUDA kernel + plain version.

Replaces cellseg_tpu/ops/pallas/ws_local.py:stripe_ws_converge (_kernel);
the kernel is csrc/ws_local.cu. Every full-width row stripe runs the
watershed relaxation (ops/watershed.py:relax_once, neighbours beyond the
stripe being its padding) until one sweep changes nothing in the stripe or
`cap` sweeps have run.

Bound on the H100: 29 bytes per pixel must move per launch (17 in, 12
out); the operations needed are 18 per masked pixel and neighbour folded
in, every neighbour in the first sweep and then only those that changed
in the sweep before, so the bytes bound it (0.041 ms at 2176^2). A stripe
is a chain of dependent sweeps, so the design shortens one sweep: a
thread-block cluster of 16 blocks per stripe, each block a slab of
columns with its state in shared memory for all sweeps, the slab edges
exchanged through distributed shared memory, one cluster barrier (with the
change vote) per sweep, and warps skip the pixels whose 3x3
neighbourhoods did not change in the last sweep (exact: their state is
already in the buffer being written). Where a block cannot hold a 16th of
a stripe's columns, ws_cluster_size returns 0 and the global-memory
variant runs: one block per stripe, state in global memory. Measured on
an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py): 5.14 ms at 2176^2
from the watershed's initial state, 125x its bound. See
csrc/ws_local.cu.

The plain version runs only for CPU tensors; a CUDA tensor goes through
the kernel or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...kernels import build
from .ws_sweeps import _check_inputs, relax_once_plain

LAUNCHES = {"stripe_ws_converge": 0}

_SIGNATURES = {
    "cellseg_stripe_ws_converge":
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "cellseg_ws_cluster_occupancy": [ctypes.c_int] * 4 + [ctypes.c_void_p],
}

# dynamic shared memory a block of the H100 may have (227 KB)
SMEM_BYTES = 232448
# the thread-block cluster the kernel launches: the H100's non-portable
# maximum, which gives a stripe the most shared memory and SMs
MAX_CLUSTER = 16


def cluster_smem_bytes(stripe: int, cw: int) -> int:
    """Shared memory of one cluster block whose slab is cw columns of a
    stripe: 3 flags, both Jacobi buffers of (cost, hops, label) and both
    dirty planes with a one-cell frame, and the slab's e and mask
    (csrc/ws_local.cu)."""
    return 16 + 26 * (stripe + 2) * (cw + 2) + 5 * stripe * cw


def ws_stripe(h: int, w: int) -> int | None:
    """The JAX package's row-stripe height (ws_local.py:_ws_stripe): one
    (stripe, w) 4-byte plane within 256 KB, a multiple of 8 that divides
    h, at most 128; None where there is none."""
    budget = 1 << 18
    stripe = max(8, min(128, budget // (4 * w) // 8 * 8))
    while h % stripe:
        stripe -= 8
        if stripe < 8:
            return None
    return stripe


def ws_cluster_size(h: int, w: int, stripe: int) -> int:
    """The kernel variant for an (h, w) plane in stripes of `stripe` rows:
    the blocks of the thread-block cluster per stripe, or 0 for the
    global-memory variant: 16 where the slab of one of 16 blocks
    (ceil(w / 16) columns) fits in a block's shared memory, else 0.
    Decided from the shape alone (h enters only through the stripe, which
    divides it)."""
    if cluster_smem_bytes(stripe, -(-w // MAX_CLUSTER)) <= SMEM_BYTES:
        return MAX_CLUSTER
    return 0


def cluster_occupancy(h: int, w: int, stripe: int | None = None) -> int:
    """Clusters of ws_cluster_size(h, w, stripe) blocks resident at once on
    the current CUDA device (cudaOccupancyMaxActiveClusters); 0 where the
    global-memory variant runs."""
    stripe = _stripe_of(h, w, stripe)
    c = ws_cluster_size(h, w, stripe)
    if c == 0:
        return 0
    lib = build.load("ws_local", _SIGNATURES)
    out = ctypes.c_int(0)
    err = lib.cellseg_ws_cluster_occupancy(h, w, stripe, c,
                                           ctypes.addressof(out))
    build.check(lib, err, "cellseg_ws_cluster_occupancy")
    return out.value


def _stripe_of(h: int, w: int, stripe: int | None) -> int:
    if stripe is None:
        stripe = ws_stripe(h, w) if w > 0 else None
        if stripe is None:
            raise ValueError(f"no row stripe of the JAX package's choice "
                             f"divides a {h}x{w} plane; pass stripe")
    if stripe < 1 or h % stripe:
        raise ValueError(f"stripe={stripe} does not divide H={h}")
    return stripe


def stripe_ws_converge_plain(e, mask, cost, hops, label, cap: int = 256,
                             stripe: int | None = None,
                             sweeps: torch.Tensor | None = None):
    """Plain PyTorch: all stripes relax together as a batch of images; a
    stripe at its fixed point no longer changes, so running them all until
    none changes gives each its own loop's result."""
    h, w = e.shape
    stripe = _stripe_of(h, w, stripe)
    n = h // stripe
    e3, m3, c, hp, lb = (t.reshape(n, stripe, w)
                         for t in (e, mask, cost, hops, label))
    ran = torch.full((n,), cap, dtype=torch.int32, device=e.device)
    active = torch.ones(n, dtype=torch.bool, device=e.device)
    for it in range(cap):
        nc, nh, nl = relax_once_plain(c, hp, lb, e3, m3)
        moved = ((nc != c) | (nh != hp) | (nl != lb)).flatten(1).any(1)
        ran = torch.where(active & ~moved, it + 1, ran)
        active &= moved
        c, hp, lb = nc, nh, nl
        if not bool(active.any()):
            break
    if sweeps is not None:
        sweeps.copy_(ran)
    return c.reshape(h, w), hp.reshape(h, w), lb.reshape(h, w)


def stripe_ws_converge(e: torch.Tensor, mask: torch.Tensor,
                       cost: torch.Tensor, hops: torch.Tensor,
                       label: torch.Tensor, cap: int = 256,
                       stripe: int | None = None,
                       sweeps: torch.Tensor | None = None):
    """Relax every row stripe to its local fixed point (at most `cap`
    sweeps); returns the new (cost, hops, label).

    e, cost: float32 (H, W); mask: bool/uint8; hops, label: int32. stripe
    (default: the JAX package's choice for the shape) must divide H.
    sweeps: optional int32 (H // stripe,) tensor that receives the number
    of sweeps each stripe ran."""
    _check_inputs(e, mask, cost, hops, label)
    if cap < 0:
        raise ValueError(f"need cap >= 0, got cap={cap}")
    h, w = e.shape
    stripe = _stripe_of(h, w, stripe)
    if sweeps is not None and (sweeps.shape != (h // stripe,)
                               or sweeps.dtype != torch.int32
                               or sweeps.device != e.device
                               or not sweeps.is_contiguous()):
        raise ValueError(f"sweeps must be contiguous int32 ({h // stripe},) "
                         f"on {e.device}")
    if e.device.type == "cpu":
        return stripe_ws_converge_plain(e, mask, cost, hops, label, cap,
                                        stripe, sweeps)
    lib = build.load("ws_local", _SIGNATURES)
    if h == 0 or w == 0:
        return cost.clone(), hops.clone(), label.clone()
    cluster = ws_cluster_size(h, w, stripe)
    out = (torch.empty_like(cost), torch.empty_like(hops),
           torch.empty_like(label))
    tmp = ((torch.empty_like(cost), torch.empty_like(hops),
            torch.empty_like(label)) if cluster == 0 else (None,) * 3)
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream(e.device).cuda_stream
        err = lib.cellseg_stripe_ws_converge(
            e.data_ptr(), mask.data_ptr(), cost.data_ptr(), hops.data_ptr(),
            label.data_ptr(), *(t.data_ptr() for t in out),
            *(None if t is None else t.data_ptr() for t in tmp),
            None if sweeps is None else sweeps.data_ptr(), h, w, stripe,
            cap, cluster, stream)
        build.check(lib, err, "cellseg_stripe_ws_converge")
    LAUNCHES["stripe_ws_converge"] += 1
    return out
