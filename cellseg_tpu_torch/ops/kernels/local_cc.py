"""Block-local connected-components convergence: CUDA kernel + plain version.

Replaces cellseg_tpu/ops/pallas/local_cc.py:stripe_converge (_kernel,
_sweep3x3_vmem); the kernel is csrc/local_cc.cu. Every full-width row
stripe repeats one round until a round changes nothing in the stripe or
`cap` rounds have run. One round, plain mode: for connectivity 2 a masked
3x3 min sweep (Jacobi, INF beyond the stripe's four edges, INF off the
mask), then the row segmented min-scan over the full width, then the
column segmented min-scan inside the stripe (its top and bottom rows close
the runs). region=True: the row and the column region scans, nothing
masked. The scans are those of scans.py.

Stripe height: the JAX package's (`jax_stripe`, local_cc.py:_h_stripe) is
32 rows at 2176 columns, a 278 KB int32 plane, more than the 227 KB of
shared memory a block of the H100 may have. The kernel keeps a stripe's
labels and mask (5 bytes a pixel) in shared memory for all its rounds, so
the port's route takes `cc_stripe(h, w)`: the largest divisor of h from 8
to the JAX stripe that fits (17 rows at 2176: 128 stripes, one block per
SM in one wave on the H100's 132 SMs; 32 at 1024). The route's outer fixed
point is the component-min plane, which is unique, so the stripe height
changes no label. One call at the JAX stripe is held to the Pallas kernel
by the tests on the CPU; the kernel is held to the plain version on the
card.

Bound on the H100: 9 bytes per pixel must move per launch (labels and
mask in, labels out), against 11 to 20 int32 operations per pixel and
round, so the operations bound it once the stripes run more than about 8
rounds. A stripe is a chain of dependent rounds. Design: one block of
1024 threads per stripe, state in shared memory, every thread on every
pass: column passes by threads that own columns, row passes as a raking
scan (each thread folds a run of adjacent pixels, a warp shuffle scan and
the row's warp totals give each run its carry), a change vote per round.
Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py, three
runs), 2176^2, density 0.5, 16 rounds: 0.42-0.44 ms at connectivity 2,
19x its bound; see csrc/local_cc.cu.

The plain version runs only for CPU tensors; a CUDA tensor goes through
the kernel or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...kernels import build
from .scans import check_inputs, segmented_min_scan_plain
from .sweeps import sweep_min_plain

LAUNCHES = {"stripe_converge": 0}

# dynamic shared memory a block of the H100 may have (227 KB); a stripe
# takes 5 bytes a pixel (int32 label, uint8 mask) after 512 bytes of the
# row scans' warp totals
SMEM_BYTES = 232448
BYTES_PER_PX = 5
SCRATCH_BYTES = 512
# the smallest stripe height the route takes (the JAX package's smallest)
MIN_STRIPE = 8

_SIGNATURES = {
    "cellseg_stripe_converge":
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "cellseg_stripe_converge_occupancy":
        [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def stripe_fits(stripe: int, w: int) -> bool:
    """Whether a stripe's labels and mask fit in a block's shared memory."""
    return BYTES_PER_PX * stripe * w + SCRATCH_BYTES <= SMEM_BYTES


def jax_stripe(h: int, w: int) -> int | None:
    """The JAX package's row-stripe height (local_cc.py:_h_stripe): one
    (stripe, w) int32 plane within 512 KB, a multiple of 8 from 8 to 256
    that divides h; None where there is none."""
    budget = 1 << 19
    stripe = max(8, min(256, budget // (4 * w) // 8 * 8))
    while h % stripe:
        stripe -= 8
        if stripe < 8:
            return None
    return stripe


def cc_stripe(h: int, w: int) -> int | None:
    """The port's row-stripe height: the largest divisor of h from 8 to
    jax_stripe(h, w) whose labels and mask fit in a block's shared memory;
    None where there is none (w above 5,798, or no multiple of 8 divides
    h). At 2176x2176: 17 rows, 128 stripes, one block each on the H100's
    132 SMs."""
    top = jax_stripe(h, w) if w > 0 else None
    if top is None:
        return None
    for stripe in range(top, MIN_STRIPE - 1, -1):
        if h % stripe == 0 and stripe_fits(stripe, w):
            return stripe
    return None


def blocks_per_sm(w: int, stripe: int, connectivity: int = 1,
                  region: bool = False) -> int:
    """Blocks of the kernel resident at once on one SM of the current CUDA
    device for stripes of `stripe` rows of a w-wide plane
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = build.load("local_cc", _SIGNATURES)
    out = ctypes.c_int(0)
    err = lib.cellseg_stripe_converge_occupancy(
        w, stripe, connectivity, int(region), ctypes.addressof(out))
    build.check(lib, err, "cellseg_stripe_converge_occupancy")
    return out.value


def _stripe_of(h: int, w: int, stripe: int | None) -> int:
    if stripe is None:
        stripe = cc_stripe(h, w)
        if stripe is None:
            raise ValueError(f"no row stripe of the port's choice divides a "
                             f"{h}x{w} plane; pass stripe")
    if stripe < 1 or h % stripe:
        raise ValueError(f"stripe={stripe} does not divide H={h}")
    return stripe


def _round_plain(lab: torch.Tensor, m: torch.Tensor, connectivity: int,
                 region: bool) -> torch.Tensor:
    """One round on a batch of stripes (n, stripe, w)."""
    if region:
        lab = segmented_min_scan_plain(lab, m, 2, region=True)
        return segmented_min_scan_plain(lab, m, 1, region=True)
    if connectivity == 2:
        lab = sweep_min_plain(lab, m, 2)
    lab = segmented_min_scan_plain(lab, m, 2)
    return segmented_min_scan_plain(lab, m, 1)


def stripe_converge_plain(lab: torch.Tensor, mask: torch.Tensor,
                          connectivity: int = 1, region: bool = False,
                          cap: int = 16, stripe: int | None = None,
                          rounds: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch: all stripes run their rounds together as a batch; a
    stripe at its fixed point no longer changes, so running them all until
    none changes gives each its own loop's result and round count."""
    h, w = lab.shape
    stripe = _stripe_of(h, w, stripe)
    n = h // stripe
    cur = lab.reshape(n, stripe, w)
    m = mask.reshape(n, stripe, w)
    ran = torch.full((n,), cap, dtype=torch.int32, device=lab.device)
    active = torch.ones(n, dtype=torch.bool, device=lab.device)
    for it in range(cap):
        new = _round_plain(cur, m, connectivity, region)
        moved = (new != cur).flatten(1).any(1)
        ran = torch.where(active & ~moved, it + 1, ran)
        active &= moved
        cur = new
        if not bool(active.any()):
            break
    if rounds is not None:
        rounds.copy_(ran)
    return cur.reshape(h, w)


def stripe_converge(lab: torch.Tensor, mask: torch.Tensor,
                    connectivity: int = 1, region: bool = False,
                    cap: int = 16, stripe: int | None = None,
                    rounds: torch.Tensor | None = None) -> torch.Tensor:
    """Converge every row stripe to its local fixed point (at most `cap`
    rounds); returns the new int32 labels.

    lab: int32 (H, W), INF off the mask in plain mode; mask: bool/uint8
    (H, W), the mask, or in region mode the values whose equal runs are
    the segments. stripe (default cc_stripe(H, W)) must divide H; on the
    card the stripe must fit in a block's shared memory (stripe_fits).
    rounds: optional int32 (H // stripe,) tensor that receives the rounds
    each stripe ran."""
    check_inputs(lab, mask)
    if connectivity not in (1, 2) or cap < 0:
        raise ValueError(f"need connectivity 1 or 2 and cap >= 0, got "
                         f"connectivity={connectivity}, cap={cap}")
    h, w = lab.shape
    stripe = _stripe_of(h, w, stripe)
    if rounds is not None and (rounds.shape != (h // stripe,)
                               or rounds.dtype != torch.int32
                               or rounds.device != lab.device
                               or not rounds.is_contiguous()):
        raise ValueError(f"rounds must be contiguous int32 ({h // stripe},) "
                         f"on {lab.device}")
    if lab.device.type == "cpu":
        return stripe_converge_plain(lab, mask, connectivity, region, cap,
                                     stripe, rounds)
    if not stripe_fits(stripe, w):
        raise ValueError(f"a stripe of {stripe}x{w} does not fit in a "
                         f"block's {SMEM_BYTES} bytes of shared memory")
    lib = build.load("local_cc", _SIGNATURES)
    if h == 0 or w == 0:
        return lab.clone()
    out = torch.empty_like(lab)
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        err = lib.cellseg_stripe_converge(
            lab.data_ptr(), mask.data_ptr(), out.data_ptr(),
            None if rounds is None else rounds.data_ptr(), h, w, stripe,
            connectivity, int(region), cap, stream)
        build.check(lib, err, "cellseg_stripe_converge")
    LAUNCHES["stripe_converge"] += 1
    return out
