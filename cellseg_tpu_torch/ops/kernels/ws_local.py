"""Block-local watershed convergence: CUDA kernel + plain version.

Replaces cellseg_tpu/ops/pallas/ws_local.py:stripe_ws_converge (_kernel);
the kernel is csrc/ws_local.cu. Every full-width row stripe runs the
watershed relaxation (ops/watershed.py:relax_once, neighbours beyond the
stripe being its padding) until one sweep changes nothing in the stripe or
`cap` sweeps have run.

Bound on the H100: 29 bytes per pixel must move per launch (17 in, 12 out)
against 144 operations per masked pixel and sweep, so the operations bound
it at the tens of sweeps a stripe takes. This first kernel is bound by
latency: the stripe's double-buffered state (up to 1.5 MB) lives in global
memory, and one block of 512 threads per stripe, on one SM, walks the
stripe between two barriers per sweep (a change vote each); measured at
2176^2, about 141 us per sweep, 28.6x its bound. See csrc/ws_local.cu.

The plain version runs only for CPU tensors; a CUDA tensor goes through
the kernel or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...kernels import build
from .ws_sweeps import _check_inputs, relax_once_plain

LAUNCHES = {"stripe_ws_converge": 0}

_SIGNATURE = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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
    lib = build.load("ws_local", {"cellseg_stripe_ws_converge": _SIGNATURE})
    if h == 0 or w == 0:
        return cost.clone(), hops.clone(), label.clone()
    out = (torch.empty_like(cost), torch.empty_like(hops),
           torch.empty_like(label))
    tmp = (torch.empty_like(cost), torch.empty_like(hops),
           torch.empty_like(label))
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream(e.device).cuda_stream
        err = lib.cellseg_stripe_ws_converge(
            e.data_ptr(), mask.data_ptr(), cost.data_ptr(), hops.data_ptr(),
            label.data_ptr(), *(t.data_ptr() for t in out + tmp),
            None if sweeps is None else sweeps.data_ptr(), h, w, stripe,
            cap, stream)
        build.check(lib, err, "cellseg_stripe_ws_converge")
    LAUNCHES["stripe_ws_converge"] += 1
    return out
