"""k fused watershed relaxation sweeps: CUDA kernel + plain version.

Replaces cellseg_tpu/ops/pallas/ws_sweeps.py:fused_ws_sweeps (_kernel,
_relax_vmem); the kernel is csrc/ws_sweeps.cu. The result equals k calls
of ops/watershed.py:relax_once, the 8-neighbour lexicographic minimax
relaxation of the watershed's (cost, hops, label) state over elevation e
and mask.

Bound on the H100: memory for what must move (29 bytes per pixel for all
k sweeps of a launch: 17 in, 12 out), but this first kernel is bound by
shared-memory reads (up to 8 neighbours of 12 bytes per cell per sweep).
Design: 32x32 output tiles loaded with a k-pixel halo into dynamic shared
memory, k Jacobi sweeps there, centre written back; see
csrc/ws_sweeps.cu. One launch does up to 8 sweeps (66,816 bytes of shared
memory); a larger k takes several launches.

The plain version runs only for CPU tensors; a CUDA tensor goes through
the kernel or the call raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...kernels import build
from .scans import INF

LAUNCHES = {"fused_ws_sweeps": 0}
MAX_K_PER_LAUNCH = 8

# padding and "unreached" values of the JAX package's watershed
BIG = 3.0e38
INF_HOPS = INF
SHIFTS_8 = ((-1, 0), (1, 0), (0, -1), (0, 1),
            (-1, -1), (-1, 1), (1, -1), (1, 1))

_SIGNATURE = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def relax_once_plain(cost: torch.Tensor, hops: torch.Tensor,
                     label: torch.Tensor, e: torch.Tensor,
                     mask: torch.Tensor):
    """One 8-neighbour lexicographic relaxation sweep in plain PyTorch
    (ops/watershed.py:relax_once). Planes are (..., H, W): leading
    dimensions are independent images, each padded on its own."""
    h, w = cost.shape[-2:]
    m = mask != 0
    pc = F.pad(cost[None], (1, 1, 1, 1), value=BIG)[0]
    ph = F.pad(hops[None], (1, 1, 1, 1), value=INF_HOPS)[0]
    pl = F.pad(label[None], (1, 1, 1, 1), value=0)[0]
    new_cost, new_hops, new_label = cost, hops, label
    for dy, dx in SHIFTS_8:
        nc = pc[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        nh = ph[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        nl = pl[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        cand = torch.maximum(nc, e)
        # hops count the steps at the path's current max level: a climb
        # to a new max resets them
        cand_h = torch.where(nh == INF_HOPS, INF_HOPS,
                             torch.where(e > nc, 1, nh + 1))
        better = (cand < new_cost) | ((cand == new_cost) & (
            (cand_h < new_hops)
            | ((cand_h == new_hops) & (nl > 0) & (nl < new_label))))
        better = better & m & (nl > 0)
        new_cost = torch.where(better, cand, new_cost)
        new_hops = torch.where(better, cand_h, new_hops)
        new_label = torch.where(better, nl, new_label)
    return new_cost, new_hops, new_label


def fused_ws_sweeps_plain(e, mask, cost, hops, label, k: int):
    for _ in range(k):
        cost, hops, label = relax_once_plain(cost, hops, label, e, mask)
    return cost, hops, label


def _check_inputs(e, mask, cost, hops, label) -> None:
    if e.dim() != 2:
        raise ValueError(f"e must be 2-D, got shape {tuple(e.shape)}")
    for name, t, dtypes in (("e", e, (torch.float32,)),
                            ("mask", mask, (torch.bool, torch.uint8)),
                            ("cost", cost, (torch.float32,)),
                            ("hops", hops, (torch.int32,)),
                            ("label", label, (torch.int32,))):
        if t.shape != e.shape or t.dtype not in dtypes:
            raise ValueError(f"{name} must be {'/'.join(map(str, dtypes))} "
                             f"of shape {tuple(e.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != e.device:
            raise ValueError(f"e on {e.device}, {name} on {t.device}")
        if e.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"the CUDA sweeps need a contiguous {name}")
    if e.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {e.device}")


def fused_ws_sweeps(e: torch.Tensor, mask: torch.Tensor, cost: torch.Tensor,
                    hops: torch.Tensor, label: torch.Tensor, k: int = 8):
    """k watershed relaxation sweeps; returns the new (cost, hops, label).

    e, cost: float32 (H, W); mask: bool/uint8; hops, label: int32."""
    _check_inputs(e, mask, cost, hops, label)
    if k < 1:
        raise ValueError(f"need k >= 1, got k={k}")
    if e.device.type == "cpu":
        return fused_ws_sweeps_plain(e, mask, cost, hops, label, k)
    lib = build.load("ws_sweeps", {"cellseg_fused_ws_sweeps": _SIGNATURE})
    h, w = e.shape
    if h == 0 or w == 0:
        return cost.clone(), hops.clone(), label.clone()
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream(e.device).cuda_stream
        while k > 0:
            step = min(k, MAX_K_PER_LAUNCH)
            out = (torch.empty_like(cost), torch.empty_like(hops),
                   torch.empty_like(label))
            err = lib.cellseg_fused_ws_sweeps(
                e.data_ptr(), mask.data_ptr(), cost.data_ptr(),
                hops.data_ptr(), label.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), out[2].data_ptr(), h, w, step, stream)
            build.check(lib, err, "cellseg_fused_ws_sweeps")
            LAUNCHES["fused_ws_sweeps"] += 1
            cost, hops, label = out
            k -= step
    return cost, hops, label
