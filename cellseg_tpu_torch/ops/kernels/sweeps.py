"""k fused masked neighbour-min sweeps: CUDA kernel + plain version.

Replaces cellseg_tpu/ops/pallas/sweeps.py:fused_sweeps (_kernel,
_sweep_vmem); the kernel is csrc/sweeps.cu. The result equals k calls of
ops/cc.py:_sweep_min: each sweep gives every pixel the min over its 3x3
window (connectivity 2) or plus-shaped window (connectivity 1), centre
included and INF beyond the image, then sets unmasked pixels to INF.

Bound on the H100: memory for what must move (9 bytes per pixel for all
k sweeps together), but this first kernel is bound by shared-memory reads
(5 or 9 per cell per sweep). Design: 32x32 output tiles loaded with a
k-pixel halo into shared memory, k Jacobi sweeps there, centre written
back; see csrc/sweeps.cu. One launch does up to 16 sweeps (the halo's
shared-memory budget); a larger k takes several launches.

The plain version runs only for CPU tensors; a CUDA tensor goes through
the kernel or the call raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...kernels import build
from .scans import INF, check_inputs

LAUNCHES = {"fused_sweeps": 0}
MAX_K_PER_LAUNCH = 16

_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p]

_CROSS = ((-1, 0), (1, 0), (0, -1), (0, 1))
_DIAG = ((-1, -1), (-1, 1), (1, -1), (1, 1))


def sweep_min_plain(lab: torch.Tensor, mask: torch.Tensor,
                    connectivity: int) -> torch.Tensor:
    """One masked neighbour-min sweep in plain PyTorch over the last two
    dims (any leading dims are a batch of images)."""
    h, w = lab.shape[-2:]
    padded = F.pad(lab, (1, 1, 1, 1), value=INF)
    shifts = _CROSS + _DIAG if connectivity == 2 else _CROSS
    out = lab
    for dy, dx in shifts:
        out = torch.minimum(
            out, padded[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return torch.where(mask != 0, out, INF)


def fused_sweeps_plain(lab: torch.Tensor, mask: torch.Tensor, k: int,
                       connectivity: int) -> torch.Tensor:
    for _ in range(k):
        lab = sweep_min_plain(lab, mask, connectivity)
    return lab


def fused_sweeps(lab: torch.Tensor, mask: torch.Tensor, k: int = 16,
                 connectivity: int = 2) -> torch.Tensor:
    """k masked neighbour-min sweeps. lab: int32 (H, W); mask: bool/uint8."""
    check_inputs(lab, mask)
    if k < 1 or connectivity not in (1, 2):
        raise ValueError(f"need k >= 1 and connectivity 1 or 2, got "
                         f"k={k}, connectivity={connectivity}")
    if lab.device.type == "cpu":
        return fused_sweeps_plain(lab, mask, k, connectivity)
    lib = build.load("sweeps", {"cellseg_fused_sweeps": _SIGNATURE})
    h, w = lab.shape
    if h == 0 or w == 0:
        return lab.clone()
    src = lab
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        while k > 0:
            step = min(k, MAX_K_PER_LAUNCH)
            dst = torch.empty_like(lab)
            err = lib.cellseg_fused_sweeps(src.data_ptr(), mask.data_ptr(),
                                           dst.data_ptr(), h, w, step,
                                           connectivity, stream)
            build.check(lib, err, "cellseg_fused_sweeps")
            LAUNCHES["fused_sweeps"] += 1
            src = dst
            k -= step
    return src
