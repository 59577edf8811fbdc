"""Segmented min-scans along rows and columns: CUDA kernel + plain version.

Replaces cellseg_tpu/ops/pallas/scans.py:row_segmented_min_scan and
col_segmented_min_scan (_row_kernel / _col_kernel -> _segscan_vmem); the
kernel is csrc/scans.cu. Semantics are those of ops/cc.py:
_segmented_min_scan (plain) and _region_min_scan (region=True):

- plain: every masked pixel takes the min label over its maximal masked
  run along the axis, the run's two bordering pixels included (they are
  INF whenever the labels are INF off the mask, as in every caller);
  unmasked pixels become INF;
- region: segments are maximal runs of equal mask value, background runs
  included, and every pixel takes its run's min; nothing is masked.

Bound on the H100: memory, 9 bytes per pixel (int32 labels in, uint8 mask
in, int32 labels out). See csrc/scans.cu for the design. The TPU gates
the column kernel to H <= 3072; this one takes every shape.

The plain version below is the JAX package's Hillis-Steele recurrence
written in PyTorch. It runs only for CPU tensors; a CUDA tensor goes
through the kernel or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from ...kernels import build

INF = 2**31 - 1

# Launches of each kernel since the last reset (plain-version calls are
# not counted).
LAUNCHES = {"row_segmented_min_scan": 0, "col_segmented_min_scan": 0}

_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_C_NAMES = {"row_segmented_min_scan": "cellseg_row_segmented_min_scan",
            "col_segmented_min_scan": "cellseg_col_segmented_min_scan"}


def _shift(x: torch.Tensor, d: int, dim: int, fill) -> torch.Tensor:
    """Shift along `dim` by d (positive = toward higher index), filling."""
    n = x.shape[dim]
    k = min(abs(d), n)
    pad_shape = list(x.shape)
    pad_shape[dim] = k
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    if d > 0:
        return torch.cat([pad, x.narrow(dim, 0, n - k)], dim)
    return torch.cat([x.narrow(dim, k, n - k), pad], dim)


def segmented_min_scan_plain(lab: torch.Tensor, mask: torch.Tensor,
                             dim: int, region: bool = False) -> torch.Tensor:
    """Plain PyTorch segmented min-scan along `dim` (0 = columns, 1 = rows).

    Log-doubling segmented scan, both directions fused, with the same
    fills as ops/cc.py:_segmented_min_scan / _region_min_scan."""
    size = lab.shape[dim]
    if region:
        m = mask.to(torch.int32)
        fo = m == _shift(m, 1, dim, -1)  # -1 never equals a mask value
        bo = m == _shift(m, -1, dim, -1)
    else:
        fo = bo = mask != 0
    fv = bv = lab
    d = 1
    while d < size:
        fv = torch.where(fo, torch.minimum(fv, _shift(fv, d, dim, INF)), fv)
        fo = fo & _shift(fo, d, dim, False)
        bv = torch.where(bo, torch.minimum(bv, _shift(bv, -d, dim, INF)), bv)
        bo = bo & _shift(bo, -d, dim, False)
        d *= 2
    out = torch.minimum(fv, bv)
    if region:
        return out
    return torch.where(mask != 0, out, INF)


def check_inputs(lab: torch.Tensor, mask: torch.Tensor) -> None:
    """Validate a (labels, mask) pair for the scan and sweep wrappers."""
    if lab.dim() != 2 or lab.dtype != torch.int32:
        raise ValueError(f"lab must be a 2-D int32 tensor, got "
                         f"{lab.dtype} {tuple(lab.shape)}")
    if mask.shape != lab.shape or mask.dtype not in (torch.bool,
                                                     torch.uint8):
        raise ValueError(f"mask must be bool/uint8 of shape "
                         f"{tuple(lab.shape)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if mask.device != lab.device:
        raise ValueError(f"lab on {lab.device}, mask on {mask.device}")
    if lab.device.type == "cuda" and not (lab.is_contiguous()
                                          and mask.is_contiguous()):
        raise ValueError("the CUDA scan needs contiguous lab and mask")
    if lab.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {lab.device}")


def _launch(name: str, lab: torch.Tensor, mask: torch.Tensor,
            region: bool) -> torch.Tensor:
    c_name = _C_NAMES[name]
    lib = build.load("scans", {c: _SIGNATURE for c in _C_NAMES.values()})
    out = torch.empty_like(lab)
    h, w = lab.shape
    if h == 0 or w == 0:
        return out
    with torch.cuda.device(lab.device):
        stream = torch.cuda.current_stream(lab.device).cuda_stream
        err = getattr(lib, c_name)(lab.data_ptr(), mask.data_ptr(),
                                   out.data_ptr(), h, w, int(region), stream)
    build.check(lib, err, c_name)
    LAUNCHES[name] += 1
    return out


def row_segmented_min_scan(lab: torch.Tensor, mask: torch.Tensor,
                           region: bool = False) -> torch.Tensor:
    """Segmented min-scan along rows (dim 1). lab: int32 (H, W) with INF
    off the mask; mask: bool/uint8 (H, W)."""
    check_inputs(lab, mask)
    if lab.device.type == "cpu":
        return segmented_min_scan_plain(lab, mask, 1, region)
    return _launch("row_segmented_min_scan", lab, mask, region)


def col_segmented_min_scan(lab: torch.Tensor, mask: torch.Tensor,
                           region: bool = False) -> torch.Tensor:
    """Segmented min-scan along columns (dim 0); see row_segmented_min_scan."""
    check_inputs(lab, mask)
    if lab.device.type == "cpu":
        return segmented_min_scan_plain(lab, mask, 0, region)
    return _launch("col_segmented_min_scan", lab, mask, region)
