"""Tiled sliding-window inference (port of cellseg_tpu/infer/sliding_window.py).

MONAI sliding_window_inference semantics as the reference predictor uses
it (roi 256, overlap 0.25, constant blend): tile origins per axis with the
last window clamped flush to the edge, the tile count padded to a multiple
of the batch with duplicates of the last tile that carry no weight, and
optional gaussian blending (sigma = 0.125 * roi, clipped at its minimum).

The arithmetic follows the JAX engine: on a uniform grid the tile outputs
are summed by parity class and multiplied by the reciprocal of the count
canvas; otherwise tiles are accumulated one by one and divided by the
count. `model_fn(tiles)` maps (B, roi, roi, C_in) -> (B, roi, roi, C_out).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def tile_origins(size: int, roi: int, overlap: float = 0.25) -> np.ndarray:
    """1-D tile start offsets: stride roi*(1-overlap), last window clamped
    flush with the image edge."""
    if size <= roi:
        return np.array([0], dtype=np.int32)
    stride = max(int(roi * (1.0 - overlap)), 1)
    n = int(np.ceil((size - roi) / stride)) + 1
    starts = np.minimum(np.arange(n) * stride, size - roi)
    return np.unique(starts).astype(np.int32)


def balanced_sw_batch(n_tiles: int, budget: int = 128) -> int:
    """Per-step tile batch that spreads the tiles evenly over
    ceil(n / budget) steps (duplicate waste < one tile per step), rounded
    up to a multiple of 8 when above 8."""
    n_tiles = max(n_tiles, 1)
    n_steps = -(-n_tiles // budget)
    per = -(-n_tiles // n_steps)
    return min(-(-per // 8) * 8, budget) if per > 8 else per


def _gaussian_importance(roi: int, sigma_scale: float = 0.125) -> np.ndarray:
    """MONAI gaussian importance map, clipped to its minimum positive
    value so no tile pixel has zero weight."""
    sigma = sigma_scale * roi
    center = (roi - 1) / 2.0
    x = np.arange(roi, dtype=np.float64)
    g = np.exp(-0.5 * ((x - center) / sigma) ** 2)
    m = np.outer(g, g)
    m = np.clip(m, m[m > 0].min(), None)
    return m.astype(np.float32)


def tiles_to_canvas(tiles: torch.Tensor, stride: int, roi: int,
                    h_out: int, w_out: int) -> torch.Tensor:
    """Sum overlapping tile outputs onto a canvas.

    tiles: (ny, nx, roi, roi, C) at origins (i*stride, j*stride), roi <=
    2*stride. The 2x2 parity subgrids hold disjoint tiles; each becomes a
    canvas layer by pad + permute + reshape, and the layers are summed in
    the order (0,0), (0,1), (1,0), (1,1), as the JAX engine does."""
    if roi > 2 * stride:
        raise ValueError(f"roi {roi} > 2 * stride {stride}")
    c = tiles.shape[-1]
    cell = 2 * stride
    out = None
    for py in (0, 1):
        for px in (0, 1):
            sub = tiles[py::2, px::2]
            my, mx = sub.shape[0], sub.shape[1]
            if my == 0 or mx == 0:
                continue
            sub = F.pad(sub, (0, 0, 0, cell - roi, 0, cell - roi))
            layer = sub.permute(0, 2, 1, 3, 4).reshape(my * cell, mx * cell, c)
            layer = F.pad(layer, (0, 0, px * stride, 0, py * stride, 0))
            layer = layer[:h_out, :w_out]
            ph, pw = h_out - layer.shape[0], w_out - layer.shape[1]
            if ph or pw:
                layer = F.pad(layer, (0, 0, 0, pw, 0, ph))
            out = layer if out is None else out + layer
    return out


@functools.lru_cache(maxsize=8)  # ~19 MB per entry at 2176^2
def _inv_count_canvas(n_ty: int, n_tx: int, stride: int, roi: int,
                      ph: int, pw: int, mode: str) -> np.ndarray:
    """Reciprocal of the blend-weight canvas of a uniform grid (host,
    float64, rounded to float32 once)."""
    if mode == "gaussian":
        imp = _gaussian_importance(roi).astype(np.float64)
    else:
        imp = np.ones((roi, roi), np.float64)
    cnt = np.zeros((ph, pw), np.float64)
    for iy in range(n_ty):
        for ix in range(n_tx):
            cnt[iy * stride: iy * stride + roi,
                ix * stride: ix * stride + roi] += imp
    return (1.0 / np.maximum(cnt, 1e-8)).astype(np.float32)[..., None]


@functools.lru_cache(maxsize=4)  # ~19 MB of device memory per entry
def _inv_count_on(device: torch.device, *grid) -> torch.Tensor:
    """_inv_count_canvas uploaded once per device and grid (an upload per
    call cost 2 ms of pageable copy at 2176^2 on an H100)."""
    return torch.from_numpy(_inv_count_canvas(*grid)).to(device)


def _forward_tiles(model_fn, image: torch.Tensor, grid: np.ndarray,
                   roi: int, sw_batch: int):
    """Yield (batch of origins, float32 outputs) for sw_batch tiles each."""
    for b in range(0, len(grid), sw_batch):
        orgs = grid[b:b + sw_batch]
        tiles = torch.stack([image[y:y + roi, x:x + roi] for y, x in orgs])
        yield orgs, model_fn(tiles).float()


def sliding_window_inference(model_fn, image: torch.Tensor, roi: int = 256,
                             sw_batch: int = 4, overlap: float = 0.25,
                             out_channels: int = 3,
                             mode: str = "constant") -> torch.Tensor:
    """Whole-image tiled inference.

    image: (H, W, C_in) float tensor. Returns (H, W, out_channels) float32
    blended outputs. Images smaller than roi are zero-padded and cropped
    back."""
    h, w = image.shape[0], image.shape[1]
    ph, pw = max(h, roi), max(w, roi)
    if (ph, pw) != (h, w):
        image = F.pad(image, (0, 0, 0, pw - w, 0, ph - h))

    ys = tile_origins(ph, roi, overlap)
    xs = tile_origins(pw, roi, overlap)
    grid = np.stack(np.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
    n_real = len(grid)
    stride = max(int(roi * (1.0 - overlap)), 1)
    uniform = (roi <= 2 * stride
               and np.array_equal(ys, np.arange(len(ys)) * stride)
               and np.array_equal(xs, np.arange(len(xs)) * stride))
    rem = (-n_real) % sw_batch
    # pad the tile count to a multiple of sw_batch with duplicates of the
    # last tile; they get zero weight (general path) or are dropped
    weights = np.concatenate([np.ones(n_real, np.float32),
                              np.zeros(rem, np.float32)])
    grid = np.concatenate([grid, np.repeat(grid[-1:], rem, 0)])
    dev = image.device
    if mode == "gaussian":
        imp = torch.from_numpy(_gaussian_importance(roi))[..., None].to(dev)
    else:
        imp = None

    if uniform:
        outs = []
        for _, out in _forward_tiles(model_fn, image, grid, roi, sw_batch):
            outs.append(out * imp if imp is not None else out)
        tiles_out = torch.cat(outs)[:n_real]
        acc = tiles_to_canvas(
            tiles_out.reshape(len(ys), len(xs), roi, roi, out_channels),
            stride, roi, ph, pw)
        inv_cnt = _inv_count_on(dev, len(ys), len(xs), stride, roi, ph, pw,
                                mode)
        return (acc * inv_cnt)[:h, :w]

    if imp is None:
        imp = torch.ones((roi, roi, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((ph, pw, out_channels), dtype=torch.float32, device=dev)
    cnt = torch.zeros((ph, pw, 1), dtype=torch.float32, device=dev)
    i = 0
    for orgs, out in _forward_tiles(model_fn, image, grid, roi, sw_batch):
        for j, (y, x) in enumerate(orgs):
            wt = float(weights[i]) * imp
            acc[y:y + roi, x:x + roi] += out[j] * wt
            cnt[y:y + roi, x:x + roi] += wt
            i += 1
    return (acc / torch.clamp(cnt, min=1e-8))[:h, :w]
