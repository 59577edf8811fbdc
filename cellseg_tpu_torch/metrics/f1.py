"""Instance-level F1 with Hungarian IoU matching (stardist-style).

Copy of cellseg_tpu/metrics/f1.py for the port (numpy and scipy only):
`score_pair` and what it is built from, the reference scorer's semantics
(baseline/compute_metric.py:21-133,182-190). The pixel-pair histogram is
one vectorized `np.bincount` over fused pair indices; the JAX package's
optional C++ histogram and the tiled scorer are not carried over.
Hungarian assignment runs on the host (scipy).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def label_overlap(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Pixel-overlap histogram between two label maps.

    Returns ``overlap[i, j]`` = number of pixels with label ``i`` in ``x``
    and label ``j`` in ``y``; shape ``(x.max()+1, y.max()+1)``.
    Parity with reference baseline/compute_metric.py:39-70 (numba loop).
    """
    x = np.ravel(np.asarray(x))
    y = np.ravel(np.asarray(y))
    nx = int(x.max()) + 1 if x.size else 1
    ny = int(y.max()) + 1 if y.size else 1
    fused = x.astype(np.int64) * ny + y.astype(np.int64)
    counts = np.bincount(fused, minlength=nx * ny)
    return counts.reshape(nx, ny)


def intersection_over_union(masks_true: np.ndarray,
                            masks_pred: np.ndarray) -> np.ndarray:
    """IoU of all (true, pred) label pairs; row/col 0 are background.

    Parity with reference baseline/compute_metric.py:21-37.
    """
    overlap = label_overlap(masks_true, masks_pred).astype(np.float64)
    n_pixels_pred = overlap.sum(axis=0, keepdims=True)
    n_pixels_true = overlap.sum(axis=1, keepdims=True)
    denom = n_pixels_pred + n_pixels_true - overlap
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = overlap / denom
    iou[np.isnan(iou)] = 0.0
    return iou


def true_positive(iou: np.ndarray, th: float) -> int:
    """Count of matched pairs with IoU >= th under Hungarian assignment.

    Cost shaping matches reference baseline/compute_metric.py:83-105:
    primary reward for feasible pairs, small IoU tiebreak.
    """
    if iou.size == 0:
        return 0
    n_min = min(iou.shape[0], iou.shape[1])
    costs = -(iou >= th).astype(float) - iou / (2 * n_min)
    true_ind, pred_ind = linear_sum_assignment(costs)
    match_ok = iou[true_ind, pred_ind] >= th
    return int(match_ok.sum())


def eval_tp_fp_fn(masks_true: np.ndarray, masks_pred: np.ndarray,
                  threshold: float = 0.5) -> tuple[int, int, int]:
    """TP/FP/FN instance counts at an IoU threshold.

    Assumes sequentially-relabelled inputs (max == count), like the
    reference call site (baseline/compute_metric.py:107-122,186-190).
    """
    num_inst_gt = int(np.max(masks_true)) if masks_true.size else 0
    num_inst_seg = int(np.max(masks_pred)) if masks_pred.size else 0
    if num_inst_seg > 0:
        iou = intersection_over_union(masks_true, masks_pred)[1:, 1:]
        tp = true_positive(iou, threshold)
        fp = num_inst_seg - tp
        fn = num_inst_gt - tp
    else:
        tp, fp, fn = 0, 0, 0
    return tp, fp, fn


def binary_dice(gt: np.ndarray, seg: np.ndarray) -> float:
    """Binary Dice with the reference's empty-mask conventions
    (baseline/compute_metric.py:72-81)."""
    n_gt = np.count_nonzero(gt)
    n_seg = np.count_nonzero(seg)
    if n_gt == 0 and n_seg == 0:
        return 1.0
    if n_gt == 0 and n_seg > 0:
        return 0.0
    inter = np.count_nonzero(np.logical_and(gt, seg))
    return 2 * inter / (n_gt + n_seg)


def relabel_sequential(labels: np.ndarray) -> np.ndarray:
    """Relabel to 1..K preserving the order of original label values.

    Equivalent to skimage.segmentation.relabel_sequential(labels)[0]
    (used at reference baseline/compute_metric.py:132,186-187).
    """
    labels = np.asarray(labels)
    uniq = np.unique(labels)
    uniq_fg = uniq[uniq > 0]
    lut = np.zeros(int(uniq.max()) + 1 if uniq.size else 1, dtype=np.int32)
    lut[uniq_fg] = np.arange(1, uniq_fg.size + 1, dtype=np.int32)
    return lut[labels]


def remove_boundary_cells(mask: np.ndarray, margin: int = 2) -> np.ndarray:
    """Zero out instances touching a `margin`-pixel image frame, then
    relabel sequentially (reference baseline/compute_metric.py:124-133)."""
    mask = np.asarray(mask)
    h, w = mask.shape
    frame_ids = np.unique(
        np.concatenate([
            mask[:margin, :].ravel(), mask[h - margin:, :].ravel(),
            mask[:, :margin].ravel(), mask[:, w - margin:].ravel(),
        ])
    )
    frame_ids = frame_ids[frame_ids > 0]
    if frame_ids.size:
        mask = np.where(np.isin(mask, frame_ids), 0, mask)
    return relabel_sequential(mask)


def score_pair(gt: np.ndarray, seg: np.ndarray, threshold: float = 0.5,
               count_bd_cells: bool = False) -> dict:
    """Score one (gt, seg) instance-map pair.

    Mirrors the per-image small-image path of the reference main loop
    (baseline/compute_metric.py:179-190,234-241), including boundary-cell
    removal by default.
    """
    dice_score = binary_dice(gt > 0, seg > 0)
    if not count_bd_cells:
        gt = remove_boundary_cells(gt.astype(np.int32))
        seg = remove_boundary_cells(seg.astype(np.int32))
    gt = relabel_sequential(gt)
    seg = relabel_sequential(seg)
    cell_true_num = int(np.max(gt))
    cell_pred_num = int(np.max(seg))
    tp, fp, fn = eval_tp_fp_fn(gt, seg, threshold=threshold)
    return _summarize(cell_true_num, cell_pred_num, tp, fp, fn, dice_score)


def _summarize(cell_true_num, cell_pred_num, tp, fp, fn, dice_score) -> dict:
    if tp == 0:
        precision = recall = f1 = 0.0
    else:
        precision = tp / cell_pred_num
        recall = tp / cell_true_num
        f1 = 2 * (precision * recall) / (precision + recall)
    return {
        "true_num": cell_true_num,
        "pred_num": cell_pred_num,
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "precision": precision,
        "recall": recall,
        "dice": dice_score,
        "f1": f1,
    }
