"""Port parity: the instance F1 metric against the JAX package's
metrics/f1.py on random label pairs (exact equality: integer counts and
the same float64 arithmetic)."""

import numpy as np
import pytest

from cellseg_tpu.metrics import f1 as jf1
from cellseg_tpu_torch.metrics import f1 as tf1


def _labels(h, w, n, seed):
    """Random overlapping rectangles, relabeled with gaps in the ids."""
    rng = np.random.default_rng(seed)
    lab = np.zeros((h, w), np.int32)
    for i in range(n):
        y, x = rng.integers(0, h), rng.integers(0, w)
        dy, dx = rng.integers(3, 20, 2)
        lab[y:y + dy, x:x + dx] = 3 * i + 1
    return lab


def _pair(seed, n_true=25, n_pred=30):
    gt = _labels(96, 128, n_true, seed)
    # the prediction: the truth shifted, with a few cells dropped, merged
    # or added
    seg = np.roll(gt, (1, -2), axis=(0, 1))
    seg[seg % 7 == 1] = 0
    seg = np.where(_labels(96, 128, n_pred, seed + 50) > 0,
                   _labels(96, 128, n_pred, seed + 50) + 1000, seg)
    return gt, seg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_overlap_iou_and_matching_match_jax(seed):
    gt, seg = _pair(seed)
    gt_s, seg_s = jf1.relabel_sequential(gt), jf1.relabel_sequential(seg)
    np.testing.assert_array_equal(tf1.label_overlap(gt, seg),
                                  jf1.label_overlap(gt, seg))
    iou = tf1.intersection_over_union(gt_s, seg_s)
    np.testing.assert_array_equal(iou, jf1.intersection_over_union(gt_s,
                                                                   seg_s))
    for th in (0.3, 0.5, 0.9):
        assert (tf1.true_positive(iou[1:, 1:], th)
                == jf1.true_positive(iou[1:, 1:], th))
        assert (tf1.eval_tp_fp_fn(gt_s, seg_s, th)
                == jf1.eval_tp_fp_fn(gt_s, seg_s, th))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("count_bd_cells", [False, True])
@pytest.mark.parametrize("threshold", [0.5, 0.75])
def test_score_pair_matches_jax(seed, count_bd_cells, threshold):
    gt, seg = _pair(seed)
    want = jf1.score_pair(gt, seg, threshold, count_bd_cells)
    got = tf1.score_pair(gt, seg, threshold, count_bd_cells)
    assert got == want
    if threshold == 0.5:
        assert 0 < got["f1"] < 1


@pytest.mark.parametrize("case", ["identical", "empty_pred", "both_empty"])
def test_score_pair_edge_cases_match_jax(case):
    gt = _labels(40, 40, 6, seed=9)
    seg = {"identical": gt, "empty_pred": np.zeros_like(gt),
           "both_empty": np.zeros_like(gt)}[case]
    if case == "both_empty":
        gt = np.zeros_like(gt)
    assert tf1.score_pair(gt, seg) == jf1.score_pair(gt, seg)
