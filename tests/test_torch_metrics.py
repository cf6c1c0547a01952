"""The port's eval metrics against the JAX package's (``train/metrics.py``),
on seeded random label vectors: -1 background, predicted ids with gaps,
more predicted segments than true ones and the reverse, spline classes
6-9.  Results must be exact."""

import numpy as np
import pytest
import torch

from gcanet_tpu.train import metrics as jmetrics
from gcanet_tpu_torch.train import metrics as tmetrics
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)


def _case(seed: int, n: int, n_pred: int, n_gt: int, bg: float, gaps: bool):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, n_pred, n).astype(np.int32)
    if gaps:                                   # ids with no point
        pred = pred * 3
    i_gt = rng.integers(0, n_gt, n).astype(np.int32)
    i_gt[rng.random(n) < bg] = -1
    # segments that follow the truth on most points
    follow = rng.random(n) < 0.7
    pred[follow] = np.maximum(i_gt[follow], 0) % n_pred * (3 if gaps else 1)
    t_gt = rng.integers(0, 10, n).astype(np.int32)
    scores = rng.standard_normal((n, 10)).astype(np.float32)
    return pred, i_gt, t_gt, scores


CASES = {
    "background": (0, 500, 6, 6, 0.2, False),
    "no_background": (1, 400, 5, 5, 0.0, False),
    "more_pred": (2, 300, 12, 4, 0.1, False),
    "more_gt": (3, 300, 3, 11, 0.1, False),
    "empty_pred_ids": (4, 300, 5, 6, 0.1, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_metrics_match_jax(name):
    pred, i_gt, t_gt, scores = _case(*CASES[name])
    one_p, one_g = tmetrics._one_hots(pred, i_gt)
    want_rows = jmetrics.hungarian_matching(*jmetrics._one_hots(pred, i_gt))
    got_rows = tmetrics.hungarian_matching(one_p, one_g)
    for g, w in zip(got_rows, want_rows):
        np.testing.assert_array_equal(g, w)
    assert tmetrics.compute_miou(pred, i_gt) == jmetrics.compute_miou(pred, i_gt)
    for tpp in (scores, scores.argmax(-1)):      # scores or labels, 6-9 folded
        assert tmetrics.compute_type_miou_abc(tpp, t_gt, pred, i_gt) == \
            jmetrics.compute_type_miou_abc(tpp, t_gt, pred, i_gt)
    assert np.isin(t_gt, [6, 7, 8, 9]).any()
