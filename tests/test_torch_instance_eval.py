"""The port's ScanNet AP evaluator (``train/instance_eval.py``) against the
JAX package's: the hand-built cases of ``tests/test_instance_eval.py`` and
random scenes through every function, exactly (both are numpy; NaN where
a class has no ground truth)."""

import numpy as np
import pytest

from gcanet_tpu.train import instance_eval as jie
from gcanet_tpu.train.instances import rle_encode as jrle_encode
from gcanet_tpu_torch.train import instance_eval as tie
from gcanet_tpu_torch.train.instances import rle_encode


def _same(got, want, path="result"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def _mask(n, sl):
    m = np.zeros(n, dtype=bool)
    m[sl] = True
    return m


def _pred(n, sl, conf=0.9, label=1, scan=0):
    return {"scan_id": scan, "label_id": label, "conf": conf, "pred_mask": _mask(n, sl)}


def _gts(n, spans):
    g = np.zeros(n, dtype=np.int64)
    for sl, v in spans:
        g[sl] = v
    return g


# the scenes of tests/test_instance_eval.py: (classes, evaluator kwargs,
# predictions per scan, ground truth per scan)
HAND_CASES = {
    "min_region_default": (["c1"], {}, [[_pred(400, slice(0, 150)),
                                         _pred(400, slice(150, 180), conf=0.99)]],
                           [_gts(400, [(slice(0, 150), 1001), (slice(150, 180), 1002)])]),
    "min_region_10": (["c1"], dict(min_npoint=10), [[_pred(400, slice(0, 150)),
                                                      _pred(400, slice(150, 180), conf=0.99)]],
                      [_gts(400, [(slice(0, 150), 1001), (slice(150, 180), 1002)])]),
    "pred_over_small_gt": (["c1"], dict(min_npoint=200),
                           [[_pred(400, slice(0, 250)), _pred(400, slice(250, 400), conf=0.8)]],
                           [_gts(400, [(slice(0, 250), 1001), (slice(250, 390), 1002)])]),
    "void_overlap": (["c1"], {}, [[_pred(500, slice(0, 150)),
                                   _pred(500, slice(200, 350), conf=0.8)]],
                     [_gts(500, [(slice(0, 150), 1001)])]),
    "void_fp": (["c1"], dict(min_npoint=10), [[_pred(500, slice(0, 150)),
                                               _pred(500, slice(200, 275), conf=0.8)]],
                [_gts(500, [(slice(0, 150), 1001), (slice(200, 350), 1007)])]),
    "group_gt": (["c1"], {}, [[_pred(400, slice(0, 150)), _pred(400, slice(150, 300), conf=0.8)]],
                 [_gts(400, [(slice(0, 150), 1001), (slice(150, 300), 999)])]),
    "double_match_two_scans": (["c1"], {},
                               [[_pred(300, slice(0, 200)), _pred(300, slice(0, 150), conf=0.5)],
                                [_pred(300, slice(0, 200), conf=0.3, scan=1)]],
                               [_gts(300, [(slice(0, 200), 1001)])] * 2),
    "greedy_visited": (["c1"], {}, [[_pred(400, slice(0, 300))]],
                       [_gts(400, [(slice(0, 150), 1001), (slice(150, 300), 1002)])]),
    "class_agnostic": (["c1", "c2"], dict(use_label=False),
                       [[_pred(400, slice(0, 150), label=2),
                         _pred(400, slice(150, 300), conf=0.8, label=1)]],
                       [_gts(400, [(slice(0, 150), 1001), (slice(150, 300), 2001)])]),
    "class_labelled": (["c1", "c2"], {}, [[_pred(400, slice(0, 150), label=2),
                                           _pred(400, slice(150, 300), conf=0.8, label=1)]],
                       [_gts(400, [(slice(0, 150), 1001), (slice(150, 300), 2001)])]),
}


@pytest.mark.parametrize("case", list(HAND_CASES))
def test_scannet_eval_hand_cases_match_jax(case):
    classes, kw, preds, gts = HAND_CASES[case]
    got = tie.ScanNetEval(classes, **kw).evaluate(preds, gts, print_result=False)
    want = jie.ScanNetEval(classes, **kw).evaluate(preds, gts, print_result=False)
    _same(got, want)


def test_rle_masks_and_the_printed_table(capsys, tmp_path):
    gts = _gts(300, [(slice(0, 150), 1001)])
    dense = _mask(300, slice(0, 150))
    got = tie.ScanNetEval(["c1"]).evaluate(
        [[{"scan_id": 0, "label_id": 1, "conf": 0.9, "pred_mask": rle_encode(dense)}]], [gts])
    printed = capsys.readouterr().out
    want = jie.ScanNetEval(["c1"]).evaluate(
        [[{"scan_id": 0, "label_id": 1, "conf": 0.9, "pred_mask": jrle_encode(dense)}]], [gts])
    assert printed == capsys.readouterr().out and "average" in printed
    _same(got, want)
    assert got["all_ap_50%"] == 1.0
    tie.ScanNetEval(["c1"]).write_result_file(got, tmp_path / "t.csv")
    jie.ScanNetEval(["c1"]).write_result_file(want, tmp_path / "j.csv")
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


def _random_scene(rng, n=300, n_inst=6, classes=(2, 3, 4)):
    gt_inst = rng.randint(-1, n_inst, n)
    inst_cls = rng.choice(classes, n_inst)
    gt_sem = np.where(gt_inst >= 0, inst_cls[np.clip(gt_inst, 0, None)], rng.randint(0, 2, n))
    preds = []
    for _ in range(rng.randint(3, 9)):
        g = rng.randint(n_inst)
        mask = (gt_inst == g) ^ (rng.rand(n) < rng.choice([0.02, 0.1, 0.4]))
        label = inst_cls[g] if rng.rand() < 0.8 else rng.choice(classes)
        preds.append({"label_id": int(label), "conf": float(rng.choice([0.3, 0.5, rng.rand()])),
                      "mask": mask})
    return {"preds": preds, "gt_inst": gt_inst, "gt_sem": gt_sem}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scene_functions_match_jax_on_random_scenes(seed):
    rng = np.random.RandomState(seed)
    scenes = [_random_scene(rng) for _ in range(4)]
    classes = [2, 3, 4]
    for min_npoint in (1, 10, None):
        _same(tie.evaluate_matches(scenes, classes, min_npoint=min_npoint),
              jie.evaluate_matches(scenes, classes, min_npoint=min_npoint))
    _same(tie.panoptic_quality(scenes, classes), jie.panoptic_quality(scenes, classes))
    _same(tie.panoptic_quality(scenes, classes, iou_thr=0.3),
          jie.panoptic_quality(scenes, classes, iou_thr=0.3))
    s = scenes[0]
    for c in classes:
        _same(tie._scene_matches(s["preds"], s["gt_inst"], s["gt_sem"], c, 20),
              jie._scene_matches(s["preds"], s["gt_inst"], s["gt_sem"], c, 20))
    _same(tie.encode_scene_gt(s["gt_inst"], s["gt_sem"], classes),
          jie.encode_scene_gt(s["gt_inst"], s["gt_sem"], classes))
    pred_sem = np.where(rng.rand(300) < 0.7, s["gt_sem"], rng.randint(0, 5, 300))
    for ignore in (-1, 0, -100):
        _same(tie.pointwise_semantic_eval(pred_sem, s["gt_sem"], 5, ignore),
              jie.pointwise_semantic_eval(pred_sem, s["gt_sem"], 5, ignore))
    off_p, off_g = rng.randn(300, 3), rng.randn(300, 3)
    _same(tie.evaluate_offset_mae(off_p, off_g, s["gt_inst"]),
          jie.evaluate_offset_mae(off_p, off_g, s["gt_inst"]))
    assert tie.evaluate_offset_mae(off_p, off_g, np.full(300, -1)) == 0.0


def test_perfect_and_misaligned_scenes():
    gt_inst, gt_sem = np.repeat(np.arange(4), 50), np.repeat([1, 1, 2, 2], 50)
    for shift, check in ((0, lambda r: r["all_ap"] > 0.99), (30, lambda r: r["all_ap"] < 0.5)):
        scene = {"gt_inst": gt_inst, "gt_sem": gt_sem,
                 "preds": [{"label_id": int(gt_sem[g * 50]), "conf": 0.9,
                            "mask": np.roll(gt_inst == g, shift)} for g in range(4)]}
        got = tie.evaluate_matches([scene], class_ids=[1, 2])
        _same(got, jie.evaluate_matches([scene], class_ids=[1, 2]))
        assert check(got)
