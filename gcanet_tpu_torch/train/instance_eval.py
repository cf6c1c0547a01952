"""ScanNet-style instance-segmentation AP evaluation (the port's copy of
``gcanet_tpu/train/instance_eval.py``, numpy only).

Faithful re-implementation of the vendored ScanNet benchmark evaluator
(``softgroup/evaluation/instance_eval.py:13-403`` +
``instance_eval_util.py:143-154``): AP over IoU overlaps 0.5:0.05:0.95 plus
AP@50 / AP@25 and the matching recall (RC) metrics, with the reference's
exact matching semantics:

- ``min_region_sizes`` (default 100) filters small GT instances from the
  denominator AND skips small predictions at assignment time
  (instance_eval.py:26-28,275-276);
- GT "groups" (encoded instance_id < 1000) and *void* points (semantic id
  not in the valid class set) are subtracted from unmatched predictions —
  a prediction mostly covering ignored points is NOT a false positive
  (instance_eval.py:123-136);
- greedy per-GT matching with ``pred_visited``; a second prediction
  matching an already-matched GT contributes a false positive carrying the
  *lower* of the two confidences (instance_eval.py:95-108);
- distance thresholds (``med_dist``/``dist_conf``) carried with their
  always-pass defaults (instance_eval.py:29-30, instance_eval_util.py:76-77);
- the ScanNet trapezoid AP integration over unique score thresholds
  (instance_eval.py:146-192).

GT encoding convention (softgroup/model/softgroup.py:641-653): one int per
point, ``gt_id = class_id * 1000 + instance_id``, 0 = ignore.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Dict, List, Optional, Sequence

import numpy as np

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)


class ScanNetEval:
    """Reference: softgroup/evaluation/instance_eval.py:13 (ScanNetEval)."""

    def __init__(self, class_labels: Sequence[str],
                 min_npoint: Optional[int] = None, iou_type=None,
                 use_label: bool = True):
        self.valid_class_labels = list(class_labels)
        self.valid_class_ids = np.arange(len(class_labels)) + 1
        self.id2label = {int(i): l for i, l in
                         zip(self.valid_class_ids, self.valid_class_labels)}
        self.label2id = {l: int(i) for i, l in
                         zip(self.valid_class_ids, self.valid_class_labels)}
        self.ious = OVERLAPS
        self.min_region_sizes = np.array([min_npoint if min_npoint else 100])
        self.distance_threshes = np.array([float("inf")])
        self.distance_confs = np.array([-float("inf")])
        self.iou_type = iou_type
        self.use_label = use_label
        self.eval_class_labels = (self.valid_class_labels if use_label
                                  else ["class_agnostic"])

    # ------------------------------------------------------------ gt parsing
    def get_instances(self, gts: np.ndarray) -> Dict[str, List[Dict]]:
        """instance_eval_util.py:143-154 — unique encoded ids -> instance
        records (id 0 = ignore)."""
        instances: Dict[str, List[Dict]] = {l: [] for l in
                                            self.valid_class_labels}
        ids, counts = np.unique(gts, return_counts=True)
        for inst_id, n in zip(ids, counts):
            if inst_id == 0:
                continue
            label_id = int(inst_id // 1000)
            if label_id in self.id2label:
                instances[self.id2label[label_id]].append({
                    "instance_id": int(inst_id), "label_id": label_id,
                    "vert_count": int(n), "med_dist": -1, "dist_conf": 0.0,
                })
        return instances

    # --------------------------------------------------------- per-scan pass
    def assign_instances_for_scan(self, preds: List[Dict], gts: np.ndarray,
                                  scan_idx: int = 0):
        """instance_eval.py:228-309 — intersect every prediction mask with
        every GT instance of its class; vectorised via bincount over the
        encoded-id array (exact same counts as the reference's per-pair
        ``count_nonzero``)."""
        gts = np.asarray(gts)
        gt_instances = self.get_instances(gts)
        if self.use_label:
            gt2pred = deepcopy(gt_instances)
            for label in gt2pred:
                for gt in gt2pred[label]:
                    gt["matched_pred"] = []
        else:
            agnostic: List[Dict] = []
            for _, insts in gt_instances.items():
                agnostic += deepcopy(insts)
            for gt in agnostic:
                gt["matched_pred"] = []
            gt2pred = {self.eval_class_labels[0]: agnostic}

        pred2gt: Dict[str, List[Dict]] = {l: [] for l in self.eval_class_labels}
        num_pred_instances = 0
        bool_void = np.logical_not(np.isin(gts // 1000, self.valid_class_ids))
        for pred in preds:
            if self.use_label:
                label_id = int(pred["label_id"])
                if label_id not in self.id2label:
                    continue
                label_name = self.id2label[label_id]
            else:
                label_id = None
                label_name = self.eval_class_labels[0]
            conf = pred["conf"]
            pred_mask = pred["pred_mask"]
            if isinstance(pred_mask, dict):
                from gcanet_tpu_torch.train.instances import rle_decode

                pred_mask = rle_decode(pred_mask)
            assert pred_mask.shape[0] == gts.shape[0]
            pred_mask = np.not_equal(pred_mask, 0)
            num = int(np.count_nonzero(pred_mask))
            if num < self.min_region_sizes[0]:
                continue  # skip if empty/too small (instance_eval.py:275-276)

            pred_instance = {
                # pred_visited (evaluate_matches) is keyed by this name
                # across ALL scans — the fallback must be unique per scan or
                # visiting "scan_0" in scan A would mute scan B's first pred
                "filename": "{}_{}".format(
                    pred.get("scan_id", f"scan{scan_idx}"),
                    num_pred_instances),
                "pred_id": num_pred_instances,
                "label_id": label_id,
                "vert_count": num,
                "confidence": conf,
                "void_intersection": int(np.count_nonzero(
                    np.logical_and(bool_void, pred_mask))),
            }
            # one bincount pass gives the intersection with EVERY gt id
            ids_in_mask, counts = np.unique(gts[pred_mask],
                                            return_counts=True)
            inter_of = dict(zip(ids_in_mask.tolist(), counts.tolist()))
            matched_gt = []
            for gt_num, gt_inst in enumerate(gt2pred[label_name]):
                intersection = inter_of.get(gt_inst["instance_id"], 0)
                if intersection > 0:
                    gt_copy = gt_inst.copy()
                    pred_copy = pred_instance.copy()
                    gt_copy["intersection"] = intersection
                    pred_copy["intersection"] = intersection
                    iou = float(intersection) / (
                        gt_copy["vert_count"] + pred_copy["vert_count"]
                        - intersection)
                    gt_copy["iou"] = iou
                    pred_copy["iou"] = iou
                    matched_gt.append(gt_copy)
                    gt2pred[label_name][gt_num]["matched_pred"].append(
                        pred_copy)
            pred_instance["matched_gt"] = matched_gt
            num_pred_instances += 1
            pred2gt[label_name].append(pred_instance)
        return gt2pred, pred2gt

    # ------------------------------------------------------------- AP tables
    def evaluate_matches(self, matches: Dict) -> tuple:
        """instance_eval.py:39-202."""
        ious = self.ious
        min_region_size = self.min_region_sizes[0]
        distance_thresh = self.distance_threshes[0]
        distance_conf = self.distance_confs[0]

        n_labels = len(self.eval_class_labels)
        ap = np.zeros((1, n_labels, len(ious)))
        rc = np.zeros((1, n_labels, len(ious)))
        for oi, iou_th in enumerate(ious):
            pred_visited = {}
            for m in matches:
                for label_name in self.eval_class_labels:
                    for p in matches[m]["pred"][label_name]:
                        pred_visited[p["filename"]] = False
            for li, label_name in enumerate(self.eval_class_labels):
                y_true = np.empty(0)
                y_score = np.empty(0)
                hard_false_negatives = 0
                has_gt = False
                has_pred = False
                for m in matches:
                    pred_instances = matches[m]["pred"][label_name]
                    gt_instances = matches[m]["gt"][label_name]
                    # filter groups / too-small / distance-failing GTs
                    gt_instances = [
                        gt for gt in gt_instances
                        if gt["instance_id"] >= 1000
                        and gt["vert_count"] >= min_region_size
                        and gt["med_dist"] <= distance_thresh
                        and gt["dist_conf"] >= distance_conf
                    ]
                    if gt_instances:
                        has_gt = True
                    if pred_instances:
                        has_pred = True

                    cur_true = np.ones(len(gt_instances))
                    cur_score = np.ones(len(gt_instances)) * (-float("inf"))
                    cur_match = np.zeros(len(gt_instances), dtype=bool)
                    for gti, gt in enumerate(gt_instances):
                        found_match = False
                        for pred in gt["matched_pred"]:
                            if pred_visited[pred["filename"]]:
                                continue  # greedy: already claimed
                            if pred["iou"] > iou_th:
                                confidence = pred["confidence"]
                                if cur_match[gti]:
                                    # second match on the same GT: the lower-
                                    # scored one is automatically an FP
                                    max_score = max(cur_score[gti], confidence)
                                    min_score = min(cur_score[gti], confidence)
                                    cur_score[gti] = max_score
                                    cur_true = np.append(cur_true, 0)
                                    cur_score = np.append(cur_score, min_score)
                                    cur_match = np.append(cur_match, True)
                                else:
                                    found_match = True
                                    cur_match[gti] = True
                                    cur_score[gti] = confidence
                                    pred_visited[pred["filename"]] = True
                        if not found_match:
                            hard_false_negatives += 1
                    cur_true = cur_true[cur_match]
                    cur_score = cur_score[cur_match]

                    # unmatched predictions: FP unless mostly-ignored
                    for pred in pred_instances:
                        found_gt = False
                        for gt in pred["matched_gt"]:
                            if gt["iou"] > iou_th:
                                found_gt = True
                                break
                        if not found_gt:
                            num_ignore = pred["void_intersection"]
                            for gt in pred["matched_gt"]:
                                if gt["instance_id"] < 1000:  # group
                                    num_ignore += gt["intersection"]
                                if (gt["vert_count"] < min_region_size
                                        or gt["med_dist"] > distance_thresh
                                        or gt["dist_conf"] < distance_conf):
                                    num_ignore += gt["intersection"]
                            proportion_ignore = (float(num_ignore)
                                                 / pred["vert_count"])
                            if proportion_ignore <= iou_th:
                                cur_true = np.append(cur_true, 0)
                                cur_score = np.append(cur_score,
                                                      pred["confidence"])
                    y_true = np.append(y_true, cur_true)
                    y_score = np.append(y_score, cur_score)

                if has_gt and has_pred:
                    # ScanNet trapezoid AP over unique score thresholds
                    order = np.argsort(y_score)
                    y_score_sorted = y_score[order]
                    y_true_sorted = y_true[order]
                    y_true_sorted_cumsum = np.cumsum(y_true_sorted)
                    (_, unique_indices) = np.unique(y_score_sorted,
                                                    return_index=True)
                    num_prec_recall = len(unique_indices) + 1
                    num_examples = len(y_score_sorted)
                    num_true_examples = (y_true_sorted_cumsum[-1]
                                         if len(y_true_sorted_cumsum) else 0)
                    precision = np.zeros(num_prec_recall)
                    recall = np.zeros(num_prec_recall)
                    y_true_sorted_cumsum = np.append(y_true_sorted_cumsum, 0)
                    for idx_res, idx_scores in enumerate(unique_indices):
                        cumsum = y_true_sorted_cumsum[idx_scores - 1]
                        tp = num_true_examples - cumsum
                        fp = num_examples - idx_scores - tp
                        fn = cumsum + hard_false_negatives
                        precision[idx_res] = float(tp) / (tp + fp)
                        recall[idx_res] = float(tp) / (tp + fn)
                    rc_current = recall[0]
                    # first curve point is artificial
                    precision[-1] = 1.0
                    recall[-1] = 0.0
                    recall_for_conv = np.copy(recall)
                    recall_for_conv = np.append(recall_for_conv[0],
                                                recall_for_conv)
                    recall_for_conv = np.append(recall_for_conv, 0.0)
                    step_widths = np.convolve(recall_for_conv,
                                              [-0.5, 0, 0.5], "valid")
                    ap_current = np.dot(precision, step_widths)
                elif has_gt:
                    ap_current, rc_current = 0.0, 0.0
                else:
                    ap_current, rc_current = float("nan"), float("nan")
                ap[0, li, oi] = ap_current
                rc[0, li, oi] = rc_current
        return ap, rc

    def compute_averages(self, aps: np.ndarray, rcs: np.ndarray) -> Dict:
        """instance_eval.py:204-226."""
        d_inf = 0
        o50 = np.where(np.isclose(self.ious, 0.5))
        o25 = np.where(np.isclose(self.ious, 0.25))
        o_all_but25 = np.where(np.logical_not(np.isclose(self.ious, 0.25)))
        avg: Dict = {
            "all_ap": np.nanmean(aps[d_inf, :, o_all_but25]),
            "all_ap_50%": np.nanmean(aps[d_inf, :, o50]),
            "all_ap_25%": np.nanmean(aps[d_inf, :, o25]),
            "all_rc": np.nanmean(rcs[d_inf, :, o_all_but25]),
            "all_rc_50%": np.nanmean(rcs[d_inf, :, o50]),
            "all_rc_25%": np.nanmean(rcs[d_inf, :, o25]),
            "classes": {},
        }
        for li, label_name in enumerate(self.eval_class_labels):
            avg["classes"][label_name] = {
                "ap": np.average(aps[d_inf, li, o_all_but25]),
                "ap50%": np.average(aps[d_inf, li, o50]),
                "ap25%": np.average(aps[d_inf, li, o25]),
                "rc": np.average(rcs[d_inf, li, o_all_but25]),
                "rc50%": np.average(rcs[d_inf, li, o50]),
                "rc25%": np.average(rcs[d_inf, li, o25]),
            }
        return avg

    def evaluate(self, pred_list: Sequence[List[Dict]],
                 gt_list: Sequence[np.ndarray],
                 print_result: bool = True) -> Dict:
        """instance_eval.py:375-403.

        pred_list: per scan, a list of dicts (scan_id, label_id, conf,
        pred_mask [dense bool array or rle dict]).
        gt_list: per scan, per point, ``gt_id = class_id*1000 + instance_id``.
        """
        matches = {}
        for i, (preds, gts) in enumerate(zip(pred_list, gt_list)):
            gt2pred, pred2gt = self.assign_instances_for_scan(preds, gts,
                                                              scan_idx=i)
            matches[f"gt_{i}"] = {"gt": gt2pred, "pred": pred2gt}
        ap_scores, rc_scores = self.evaluate_matches(matches)
        avgs = self.compute_averages(ap_scores, rc_scores)
        if print_result:
            self.print_results(avgs)
        return avgs

    def print_results(self, avgs: Dict) -> None:
        """instance_eval.py:311-363 (compact table)."""
        header = f"{'what':<15}:{'AP':>8}{'AP_50%':>8}{'AP_25%':>8}" \
                 f"{'AR':>8}{'RC_50%':>8}{'RC_25%':>8}"
        print("#" * len(header))
        print(header)
        print("#" * len(header))
        for label_name in self.eval_class_labels:
            c = avgs["classes"][label_name]
            print(f"{label_name:<15}:{c['ap']:>8.3f}{c['ap50%']:>8.3f}"
                  f"{c['ap25%']:>8.3f}{c['rc']:>8.3f}{c['rc50%']:>8.3f}"
                  f"{c['rc25%']:>8.3f}")
        print("-" * len(header))
        print(f"{'average':<15}:{avgs['all_ap']:>8.3f}"
              f"{avgs['all_ap_50%']:>8.3f}{avgs['all_ap_25%']:>8.3f}"
              f"{avgs['all_rc']:>8.3f}{avgs['all_rc_50%']:>8.3f}"
              f"{avgs['all_rc_25%']:>8.3f}")

    def write_result_file(self, avgs: Dict, filename: str) -> None:
        """instance_eval.py:365-373."""
        with open(filename, "w") as f:
            f.write("class,ap,ap50,ap25\n")
            for name in self.eval_class_labels:
                c = avgs["classes"][name]
                f.write(f"{name},{c['ap']},{c['ap50%']},{c['ap25%']}\n")


# --------------------------------------------------------------------------
# Scene-dict adapter (framework-internal convenience surface)
# --------------------------------------------------------------------------

def encode_scene_gt(gt_inst: np.ndarray, gt_sem: np.ndarray,
                    class_ids: Sequence[int]) -> np.ndarray:
    """Encode (instance ids, semantic labels) into the ScanNet per-point
    convention ``class_id*1000 + instance_id`` (softgroup.py:641-653):
    eval class ids are 1-based positions in ``class_ids``; points outside
    the instance classes (or without an instance) encode to 0 → void."""
    gts = np.zeros(len(gt_sem), dtype=np.int64)
    for pos, c in enumerate(class_ids):
        m = (np.asarray(gt_sem) == c) & (np.asarray(gt_inst) >= 0)
        gts[m] = (pos + 1) * 1000 + np.asarray(gt_inst)[m] + 1
    return gts


def evaluate_matches(scenes: Sequence[Dict], class_ids: Sequence[int],
                     min_npoint: int = 1) -> Dict[str, float]:
    """scenes: [{"preds": [{"label_id","conf","mask"}], "gt_inst": [N],
    "gt_sem": [N]}, ...] -> {"all_ap", "all_ap_50%", "all_ap_25%",
    "class_<c>_ap"...} via the faithful ScanNetEval above.

    ``min_npoint`` defaults to 1 here (tiny synthetic scenes); pass
    ``min_npoint=None`` for the reference's benchmark default of 100.
    """
    evaluator = ScanNetEval([str(c) for c in class_ids],
                            min_npoint=min_npoint)
    id_of = {c: i + 1 for i, c in enumerate(class_ids)}
    pred_list, gt_list = [], []
    for si, scene in enumerate(scenes):
        preds = [{"scan_id": si, "label_id": id_of[p["label_id"]],
                  "conf": p["conf"],
                  "pred_mask": np.asarray(p["mask"], dtype=bool)}
                 for p in scene["preds"] if p["label_id"] in id_of]
        pred_list.append(preds)
        gt_list.append(encode_scene_gt(scene["gt_inst"], scene["gt_sem"],
                                       class_ids))
    avgs = evaluator.evaluate(pred_list, gt_list, print_result=False)

    def _f(x):
        x = float(x)
        return 0.0 if np.isnan(x) else x

    result = {
        "all_ap": _f(avgs["all_ap"]),
        "all_ap_50%": _f(avgs["all_ap_50%"]),
        "all_ap_25%": _f(avgs["all_ap_25%"]),
    }
    for c in class_ids:
        result[f"class_{c}_ap"] = _f(avgs["classes"][str(c)]["ap"])
    return result


def _scene_matches(preds: List[Dict], gt_inst: np.ndarray, gt_sem: np.ndarray,
                   class_id: int, min_region_size: int = 1):
    """Greedy IoU matching of one scene's predictions of one class
    (used by the panoptic-quality metric below)."""
    gt_ids = [g for g in np.unique(gt_inst[gt_sem == class_id]) if g >= 0]
    gt_masks = [(gt_inst == g) & (gt_sem == class_id) for g in gt_ids]
    gt_masks = [m for m in gt_masks if m.sum() >= min_region_size]

    cls_preds = [p for p in preds if p["label_id"] == class_id]
    rows = []
    for p in cls_preds:
        pm = p["mask"].astype(bool)
        best_iou = 0.0
        best_gt = -1
        for gi, gm in enumerate(gt_masks):
            inter = np.logical_and(pm, gm).sum()
            union = pm.sum() + gm.sum() - inter
            iou = inter / union if union else 0.0
            if iou > best_iou:
                best_iou, best_gt = iou, gi
        rows.append((p["conf"], best_iou, best_gt))
    return rows, len(gt_masks)


def panoptic_quality(scenes: Sequence[Dict], class_ids: Sequence[int],
                     iou_thr: float = 0.5) -> Dict[str, float]:
    """Panoptic Quality (PQ/SQ/RQ) — equivalent of the vendored
    softgroup/evaluation PanopticEval.  Matches predicted segments to GT at
    IoU > thr (unique by construction) and averages per class."""
    pq_per_class = {}
    for cls in class_ids:
        tp, fp, fn = 0, 0, 0
        iou_sum = 0.0
        for scene in scenes:
            rows, n_gt = _scene_matches(scene["preds"], scene["gt_inst"],
                                        scene["gt_sem"], cls)
            matched = set()
            for conf, iou, g in sorted(rows, key=lambda t: -t[1]):
                if iou > iou_thr and g >= 0 and g not in matched:
                    matched.add(g)
                    tp += 1
                    iou_sum += iou
                else:
                    fp += 1
            fn += n_gt - len(matched)
        denom = tp + 0.5 * fp + 0.5 * fn
        sq = iou_sum / tp if tp else 0.0
        rq = tp / denom if denom else 0.0
        pq_per_class[cls] = {"pq": sq * rq, "sq": sq, "rq": rq}
    pq = float(np.mean([v["pq"] for v in pq_per_class.values()])) if pq_per_class else 0.0
    return {"pq": pq, "per_class": pq_per_class}


def evaluate_offset_mae(pred_offsets: np.ndarray, gt_offsets: np.ndarray,
                        gt_instance: np.ndarray,
                        ignore_label: int = -1) -> float:
    """Mean absolute offset error over foreground points
    (softgroup/evaluation/point_wise_eval.py:36-44)."""
    pos = gt_instance != ignore_label
    if not pos.any():
        return 0.0
    return float(np.abs(gt_offsets[pos] - pred_offsets[pos]).sum()
                 / pos.sum())


def pointwise_semantic_eval(pred_sem: np.ndarray, gt_sem: np.ndarray,
                            num_classes: int, ignore_label: int = -1
                            ) -> Dict[str, float]:
    """Point-wise semantic mIoU / accuracy (softgroup/evaluation point_wise_eval
    equivalent)."""
    valid = gt_sem != ignore_label
    p, g = pred_sem[valid], gt_sem[valid]
    ious = []
    for c in range(num_classes):
        inter = np.sum((p == c) & (g == c))
        union = np.sum((p == c) | (g == c))
        if union:
            ious.append(inter / union)
    return {
        "miou": float(np.mean(ious)) if ious else 0.0,
        "acc": float(np.mean(p == g)) if len(p) else 0.0,
    }
