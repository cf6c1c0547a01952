"""Trainer for the SoftGroup scene family (port of
``gcanet_tpu/train/scene_trainer.py``).

Reuses the base ``Trainer``'s workspace, checkpoints, learning rate and
loop, and swaps the scene pieces: the ScanNet-style dataset
(``data/scene_dataset.py``), the scene train step (``train/scene_step.py``)
and an evaluation epoch reporting point-wise semantic mIoU/accuracy, ScanNet
instance AP and PQ (``train/instance_eval.py``).  ``train_new`` selects it
when ``--model_dict`` names the scene family (``softgroup.model.softgroup``).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from gcanet_tpu_torch.data import scene_dataset as sdm
from gcanet_tpu_torch.data.synthetic import synth_scene_batch
from gcanet_tpu_torch.train import instance_eval
from gcanet_tpu_torch.train import instances as inst_utils
from gcanet_tpu_torch.train import scene_step
from gcanet_tpu_torch.train.trainer import Trainer, _is_device_error
from gcanet_tpu_torch.utils.transfer import fetch

SCENE_SUFFIX = "_inst_nostuff.pth"          # scannetv2 preprocessed dumps
CLS_OFFSET = 2                              # scannetv2.py:23-27


class SceneTrainer(Trainer):
    """Trains ``SoftGroupNet`` (``scene_step.scene_train_step``) and
    evaluates it scene by scene.  Without the dataset's directory the
    batches are synthetic scenes (``synth_scene_batch``) with the JAX
    trainer's seeds: 32 per epoch (or ``GCA_SYNTH_BATCHES``) and 8 eval
    scenes of seeds ``90000 + i``."""

    scene = True
    synth = staticmethod(synth_scene_batch)
    # instance class -> semantic label offset of the dataset (scannetv2
    # unless build_dataloaders picks another variant)
    cls_offset = CLS_OFFSET

    # ------------------------------------------------------------------- data
    def build_dataloaders(self) -> None:
        """``--dataset`` selects the variant (s3dis, stpls3d, kitti; any
        other name reads ScanNet's layout)."""
        cfg = self.cfg
        name = (cfg.dataset or "").lower()
        if name == "s3dis":
            cls, train_prefix, val_prefix = sdm.S3DISSceneDataset, \
                ["Area_1", "Area_2", "Area_3", "Area_4", "Area_6"], ["Area_5"]
            probe = cfg.data_path
            self.cls_offset = 0
        elif name == "stpls3d":
            cls, train_prefix, val_prefix = sdm.STPLS3DSceneDataset, "train", "val"
            probe = os.path.join(cfg.data_path, "train")
            self.cls_offset = 1
        elif name in ("kitti", "semantic-kitti"):
            cls, train_prefix, val_prefix = sdm.KITTISceneDataset, "train", "val"
            probe = os.path.join(cfg.data_path, "sequences")
            self.cls_offset = 11
        else:
            cls, train_prefix, val_prefix = sdm.ScanNetSceneDataset, "train", "val"
            probe = os.path.join(cfg.data_path, "train")
            self.cls_offset = CLS_OFFSET

        if not os.path.isdir(probe):
            print(f"scene data {probe} not found -> synthetic scenes")
            self.train_data = self.test_data = None
            return
        suffix = self._detect_suffix(cls, probe)
        self.train_data = cls(cfg.data_path, train_prefix, suffix, cfg, training=True)
        if (isinstance(val_prefix, str) and cls is not sdm.KITTISceneDataset
                and not os.path.isdir(os.path.join(cfg.data_path, val_prefix))):
            val_prefix = train_prefix
        self.test_data = cls(cfg.data_path, val_prefix, suffix, cfg, training=False)

    @staticmethod
    def _detect_suffix(cls, probe_dir: str) -> str:
        if cls is sdm.KITTISceneDataset:
            return ".bin"
        try:
            files = os.listdir(probe_dir)
        except OSError:
            files = []
        if any(f.endswith(SCENE_SUFFIX) for f in files):
            return SCENE_SUFFIX
        if any(f.endswith(".pth") for f in files):
            return ".pth"
        return ".npz"

    # ------------------------------------------------------------------ steps
    def _train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return scene_step.scene_train_step(self.model, self.optimizer, batch,
                                           r1=self._next_shift())

    @torch.no_grad()
    def _eval_forward(self, batch: Dict[str, np.ndarray]) -> List[torch.Tensor]:
        """The eval forward of one batch-1 scene on the device: the semantic
        argmax, and unless ``semantic_only`` the unmerged instance masks
        (SoftGroup's eval: one point may sit in several classes' masks),
        bit-packed for the copy."""
        self.model.eval()
        xyz, feats = (torch.as_tensor(np.asarray(batch[k], np.float32), device=self.device)
                      for k in ("xyz", "feats"))
        out = self.model(xyz, feats, x4_split=bool(self.cfg.x4_split))
        sem_pred = out.semantic_scores.argmax(dim=-1)
        if self.cfg.semantic_only:
            return [sem_pred]
        keep, conf, npoint, masks = inst_utils.instance_masks_device(
            out.proposals.point_pid, out.instance.cls_scores, out.instance.iou_scores,
            out.instance.mask_scores, out.proposals.valid, self.cfg.num_primitives)
        return [keep, conf, npoint, inst_utils.pack_mask_bits(masks), sem_pred]

    # ------------------------------------------------------------------- eval
    def test_one_epoch(self, epoch: int):
        """Evaluate every test scene: the forward and instance masks on the
        device, one copy, then on the host the point-wise mIoU and accuracy,
        and over all scenes ScanNet AP (``min_npoint`` ``eval_min_npoint``,
        else 1 on synthetic scenes and the benchmark's 100 on a dataset) and
        PQ over the instance classes (background column C-1 dropped).
        Writes ``scalars_test.jsonl``, the log line and
        ``output_results.csv``.  A scene whose evaluation raises is logged,
        counted in ``eval_errors`` and skipped, except on a CUDA error.
        Under data parallelism each rank evaluates every ``world``-th scene
        and the sums and scenes are merged before AP and PQ, which every
        rank computes; rank 0 writes.  Returns ``(miou, AP50)``, the two
        metrics ``train()`` keeps its best checkpoints by."""
        cfg = self.cfg
        scenes: List[Dict] = []
        sem_stats: Dict[str, float] = {}
        cnt = 0
        self._results_rows = []
        for batch in self._test_batches():
            try:
                host = fetch(self._eval_forward(batch))
            except Exception as e:          # noqa: BLE001 -- trainer_new.py:333-335
                if _is_device_error(e):
                    raise
                self.eval_errors += 1
                self.logger.error(f"error: {batch.get('index', ['?'])[0]}: {e}")
                continue
            sem_pred = host[-1]
            gt_sem = np.asarray(batch["semantic"][0])
            gt_inst = np.asarray(batch["instance"][0])
            pw = instance_eval.pointwise_semantic_eval(sem_pred, gt_sem, cfg.num_primitives,
                                                       ignore_label=-100)
            for k, v in pw.items():
                sem_stats[k] = sem_stats.get(k, 0.0) + v
            if not cfg.semantic_only:
                keep, conf, npoint, mask_bits, _ = host
                masks = inst_utils.unpack_mask_bits(mask_bits, gt_sem.shape[0])
                preds = inst_utils.instances_from_masks(keep, conf, npoint, masks,
                                                        label_offset=self.cls_offset,
                                                        encode_rle=False)
                bg_label = (cfg.num_primitives - 1) + self.cls_offset
                scenes.append({"preds": [p for p in preds if p["label_id"] < bg_label],
                               "gt_inst": gt_inst, "gt_sem": gt_sem})
            self._results_rows.append({"ID": batch.get("index", ["?"])[0],
                                       "miou": round(pw["miou"], 3), "acc": round(pw["acc"], 3)})
            cnt += 1
        sem_stats, cnt, scenes = self._merge_eval_results(sem_stats, cnt, scenes)

        class_ids = list(range(self.cls_offset, cfg.num_primitives - 1 + self.cls_offset))
        min_npoint = cfg.eval_min_npoint or (1 if self.test_data is None else None)
        ap = (instance_eval.evaluate_matches(scenes, class_ids, min_npoint=min_npoint) if scenes
              else {"all_ap": 0.0, "all_ap_50%": 0.0, "all_ap_25%": 0.0})
        avg = {k: v / max(cnt, 1) for k, v in sem_stats.items()}
        avg["pq"] = instance_eval.panoptic_quality(scenes, class_ids)["pq"] if scenes else 0.0
        avg.update({k: float(v) for k, v in ap.items()})
        self._log_eval(epoch, avg)
        return avg.get("miou", 0.0), avg.get("all_ap_50%", 0.0)
