"""Scene-family (SoftGroup/ScanNet path) convergence run on the card (port
of ``tools/scene_convergence_run.py``).

    python -m gcanet_tpu_torch.scene_convergence_run [--steps 1500]
        [--grid 32] [--out PATH] [--device cpu] [the JAX tool's other flags]

Trains ``SoftGroupNet`` on synthetic scenes (``train/scene_step.py::
scene_train_step``) and logs point-wise semantic mIoU / accuracy and
ScanNet instance AP50 on held-out scenes every ``--eval-every`` steps:
JSONL rows ``{"step", "loss", "sem_miou", "acc", "ap50", "t_min"}``, the
loss ``NaN`` until the first ``--eval-every`` boundary, then ``done`` on
stdout.  The flags, defaults, ``Config`` (the scannetv2 grouping recipe with
the mean table at the synthetic instance size ``points / 5``), data seeds
and eval protocol are the JAX tool's:

* one fresh batch per step, ``synth_scene_batch`` seeds ``seed * 100_000 +
  1000 + step``, on the trainer's prefetch thread;
* the held-out scenes ``synth_scene_batch(cfg, 1, seed=90000 + i)``; on the
  device the eval forward, the non-merged ``instance_masks_device`` (one
  point may sit in several classes' masks), ``pack_mask_bits`` and the
  semantic argmax, then one copy; on the host ``unpack_mask_bits``,
  ``pointwise_semantic_eval``, ``instances_from_masks`` with the scannetv2
  label offset 2, the background column dropped, and ``evaluate_matches``
  with ``min_npoint=1``;
* the weights come from ``--seed`` (``init_lecun_normal_``), Adam at
  ``Config.learning_rate``; the proposal grids shift by draws from one
  ``torch.Generator`` seeded with ``seed + 1``, where the JAX tool passes
  the one key ``PRNGKey(seed + 1)`` to every step: the random streams differ
  from JAX's, as every port trainer's do.

The file starts with a ``#`` line naming the device and the command
(``tools/gate_report.py`` reads it as the header).  It runs on the card;
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from gcanet_tpu_torch.config import Config, InstanceHeadConfig, scene_grouping_defaults
from gcanet_tpu_torch.convergence_run import header, write_row
from gcanet_tpu_torch.data.synthetic import synth_scene_batch
from gcanet_tpu_torch.models.layers import init_lecun_normal_
from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet
from gcanet_tpu_torch.parallel.dist import pick_device
from gcanet_tpu_torch.train import instance_eval
from gcanet_tpu_torch.train import instances as inst_utils
from gcanet_tpu_torch.train import scene_step
from gcanet_tpu_torch.train import step as step_lib
from gcanet_tpu_torch.train.trainer import prefetch_to_device
from gcanet_tpu_torch.utils.transfer import fetch

CLS_OFFSET = 2          # scannetv2: the synthetic scenes' semantic = class + 2


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--grid", type=int, default=32, help="scene voxel grid")
    ap.add_argument("--max-proposals", type=int, default=0, help="0 = Config default")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 scene-backbone compute (Config.scene_bf16)")
    ap.add_argument("--soft", type=int, default=1,
                    help="1 = SoftGroup soft per-class grouping; 0 = argmax partition")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--eval-scenes", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "scene_convergence.jsonl"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def make_config(args: argparse.Namespace) -> Config:
    """The JAX tool's ``Config`` (tools/scene_convergence_run.py:63-77)."""
    kw = {}
    if args.max_proposals:
        kw["instance_head"] = InstanceHeadConfig(max_proposals=args.max_proposals)
    return Config(num_points=args.points, batch_size=args.batch,
                  scene_bf16=args.bf16,
                  scene_soft_grouping=bool(args.soft),
                  grouping=scene_grouping_defaults(
                      class_numpoint_mean=(args.points / 5.0,) * 10), **kw)


def eval_scenes(cfg: Config, args: argparse.Namespace) -> list[dict]:
    """The fixed held-out scenes (seeds ``90000 + i``), host arrays."""
    ecfg = cfg.replace(batch_size=1)
    return [synth_scene_batch(ecfg, 1, seed=90000 + i) for i in range(args.eval_scenes)]


def train_batches(cfg: Config, args: argparse.Namespace):
    """The host batch of every step, fresh each step."""
    for step in range(args.steps):
        b = synth_scene_batch(cfg, args.batch, seed=args.seed * 100_000 + 1000 + step)
        yield {k: v for k, v in b.items() if k != "index"}


@torch.no_grad()
def eval_forward(model: SoftGroupNet, xyz: torch.Tensor, feats: torch.Tensor
                 ) -> list[torch.Tensor]:
    """One scene's eval on the device: ``(keep, conf, npoint, mask bits,
    semantic argmax)`` (tools/scene_convergence_run.py:85-97)."""
    model.eval()
    out = model(xyz, feats)
    keep, conf, npoint, masks = inst_utils.instance_masks_device(
        out.proposals.point_pid, out.instance.cls_scores, out.instance.iou_scores,
        out.instance.mask_scores, out.proposals.valid, model.cfg.num_primitives)
    return [keep, conf, npoint, inst_utils.pack_mask_bits(masks),
            out.semantic_scores.argmax(dim=-1)]


def scene_metrics(hosts: list[list[np.ndarray]], scenes: list[dict],
                  num_classes: int) -> tuple[float, float, float]:
    """Mean semantic mIoU and accuracy, and AP50 over the held-out scenes,
    from each one's host ``eval_forward`` outputs
    (tools/scene_convergence_run.py:109-135)."""
    class_ids = list(range(CLS_OFFSET, num_classes - 1 + CLS_OFFSET))
    matched, miou_sum, acc_sum = [], 0.0, 0.0
    for (keep, conf, npoint, mask_bits, sem_pred), b in zip(hosts, scenes):
        gt_sem = np.asarray(b["semantic"][0])
        masks = inst_utils.unpack_mask_bits(mask_bits, int(gt_sem.shape[0]))
        pw = instance_eval.pointwise_semantic_eval(
            sem_pred[0] if sem_pred.ndim > 1 else sem_pred, gt_sem, num_classes,
            ignore_label=-100)
        miou_sum += pw["miou"]
        acc_sum += pw["acc"]
        preds = inst_utils.instances_from_masks(keep, conf, npoint, masks,
                                                label_offset=CLS_OFFSET, encode_rle=False)
        bg_label = (num_classes - 1) + CLS_OFFSET
        matched.append({"preds": [p for p in preds if p["label_id"] < bg_label],
                        "gt_inst": np.asarray(b["instance"][0]), "gt_sem": gt_sem})
    ap = instance_eval.evaluate_matches(matched, class_ids, min_npoint=1)
    n = len(scenes)
    return miou_sum / n, acc_sum / n, float(ap["all_ap_50%"])


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    dev = pick_device(args.device, 1, "the scene convergence run")
    cfg = make_config(args)
    model = SoftGroupNet(cfg, scene_grid=args.grid, compute_bf16=cfg.scene_bf16)
    init_lecun_normal_(model, torch.Generator().manual_seed(args.seed))
    model.to(dev)
    optimizer = step_lib.make_optimizer(cfg, model.parameters())
    scenes = eval_scenes(cfg, args)
    scenes_dev = [tuple(torch.as_tensor(np.asarray(b[k], np.float32), device=dev)
                        for k in ("xyz", "feats")) for b in scenes]

    def evaluate() -> tuple[float, float, float]:
        hosts = [fetch(eval_forward(model, xyz, feats)) for xyz, feats in scenes_dev]
        return scene_metrics(hosts, scenes, cfg.num_primitives)

    generator = torch.Generator(device=dev).manual_seed(args.seed + 1)
    t0 = time.time()
    with open(args.out, "w") as log:
        log.write(header(dev, "gcanet_tpu_torch.scene_convergence_run", argv))
        # fresh batch every step, loaded and copied while a step runs
        batches = prefetch_to_device(train_batches(cfg, args), dev)
        loss = float("nan")
        for step in range(args.steps + 1):
            if step % args.eval_every == 0:
                miou, acc, ap50 = evaluate()
                write_row(log, {"step": step, "loss": round(loss, 4),
                                "sem_miou": round(miou, 4), "acc": round(acc, 4),
                                "ap50": round(ap50, 4),
                                "t_min": round((time.time() - t0) / 60, 1)})
            if step < args.steps:
                metrics = scene_step.scene_train_step(model, optimizer, next(batches),
                                                      generator)
                if (step + 1) % args.eval_every == 0:
                    loss = float(metrics["total_loss"])
    print("done")


if __name__ == "__main__":
    main()
