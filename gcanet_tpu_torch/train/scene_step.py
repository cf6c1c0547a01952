"""The scene family's training step (port of ``gcanet_tpu/train/scene_step.py``).

Loss orchestration mirrors the reference's ``SoftGroup.forward_train``
(softgroup/model/softgroup.py:113-172, 175-281), a plain sum of:

  * semantic cross-entropy with ignore label -100 (softgroup.py:158-160);
  * offset L1 over points with an instance (:163-169);
  * the SoftGroup instance loss with -100 as the background instance class
    (:198-200; ``losses.instance_loss(..., bg_cls=-100)``, shared with the
    flagship), left out in the ``semantic_only`` stage.

``scene_train_step`` is forward in training mode, backward, one optimizer
step; its metrics stay on the device.  Under data parallelism
(``cfg.mesh_shape`` > 1) it is the flagship's (``train/step.py``), with the
fixed modules frozen before the group's mean, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from gcanet_tpu_torch.config import Config, check_trainable
from gcanet_tpu_torch.losses import losses as L
from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet, SoftGroupOutput
from gcanet_tpu_torch.train.step import data_parallel_mean


def compute_scene_losses(cfg: Config, out: SoftGroupOutput, batch: Mapping[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(total, loss_dict)``: ``semantic_loss`` and ``offset_loss``, and
    unless ``cfg.semantic_only`` ``cls_loss``, ``mask_loss``,
    ``iou_score_loss`` and ``num_pos`` (not summed into ``total``)."""
    sem_gt = batch["semantic"].reshape(-1)
    inst_gt = batch["I_gt_global"].reshape(-1)
    ld: Dict[str, torch.Tensor] = {}

    valid = sem_gt >= 0
    logp = torch.log_softmax(out.semantic_scores, dim=-1)
    tgt = torch.clamp(sem_gt, 0, logp.shape[-1] - 1).long()
    ce = -torch.gather(logp, 1, tgt[:, None])[:, 0]
    ld["semantic_loss"] = torch.where(valid, ce, 0.0).sum() / torch.clamp(valid.sum(), min=1)
    ld["offset_loss"] = L.offset_loss(out.pt_offsets, inst_gt,
                                      batch["pt_offset_label"].reshape(-1, 3))
    if cfg.semantic_only:
        return ld["semantic_loss"] + ld["offset_loss"], ld

    inst_total, aux = L.instance_loss(
        out.instance.cls_scores, out.instance.mask_scores, out.instance.iou_scores,
        out.proposals.point_pid, out.proposals.valid, inst_gt,
        batch["instance_pointnum"], batch["instance_cls"], batch["inst_valid"],
        cfg.num_primitives, bg_cls=-100)
    ld["cls_loss"] = aux.cls_loss
    ld["mask_loss"] = aux.mask_loss
    ld["iou_score_loss"] = aux.iou_score_loss
    ld["num_pos"] = aux.num_pos
    return ld["semantic_loss"] + ld["offset_loss"] + inst_total, ld


def fixed_module_names(cfg: Config) -> tuple:
    """``--fixed_modules`` parsed: the comma-separated top-level module
    names (``input_conv``, ``unet``, ``output_layer``, ``semantic_linear``,
    ``offset_linear``, ``instance_head``), stripped, empties dropped."""
    return tuple(m.strip() for m in str(cfg.fixed_modules or "").split(",") if m.strip())


def scene_train_step(model: SoftGroupNet, optimizer: torch.optim.Optimizer,
                     batch: Mapping[str, torch.Tensor],
                     r1: torch.Tensor | None = None) -> Dict[str, torch.Tensor]:
    """One step: forward in training mode, backward, optimizer step.

    ``batch`` holds tensors on the model's device; the proposal grids shift
    by ``r1 [2, 3]`` (``step.grid_shift``; a ``semantic_only`` model needs
    none).  The modules named in ``cfg.fixed_modules`` are frozen as the
    JAX step freezes them: their parameters get no gradient (``grad =
    None``, which every torch optimizer skips, weight decay included) and
    their running statistics are put back after the forward, which still
    normalises them with batch statistics (no ``.eval()``); the freeze
    comes before the group's mean under data parallelism (JAX
    ``scene_step.py:123-129``).
    Returns the loss dict and ``total_loss`` as detached device tensors."""
    cfg = model.cfg
    check_trainable(cfg, scene=True)
    model.train()
    frozen = [getattr(model, name) for name in fixed_module_names(cfg) if hasattr(model, name)]
    saved = [(buf, buf.clone()) for m in frozen for buf in m.buffers()]
    out = model(batch["xyz"], batch["feats"], r1=r1)
    total, ld = compute_scene_losses(cfg, out, batch)
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    with torch.no_grad():
        for m in frozen:
            for p in m.parameters():
                p.grad = None
        for buf, old in saved:
            buf.copy_(old)
    frozen_params = {id(p) for m in frozen for p in m.parameters()}
    metrics = {k: v.detach() for k, v in dict(ld, total_loss=total).items()}
    metrics = data_parallel_mean(cfg, [p for p in model.parameters()
                                       if id(p) not in frozen_params],
                                 model.buffers(), metrics)
    optimizer.step()
    return metrics
