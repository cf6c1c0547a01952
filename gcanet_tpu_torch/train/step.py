"""The training step (port of ``gcanet_tpu/train/step.py``, one device).

Loss orchestration mirrors ``MyTrainer.process_batch`` (train_new.py:22-137):
the 'f'/'r'/'p'/'n' characters of ``loss_class`` select the embedding,
type + offset + instance, parameter and normal losses with the reference's
weights (train_new.py:104-128).  ``train_step`` is forward in training mode,
backward, one optimizer step; its metrics stay on the device.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from gcanet_tpu_torch.config import Config, check_trainable
from gcanet_tpu_torch.losses import losses as L
from gcanet_tpu_torch.models.primitive_net import ModelOutput, PrimitiveNet


def compute_losses(cfg: Config, out: ModelOutput, batch: Mapping[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(total, loss_dict)``: ``total`` sums every entry named ``*loss``
    except ``pull_loss`` and ``push_loss`` (parts of ``feat_loss``)."""
    loss_dict: Dict[str, torch.Tensor] = {}
    b, n = batch["T_gt"].shape

    if "f" in cfg.loss_class:
        feat_loss, pull, push = L.compute_embedding_loss(
            out.embedding, batch["I_gt"], cfg.max_instances)
        loss_dict["feat_loss"] = feat_loss * 2.0
        loss_dict["pull_loss"] = pull
        loss_dict["push_loss"] = push
    if cfg.mode == 3:
        loss_dict["normal_loss"] = cfg.normal_weight * L.compute_normal_loss(
            out.normal_per_point, batch["gt_normal"])
    if "p" in cfg.loss_class:
        loss_dict["param_loss"] = 5.0 * cfg.param_weight * L.compute_param_loss(
            out.param_per_point, batch["T_gt"], batch["T_param"])
    if "r" in cfg.loss_class:
        loss_dict["nnl_loss"] = cfg.type_weight * L.compute_nnl_loss(
            out.type_per_point, batch["T_gt"])
        inst_flat = batch["I_gt_global"].reshape(b * n)
        loss_dict["offset_loss"] = 10.0 * L.offset_loss(
            out.pt_offsets, inst_flat, batch["pt_offset_label"].reshape(b * n, 3))
        inst_total, aux = L.instance_loss(
            out.instance.cls_scores, out.instance.mask_scores,
            out.instance.iou_scores, out.proposals.point_pid,
            out.proposals.valid, inst_flat,
            batch["instance_pointnum"], batch["instance_cls"],
            batch["inst_valid"], cfg.num_primitives)
        loss_dict["inst_loss"] = inst_total * 1.0
        loss_dict["num_pos"] = aux.num_pos

    total = out.embedding.new_zeros(())
    for key, v in loss_dict.items():
        if "loss" in key and key not in ("pull_loss", "push_loss"):
            total = total + v
    return total, loss_dict


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """Adam (AdamW with a weight decay) or Nesterov SGD, as the JAX
    package's optax choice (trainer_new.py:98-117): optax's defaults
    (betas 0.9/0.999, eps 1e-8; no weight decay on SGD).  The learning rate
    is set per epoch by the trainer (``lr_for_epoch``)."""
    if cfg.optimizer.lower() == "adam":
        if cfg.weight_decay:
            return torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=cfg.weight_decay)
        return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=cfg.momentum,
                           nesterov=True)


def lr_for_epoch(cfg: Config, epoch: int) -> float:
    """Piecewise-constant decay (trainer_new.py:144-150)."""
    lr = cfg.learning_rate
    for step_epoch, rate in zip(cfg.lr_decay_step_list, cfg.lr_decay_rate_list):
        if epoch >= step_epoch:
            lr *= rate
    return lr


def batch_to_device(batch: Mapping[str, np.ndarray], device: torch.device | str
                    ) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on ``device`` (``index``, the
    objects' names, stays behind)."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items() if k != "index"}


def train_step(model: PrimitiveNet, optimizer: torch.optim.Optimizer,
               batch: Mapping[str, torch.Tensor],
               generator: torch.Generator | None = None) -> Dict[str, torch.Tensor]:
    """One step: forward in training mode, backward, optimizer step.

    ``batch`` holds tensors on the model's device; ``generator`` (on that
    device) draws the voxel grid shifts.  Returns the loss dict and
    ``total_loss`` as detached device tensors: nothing is copied to the host.
    """
    check_trainable(model.cfg)
    model.train()
    out = model(batch["gt_pc"], batch["gt_normal"], generator=generator)
    total, loss_dict = compute_losses(model.cfg, out, batch)
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    optimizer.step()
    return {k: v.detach() for k, v in dict(loss_dict, total_loss=total).items()}
