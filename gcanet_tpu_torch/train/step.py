"""The training step (port of ``gcanet_tpu/train/step.py``).

Loss orchestration mirrors ``MyTrainer.process_batch`` (train_new.py:22-137):
the 'f'/'r'/'p'/'n' characters of ``loss_class`` select the embedding,
type + offset + instance, parameter and normal losses with the reference's
weights (train_new.py:104-128).  ``train_step`` is forward in training mode,
backward, one optimizer step; its metrics stay on the device.  With
``precision="bf16"`` its forward runs on bf16 copies of the weights and
inputs, as the JAX step's does.  ``eval_step``
is the eval forward, the losses and the merged instance labels, all on the
device.

Data parallelism (``cfg.mesh_shape = N`` > 1, one process per device in a
group of ``N``: ``parallel/dist.py``) is the JAX step's ``shard_map``: each
rank runs the whole model on its chunk of the global batch, with its own
proposal cap, and averages the gradients, ``total``, the loss dict and the
new batch statistics over the group (``data_parallel_mean``: the four
``pmean`` calls of JAX) before the optimizer step, so every rank's Adam
takes the same step.  A rank's batch is its own chunk with instance ids that
index its own instance table, as on one device (a rank collates it itself,
or ``parallel.dist.local_shard`` cuts it from a global batch); the JAX
step's rebase of global ids is not needed.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from gcanet_tpu_torch.config import Config, check_trainable
from gcanet_tpu_torch.losses import losses as L
from gcanet_tpu_torch.models.primitive_net import ModelOutput, PrimitiveNet
from gcanet_tpu_torch.parallel.dist import all_reduce_mean, data_parallel_world
from gcanet_tpu_torch.train import instances as inst_utils
from gcanet_tpu_torch.utils import threefry
from gcanet_tpu_torch.utils.precision import _map_floats


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


def rebase_local_batch(batch: Dict[str, np.ndarray], rank: int, world: int,
                       max_instances: int) -> Dict[str, np.ndarray]:
    """A rank's own collated chunk with the global batch's instance ids, the
    JAX trainer's convention: its ``I_gt_global`` (``[0, local_b *
    max_instances)``) shifted by the chunk's offset in the global instance
    table; -1 stays.  Either family (ABC batches lead with ``gt_pc``, scenes
    with ``xyz``).  The port's steps take local ids and need no rebase; this
    is the inverse of ``local_shard``'s, for comparing a rank's chunk with a
    global batch."""
    if world <= 1 or rank == 0:
        return batch
    local_b = batch["gt_pc" if "gt_pc" in batch else "xyz"].shape[0]
    base = rank * local_b * max_instances
    ig = np.asarray(batch["I_gt_global"])
    return dict(batch, I_gt_global=np.where(ig >= 0, ig + base, -1))


def data_parallel_mean(cfg: Config, params: Iterable[torch.nn.Parameter],
                       buffers: Iterable[torch.Tensor],
                       metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Under data parallelism, JAX's ``pmean`` of the gradients of
    ``params`` (a missing one is a zero, as in JAX), the floating
    ``buffers`` (the new batch statistics) and the ``metrics``, in one
    ``all_reduce``; returns the metrics (as float32).  One device: the
    metrics as they are."""
    if data_parallel_world(cfg) == 1:
        return metrics
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    metrics = {k: v.float() for k, v in metrics.items()}
    all_reduce_mean(grads + [b for b in buffers if b.is_floating_point()]
                    + list(metrics.values()))
    return metrics


def batch_to_device(batch: Mapping[str, np.ndarray], device: torch.device | str
                    ) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on ``device``; to a card through
    pinned host memory, asynchronously.  ``index``, the objects' names,
    passes through as it is."""
    device = torch.device(device)
    out: Dict[str, torch.Tensor] = {}
    for k, v in batch.items():
        if k == "index":
            out[k] = v
            continue
        t = torch.as_tensor(np.asarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def grid_shift(base: threefry.Key, step: int, device: torch.device | str) -> torch.Tensor:
    """Training step ``step``'s shift of the proposals' voxel grids, the
    ``r1 [2, 3]`` the JAX step draws: ``uniform(fold_in(base, step), (2,
    3))`` (JAX ``train/step.py:222``, ``scene_step.py:113``), computed on
    the host and copied to ``device`` through pinned memory without
    waiting (no host sync).  Every data-parallel rank gets the same, as
    every JAX shard gets the same key."""
    t = torch.from_numpy(threefry.uniform(threefry.fold_in(base, step), (2, 3)))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def train_forward(model: PrimitiveNet, batch: Mapping[str, torch.Tensor],
                  r1: torch.Tensor | None = None) -> ModelOutput:
    """The step's forward in training mode.  ``precision="bf16"`` (JAX
    ``train/step.py:194-213``): the model runs on bf16 copies of its
    parameters (``functional_call``; the gradient flows back through the
    cast to the fp32 parameters the optimizer holds) and of ``gt_pc`` /
    ``gt_normal``, its running statistics stay fp32, and every floating
    output is cast to fp32 before the losses."""
    model.train()
    if model.cfg.precision != "bf16":
        return model(batch["gt_pc"], batch["gt_normal"], r1=r1)
    params = {k: p.to(torch.bfloat16) for k, p in model.named_parameters()}
    out = torch.func.functional_call(
        model, params, (batch["gt_pc"].to(torch.bfloat16), batch["gt_normal"].to(torch.bfloat16)),
        {"r1": r1})
    return _map_floats(out, torch.float32)


def train_step(model: PrimitiveNet, optimizer: torch.optim.Optimizer,
               batch: Mapping[str, torch.Tensor],
               r1: torch.Tensor | None = None) -> Dict[str, torch.Tensor]:
    """One step: forward in training mode, backward, optimizer step.

    ``batch`` holds tensors on the model's device; the voxel grids shift by
    ``r1 [2, 3]`` (``grid_shift``: every rank's is the same, as every JAX
    shard gets the same key).  Under data parallelism the gradients, losses and statistics are
    the group's means (module docstring).  Returns the loss dict and
    ``total_loss`` as detached device tensors: nothing is copied to the host.
    """
    cfg = model.cfg
    check_trainable(cfg)
    out = train_forward(model, batch, r1=r1)
    total, loss_dict = compute_losses(cfg, out, batch)
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    metrics = {k: v.detach() for k, v in dict(loss_dict, total_loss=total).items()}
    metrics = data_parallel_mean(cfg, model.parameters(), model.buffers(), metrics)
    optimizer.step()
    return metrics


@torch.no_grad()
def eval_step(model: PrimitiveNet, batch: Mapping[str, torch.Tensor]
              ) -> Tuple[ModelOutput, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """The eval forward (``model.eval()``: batch norms on their running
    statistics, set aggregation as ``cfg.using_set_aggr`` says), the losses,
    and ``get_instances`` + ``merge_masks`` on the device.  Returns ``(out,
    merged [B*N] int32, total, loss_dict)``, all on the model's device."""
    model.eval()
    out = model(batch["gt_pc"], batch["gt_normal"])
    total, loss_dict = compute_losses(model.cfg, out, batch)
    merged = inst_utils.merged_labels_device(
        out.proposals.point_pid, out.instance.cls_scores, out.instance.iou_scores,
        out.instance.mask_scores, out.proposals.valid, model.cfg.num_primitives)[0]
    return out, merged, total, loss_dict
