"""Weights into the port's models: from a JAX/flax parameter tree, or from a
reference-format ``checkpoint_eval{N}.tar``.

The flagship ``PrimitiveNet``'s modules are named after the reference's
``model_state_dict`` keys (the ``torch_prefix`` column of
``gcanet_tpu/utils/import_torch.py::build_rules``), so one rule table serves
both sources; this is the port's own copy of it.  The scene ``SoftGroupNet``
has its own table (``build_scene_rules``), from the flax tree of the JAX
``SoftGroupNet``.  Layout transforms:

* Dense / 1x1 conv: flax ``[in, out]`` -> ``[out, in]``; a reference
  Conv1d/Conv2d weight ``[out, in, 1(, 1)]`` is squeezed.
* Conv3d: flax ``[k, k, k, in, out]`` -> ``[out, in, k, k, k]``; reference
  spconv kernels come as ``[k, k, k, in, out]`` (1.x) or ``[out, k, k, k, in]``
  (2.x).
* ConvTranspose3d: the weight is ``[in, out, k, k, k]``.  flax's
  ``ConvTranspose`` applies mirrored taps relative to torch's transposed conv
  (and spconv's inverse conv), so a flax kernel is also flipped in space; a
  reference kernel is not.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

LINEAR = "linear"        # Dense / Linear / 1x1 conv
NORM = "norm"            # GroupNorm / BatchNorm affine
BN_STATS = "bn_stats"    # BatchNorm running statistics
CONV3D = "conv3d"
DECONV3D = "deconv3d"

# (port key prefix == reference key prefix, flax path, kind, has_bias)
_Rule = tuple[str, tuple[str, ...], str, bool]


def _res_block_rules(prefix: str, fpath: tuple[str, ...],
                     with_identity: bool = False) -> list[_Rule]:
    rules = [
        (f"{prefix}.conv_branch.0", fpath + ("MaskedBatchNorm_0",), NORM, False),
        (f"{prefix}.conv_branch.0", fpath + ("MaskedBatchNorm_0",), BN_STATS, False),
        (f"{prefix}.conv_branch.2", fpath + ("SubMConv3d_0", "Conv_0"), CONV3D, False),
        (f"{prefix}.conv_branch.3", fpath + ("MaskedBatchNorm_1",), NORM, False),
        (f"{prefix}.conv_branch.3", fpath + ("MaskedBatchNorm_1",), BN_STATS, False),
        (f"{prefix}.conv_branch.5", fpath + ("SubMConv3d_1", "Conv_0"), CONV3D, False),
    ]
    if with_identity:
        rules.append((f"{prefix}.i_branch.0", fpath + ("Dense_0",), LINEAR, False))
    return rules


def _instance_head_rules(prefix: str, ih: tuple[str, ...]) -> list[_Rule]:
    """The instance head's rules: port keys under ``prefix``, flax path ``ih``."""
    tu = ih + ("TinyUNet_0",)
    rules: list[_Rule] = [
        (f"{prefix}cls_linear", ih + ("Dense_0",), LINEAR, True),
        (f"{prefix}iou_score_linear", ih + ("Dense_1",), LINEAR, True),
        (f"{prefix}mask_linear.0", ih + ("MLP_0", "Dense_0"), LINEAR, True),
        (f"{prefix}mask_linear.2", ih + ("MLP_0", "Dense_1"), LINEAR, True),
        (f"{prefix}tiny_unet_outputlayer.0", ih + ("MaskedBatchNorm_0",), NORM, False),
        (f"{prefix}tiny_unet_outputlayer.0", ih + ("MaskedBatchNorm_0",), BN_STATS, False),
        (f"{prefix}tiny_unet.conv.0", tu + ("MaskedBatchNorm_0",), NORM, False),
        (f"{prefix}tiny_unet.conv.0", tu + ("MaskedBatchNorm_0",), BN_STATS, False),
        (f"{prefix}tiny_unet.conv.2", tu + ("Conv_0",), CONV3D, False),
        (f"{prefix}tiny_unet.deconv.0", tu + ("MaskedBatchNorm_1",), NORM, False),
        (f"{prefix}tiny_unet.deconv.0", tu + ("MaskedBatchNorm_1",), BN_STATS, False),
        (f"{prefix}tiny_unet.deconv.2", tu + ("ConvTranspose_0",), DECONV3D, False),
    ]
    for i in range(2):
        rules += _res_block_rules(f"{prefix}tiny_unet.blocks.block{i}",
                                  tu + (f"ResidualBlock_{i}",))
        rules += _res_block_rules(f"{prefix}tiny_unet.u.blocks.block{i}",
                                  tu + (f"ResidualBlock_{i + 2}",))
    rules += _res_block_rules(f"{prefix}tiny_unet.blocks_tail.block0", tu + ("ResidualBlock_4",),
                              with_identity=True)
    rules += _res_block_rules(f"{prefix}tiny_unet.blocks_tail.block1", tu + ("ResidualBlock_5",))
    return rules


def build_rules() -> list[_Rule]:
    """The mode-5 flagship key map (models/dgcnn-hais-concat-direct-4.py)."""
    enc = ("DGCNNEncoderGn_0",)
    opm = ("OffsetPredModule_0",)
    rules: list[_Rule] = [
        ("encoder.conv1.0", enc + ("ConvGNAct_0", "Dense_0"), LINEAR, False),
        ("encoder.bn1", enc + ("ConvGNAct_0", "GroupNorm_0"), NORM, False),
        ("encoder.conv2.0", enc + ("EdgeConv_0",), LINEAR, False),
        ("encoder.bn2", enc + ("EdgeConv_0", "GroupNorm_0"), NORM, False),
        ("encoder.conv3.0", enc + ("EdgeConv_1",), LINEAR, False),
        ("encoder.bn3", enc + ("EdgeConv_1", "GroupNorm_0"), NORM, False),
        ("encoder.mlp1", enc + ("DenseGN_0", "Dense_0"), LINEAR, True),
        ("encoder.bnmlp1", enc + ("DenseGN_0", "GroupNorm_0"), NORM, False),
        ("conv1", ("DenseGN_0", "Dense_0"), LINEAR, True),
        ("bn1", ("DenseGN_0", "GroupNorm_0"), NORM, False),
        ("conv2", ("DenseGN_1", "Dense_0"), LINEAR, True),
        ("bn2", ("DenseGN_1", "GroupNorm_0"), NORM, False),
        ("mlp_prim_prob1", ("DenseGN_2", "Dense_0"), LINEAR, True),
        ("bn_prim_prob1", ("DenseGN_2", "GroupNorm_0"), NORM, False),
        ("mlp_prim_prob2", ("Dense_0",), LINEAR, True),
        ("mlp_param_prob1", ("DenseGN_3", "Dense_0"), LINEAR, True),
        ("bn_param_prob1", ("DenseGN_3", "GroupNorm_0"), NORM, False),
        ("mlp_param_prob2", ("Dense_1",), LINEAR, True),
        ("mlp_seg_prob1", ("DenseGN_4", "Dense_0"), LINEAR, True),
        ("bn_seg_prob1", ("DenseGN_4", "GroupNorm_0"), NORM, False),
        ("mlp_seg_prob2", ("Dense_2",), LINEAR, True),
        ("conv_normal.0", ("ConvGNAct_0", "Dense_0"), LINEAR, False),
        ("bn_normal", ("ConvGNAct_0", "GroupNorm_0"), NORM, False),
        ("conv3", ("DenseGN_5", "Dense_0"), LINEAR, True),
        ("bn3", ("DenseGN_5", "GroupNorm_0"), NORM, False),
        ("offset_pred_block.conv1.0", opm + ("ConvGNAct_0", "Dense_0"), LINEAR, False),
        ("offset_pred_block.bn1", opm + ("ConvGNAct_0", "GroupNorm_0"), NORM, False),
        ("offset_pred_block.attention.conv1.0", opm + ("KPAM_0", "Dense_0"), LINEAR, False),
        ("offset_pred_block.attention.conv1.2", opm + ("KPAM_0", "Dense_1"), LINEAR, False),
        ("offset_pred_block.mlp_offset", opm + ("Dense_0",), LINEAR, True),
    ]
    return rules + _instance_head_rules("", ("InstanceHead_0",))


def build_scene_rules(instance_head: bool = True) -> list[_Rule]:
    """The scene ``SoftGroupNet`` key map, from the flax tree of the JAX
    ``SoftGroupNet`` (its U-Net's submodules are flax auto-names in call
    order: the down paths' ``MaskedBatchNorm_0/1`` and ``Conv_0/1``, the up
    paths' ``ConvTranspose_0/1``).  ``instance_head=False`` for a
    ``semantic_only`` model."""
    un = ("unet",)
    rules: list[_Rule] = [
        ("input_conv", ("input_conv",), LINEAR, False),
        ("output_layer", ("output_layer",), NORM, False),
        ("output_layer", ("output_layer",), BN_STATS, False),
    ]
    for head in ("semantic_linear", "offset_linear"):
        rules += [(f"{head}.0", (head, "Dense_0"), LINEAR, True),
                  (f"{head}.2", (head, "Dense_1"), LINEAR, True)]
    for i in range(2):
        rules += [(f"unet.down_norm.{i}", un + (f"MaskedBatchNorm_{i}",), NORM, False),
                  (f"unet.down_norm.{i}", un + (f"MaskedBatchNorm_{i}",), BN_STATS, False),
                  (f"unet.down_conv.{i}", un + (f"Conv_{i}",), CONV3D, False),
                  (f"unet.up_conv.{i}", un + (f"ConvTranspose_{i}",), DECONV3D, False)]
    for i in range(5):
        rules += _res_block_rules(f"unet.blocks.{i}", un + (f"ResidualBlock_{i}",),
                                  with_identity=i >= 3)
    if instance_head:
        rules += _instance_head_rules("instance_head.", ("instance_head",))
    return rules


def _leaf_pairs(kind: str, has_bias: bool) -> list[tuple[str, str]]:
    """(port/reference leaf name, flax leaf name) pairs of one rule."""
    if kind == NORM:
        return [("weight", "scale"), ("bias", "bias")]
    if kind == BN_STATS:
        return [("running_mean", "mean"), ("running_var", "var")]
    return [("weight", "kernel")] + ([("bias", "bias")] if has_bias else [])


def _rules(family: str, instance_head: bool = True) -> list[_Rule]:
    if family == "flagship":
        return build_rules()
    if family == "scene":
        return build_scene_rules(instance_head)
    raise ValueError(f"unknown model family {family!r}; 'flagship' or 'scene'")


def key_kinds(family: str = "flagship") -> dict[str, str]:
    """Every port state_dict key the rules cover, with its transform kind."""
    return {f"{prefix}.{leaf}": kind
            for prefix, _, kind, has_bias in _rules(family)
            for leaf, _ in _leaf_pairs(kind, has_bias)}


def _from_flax(kind: str, leaf: str, w: np.ndarray) -> np.ndarray:
    if leaf != "weight":
        return w
    if kind == LINEAR:
        return w.T
    if kind == CONV3D:
        return w.transpose(4, 3, 0, 1, 2)
    if kind == DECONV3D:
        return w[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
    return w


def state_dict_from_jax(params: Mapping, batch_stats: Mapping | None,
                        family: str = "flagship") -> dict[str, torch.Tensor]:
    """Flax ``(params, batch_stats)`` trees of the JAX ``PrimitiveNet``
    (``family="flagship"``) or ``SoftGroupNet`` (``family="scene"``; a tree
    without ``instance_head`` is a ``semantic_only`` model's), as nested
    dicts of numpy arrays, -> a state_dict of the port's counterpart.

    Every transform is a transpose or a flip, so a gradient tree of the
    params maps the same way onto the port's ``.grad`` tensors (either
    family, ``semantic_only`` included); pass ``batch_stats=None`` to map
    the params alone, or a training step's new ``batch_stats`` to compare
    running statistics."""
    out: dict[str, torch.Tensor] = {}
    for prefix, fpath, kind, has_bias in _rules(family, "instance_head" in params):
        if kind == BN_STATS and batch_stats is None:
            continue
        node = batch_stats if kind == BN_STATS else params
        for name in fpath:
            node = node[name]
        for leaf, fleaf in _leaf_pairs(kind, has_bias):
            w = _from_flax(kind, leaf, np.asarray(node[fleaf], np.float32))
            out[f"{prefix}.{leaf}"] = torch.from_numpy(np.array(w, order="C"))
    return out


# reference keys with no counterpart: dead weights (dgcnn-4.py:464-465, 911),
# duplicate Sequential registrations of shared norms, BN step counters
KNOWN_UNUSED = (
    "mlp_squeeze_output_feature", "bn_normal_squeeze_output_feature",
    "encoder.conv1.1", "encoder.conv2.1", "encoder.conv3.1",
    "conv_normal.1", "offset_pred_block.conv1.1",
    "num_batches_tracked", "tiny_unet_outputlayer.1",
    "encoder.bn4", "encoder.bn5",
)

# candidate source layouts of a 5-d kernel, as permutations into the port's
# layout, tried in order: spconv 1.x, spconv 2.x, torch's own
_CONV3D_PERMS = ((4, 3, 0, 1, 2), (0, 4, 1, 2, 3), (0, 1, 2, 3, 4))
_DECONV3D_PERMS = ((3, 4, 0, 1, 2), (4, 0, 1, 2, 3), (0, 1, 2, 3, 4))


def _to_port_layout(kind: str, w: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    if kind in (CONV3D, DECONV3D) and w.dim() == 5:
        for perm in (_CONV3D_PERMS if kind == CONV3D else _DECONV3D_PERMS):
            if w.permute(perm).shape == shape:
                return w.permute(perm).contiguous()
    elif kind == LINEAR and w.numel() == shape.numel():
        # Conv1d/Conv2d [out, in, 1(, 1)] and Custom1x1Subm3d (whose forward
        # uses weight.view(out, in)) -> [out, in]
        return w.reshape(shape)
    elif w.shape == shape:
        return w
    raise ValueError(f"cannot map a {kind} weight of shape {tuple(w.shape)} "
                     f"to {tuple(shape)}")


@dataclasses.dataclass
class LoadReport:
    loaded: list[str]        # port keys filled from the source
    missing: list[str]       # port keys the source does not cover
    unexpected: list[str]    # source keys with no port counterpart


def _strip(key: str) -> str:
    for prefix in ("module.", "affinitynet."):
        if key.startswith(prefix):
            key = key[len(prefix):]
    return key


def load_reference_checkpoint(model: torch.nn.Module,
                              source: str | Path | Mapping[str, torch.Tensor],
                              strict: bool = True, family: str = "flagship") -> LoadReport:
    """Load a reference-format checkpoint (``torch.save({epoch,
    model_state_dict, ...})``, as ``import_torch.save_reference_checkpoint``
    and the reference trainer write it), or a state_dict in either the
    reference's or the port's layout, into ``model`` by key intersection.

    With ``strict`` it raises when a port key is missing or a source key is
    neither used nor a known dead/duplicate key (``KNOWN_UNUSED``).  A
    ``family="scene"`` source is a port state_dict of ``SoftGroupNet`` or a
    ``torch.save`` of one (the reference SoftGroup's own checkpoints are not
    mapped).
    """
    if isinstance(source, (str, Path)):
        ckpt = torch.load(source, map_location="cpu", weights_only=True)
        source = ckpt.get("model_state_dict", ckpt)
    src = {_strip(k): v if isinstance(v, torch.Tensor)
           else torch.from_numpy(np.array(v, order="C")) for k, v in source.items()}
    kinds = key_kinds(family)
    target = model.state_dict()
    new, loaded, missing = {}, [], []
    for key, cur in target.items():
        if key not in src:
            missing.append(key)
            continue
        w = _to_port_layout(kinds.get(key, ""), src[key], cur.shape)
        new[key] = w.to(dtype=cur.dtype)
        loaded.append(key)
    unexpected = sorted(k for k in src if k not in target)
    report = LoadReport(sorted(loaded), sorted(missing), unexpected)
    unknown = [k for k in unexpected if not any(s in k for s in KNOWN_UNUSED)]
    if strict and (missing or unknown):
        raise ValueError(f"checkpoint does not fit the model: missing {missing}, "
                         f"unknown keys {unknown}")
    model.load_state_dict(new, strict=False)
    return report
