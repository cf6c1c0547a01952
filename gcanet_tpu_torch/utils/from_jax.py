"""Weights into the port's models: from a JAX/flax parameter tree, or from a
reference-format ``checkpoint_eval{N}.tar``.

The flagship ``PrimitiveNet``'s modules are named after the reference's
``model_state_dict`` keys (the ``torch_prefix`` column of
``gcanet_tpu/utils/import_torch.py::build_rules``), so one rule table serves
both sources; this is the port's own copy of it.  So are SPP-Net's
(``build_sppnet_rules``) and SplineNet's (``build_splinenet_rules``); the
dual-attention (``-2``) variant is the flagship's table with its own offset
module rows.  The scene ``SoftGroupNet`` has its own table
(``build_scene_rules``), from the flax tree of the JAX ``SoftGroupNet``, as
have the library modules that no reference checkpoint holds (PointNet++
SA/FP modules, soft projection, ViT, the query decoder;
``build_library_rules``).  Layout transforms:

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
RAW = "raw"              # a bare parameter (a token, a query table), copied as it is

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


def _encoder_rules() -> list[_Rule]:
    enc = ("DGCNNEncoderGn_0",)
    return [
        ("encoder.conv1.0", enc + ("ConvGNAct_0", "Dense_0"), LINEAR, False),
        ("encoder.bn1", enc + ("ConvGNAct_0", "GroupNorm_0"), NORM, False),
        ("encoder.conv2.0", enc + ("EdgeConv_0",), LINEAR, False),
        ("encoder.bn2", enc + ("EdgeConv_0", "GroupNorm_0"), NORM, False),
        ("encoder.conv3.0", enc + ("EdgeConv_1",), LINEAR, False),
        ("encoder.bn3", enc + ("EdgeConv_1", "GroupNorm_0"), NORM, False),
        ("encoder.mlp1", enc + ("DenseGN_0", "Dense_0"), LINEAR, True),
        ("encoder.bnmlp1", enc + ("DenseGN_0", "GroupNorm_0"), NORM, False),
    ]


def build_encoder_rules() -> list[_Rule]:
    """``DGCNNEncoderGn`` alone, as the root of its own flax tree (the JAX
    per-stage timer inits it so, tools/micro_bench.py:82)."""
    return [(p.removeprefix("encoder."), f[1:], k, b) for p, f, k, b in _encoder_rules()]


def build_instance_head_rules() -> list[_Rule]:
    """``InstanceHead`` alone, as the root of its own flax tree
    (tools/micro_bench.py:135)."""
    return _instance_head_rules("", ())


def build_rules(mode: int = 5, ablation: bool = False, dual: bool = False) -> list[_Rule]:
    """The flagship key map (models/dgcnn-hais-concat-direct-4.py).  Modes 5
    and 0 share it (only ``conv1``'s, ``conv_normal``'s and ``conv3``'s
    widths differ).  Mode 3 inserts the normal head, so the flax
    auto-names of the heads after it shift by one; ``ablation`` has the
    ``offset_linear`` MLP where the offset module was, and ``dual`` the
    ``-2`` model's dual-attention module (dgcnn-hais-concat-direct-2.py:
    326-466; flax ``OffsetPredModuleDual_0``)."""
    opm = ("OffsetPredModule_0",)
    od = ("OffsetPredModuleDual_0",)
    nh = 1 if mode == 3 else 0              # the normal head's shift of later names
    rules: list[_Rule] = _encoder_rules() + [
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
        ("mlp_seg_prob1", (f"DenseGN_{4 + nh}", "Dense_0"), LINEAR, True),
        ("bn_seg_prob1", (f"DenseGN_{4 + nh}", "GroupNorm_0"), NORM, False),
        ("mlp_seg_prob2", (f"Dense_{2 + nh}",), LINEAR, True),
        ("conv_normal.0", ("ConvGNAct_0", "Dense_0"), LINEAR, False),
        ("bn_normal", ("ConvGNAct_0", "GroupNorm_0"), NORM, False),
        ("conv3", (f"DenseGN_{5 + nh}", "Dense_0"), LINEAR, True),
        ("bn3", (f"DenseGN_{5 + nh}", "GroupNorm_0"), NORM, False),
    ]
    if mode == 3:
        rules += [("mlp_normal_prob1", ("DenseGN_4", "Dense_0"), LINEAR, True),
                  ("bn_normal_prob1", ("DenseGN_4", "GroupNorm_0"), NORM, False),
                  ("mlp_normal_prob2", ("Dense_2",), LINEAR, True)]
    if ablation:
        rules += [("offset_linear.0", ("MLP_0", "Dense_0"), LINEAR, True),
                  ("offset_linear.2", ("MLP_0", "Dense_1"), LINEAR, True)]
    elif dual:
        rules += [
            ("offset_pred_block.conv1.0", od + ("ConvGNAct_0", "Dense_0"), LINEAR, False),
            ("offset_pred_block.bn1", od + ("ConvGNAct_0", "GroupNorm_0"), NORM, False),
            ("offset_pred_block.attention_inst.conv1.0", od + ("KPAMSigmoid_0", "Dense_0"),
             LINEAR, False),
            ("offset_pred_block.attention_inst.conv1.2", od + ("KPAMSigmoid_0", "Dense_1"),
             LINEAR, False),
            ("offset_pred_block.mlp_offset", od + ("Dense_0",), LINEAR, True),
        ]
    else:
        rules += [
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


def build_sppnet_rules() -> list[_Rule]:
    """SPP-Net (models/sppnet.py:228-349) -> ``models/sppnet.py::
    PrimitiveNetSPP``; flax heads in call order: embedding
    (``DenseGN_2``/``Dense_0``), type, normal, parameters."""
    rules = _encoder_rules() + [
        ("conv1", ("DenseGN_0", "Dense_0"), LINEAR, True),
        ("bn1", ("DenseGN_0", "GroupNorm_0"), NORM, False),
        ("conv2", ("DenseGN_1", "Dense_0"), LINEAR, True),
        ("bn2", ("DenseGN_1", "GroupNorm_0"), NORM, False),
    ]
    for i, head in enumerate(("seg", "prim", "normal", "param")):
        rules += [(f"mlp_{head}_prob1", (f"DenseGN_{2 + i}", "Dense_0"), LINEAR, True),
                  (f"bn_{head}_prob1", (f"DenseGN_{2 + i}", "GroupNorm_0"), NORM, False),
                  (f"mlp_{head}_prob2", (f"Dense_{i}",), LINEAR, True)]
    return rules


def build_splinenet_rules() -> list[_Rule]:
    """SplineNet's ``DGCNNControlPoints`` (models/splinenet.py:55-179; both
    modes share the key names) -> ``models/splinenet.py``."""
    rules: list[_Rule] = []
    for i in range(4):
        blk = (f"_EdgeBlock_{i}",)
        rules += [(f"conv{i + 1}.0", blk + ("Dense_0",), LINEAR, False),
                  (f"bn{i + 1}", blk + ("BatchNorm_0",), NORM, False),
                  (f"bn{i + 1}", blk + ("BatchNorm_0",), BN_STATS, False)]
    rules.append(("conv5.0", ("Dense_0",), LINEAR, False))
    for i in range(5, 8):
        rules += [(f"bn{i}", (f"BatchNorm_{i - 5}",), NORM, False),
                  (f"bn{i}", (f"BatchNorm_{i - 5}",), BN_STATS, False)]
        if i > 5:
            rules.append((f"conv{i}", (f"Dense_{i - 5}",), LINEAR, True))
    return rules + [("conv8", ("Dense_3",), LINEAR, True)]


def _count(node: Mapping, name: str) -> int:
    """How many ``{name}_{i}`` children a flax tree node has."""
    return sum(1 for k in node if k.rsplit("_", 1)[0] == name)


def _shared_mlp_rules(prefix: str, fpath: tuple[str, ...], node: Mapping) -> list[_Rule]:
    rules: list[_Rule] = []
    for i in range(_count(node, "Dense")):
        rules += [(f"{prefix}convs.{i}", fpath + (f"Dense_{i}",), LINEAR, False),
                  (f"{prefix}bns.{i}", fpath + (f"BatchNorm_{i}",), NORM, False),
                  (f"{prefix}bns.{i}", fpath + (f"BatchNorm_{i}",), BN_STATS, False)]
    return rules


def _attention_rules(prefix: str, fpath: tuple[str, ...], norm: bool) -> list[_Rule]:
    rules = [(f"{prefix}{proj}", fpath + (f"Dense_{i}",), LINEAR, True)
             for i, proj in enumerate(("q_proj", "k_proj", "v_proj", "out_proj"))]
    return rules + ([(f"{prefix}norm", fpath + ("LayerNorm_0",), NORM, False)] if norm else [])


def _transformer_rules(prefix: str, tr: tuple[str, ...], node: Mapping) -> list[_Rule]:
    """A ``Transformer``: per layer, the attention's pre-norm is
    ``LayerNorm_{2i}`` and the feed-forward's ``LayerNorm_{2i+1}``."""
    rules: list[_Rule] = []
    for i in range(_count(node, "Attention")):
        p, att, ff = f"{prefix}layers.{i}.", tr + (f"Attention_{i}",), tr + (f"FeedForward_{i}",)
        rules += [(f"{p}norm1", tr + (f"LayerNorm_{2 * i}",), NORM, False),
                  (f"{p}attn.to_qkv", att + ("Dense_0",), LINEAR, False),
                  (f"{p}attn.to_out", att + ("Dense_1",), LINEAR, True),
                  (f"{p}norm2", tr + (f"LayerNorm_{2 * i + 1}",), NORM, False),
                  (f"{p}ff.net.0", ff + ("Dense_0",), LINEAR, True),
                  (f"{p}ff.net.2", ff + ("Dense_1",), LINEAR, True)]
    return rules


def build_library_rules(family: str, params: Mapping) -> list[_Rule]:
    """The key maps of the library modules, read off their flax trees
    ``params`` (the layer counts): ``"sa_msg"`` (``PointnetSAModuleMSG``,
    ``make`` too), ``"fp"`` (``PointnetFPModule``), ``"soft_projection"``,
    ``"transformer"``, ``"vit"`` and ``"query_decoder"``."""
    if family == "sa_msg":
        return [r for j in range(_count(params, "SharedMLP"))
                for r in _shared_mlp_rules(f"mlps.{j}.", (f"SharedMLP_{j}",),
                                           params[f"SharedMLP_{j}"])]
    if family == "fp":
        return _shared_mlp_rules("mlp.", ("SharedMLP_0",), params["SharedMLP_0"])
    if family == "soft_projection":
        return [("temperature", ("temperature",), RAW, False)]
    if family == "transformer":
        return _transformer_rules("", (), params)
    if family == "vit":
        return [("to_patch_embedding", ("Dense_0",), LINEAR, True),
                ("cls_token", ("cls_token",), RAW, False),
                ("pos_embedding", ("pos_embedding",), RAW, False),
                ("mlp_head.0", ("LayerNorm_0",), NORM, False),
                ("mlp_head.1", ("Dense_1",), LINEAR, True),
                *_transformer_rules("transformer.", ("Transformer_0",),
                                    params["Transformer_0"])]
    if family == "query_decoder":
        # the Sequentials' layers are auto-named in the decoder's own scope
        rules = [("input_proj.0", ("Dense_0",), LINEAR, True),
                 ("input_proj.1", ("LayerNorm_0",), NORM, False),
                 ("x_mask.0", ("Dense_1",), LINEAR, True),
                 ("x_mask.2", ("Dense_2",), LINEAR, True),
                 ("out_norm", ("LayerNorm_1",), NORM, False),
                 ("query", ("query",), RAW, False)]
        if "pe" in params:
            rules.append(("pe", ("pe",), RAW, False))
        for i, head in enumerate(("out_cls", "out_score", "out_paras")):
            rules += [(f"{head}.0", (f"Dense_{3 + 2 * i}",), LINEAR, True),
                      (f"{head}.2", (f"Dense_{4 + 2 * i}",), LINEAR, True)]
        for i in range(_count(params, "FFN")):
            rules += _attention_rules(f"cross_attention_layers.{i}.",
                                      (f"CrossAttentionLayer_{i}",), norm=False)
            rules += _attention_rules(f"self_attention_layers.{i}.",
                                      (f"SelfAttentionLayer_{i}",), norm=True)
            f = (f"FFN_{i}",)
            rules += [(f"ffn_layers.{i}.linear1", f + ("Dense_0",), LINEAR, True),
                      (f"ffn_layers.{i}.linear2", f + ("Dense_1",), LINEAR, True),
                      (f"ffn_layers.{i}.norm", f + ("LayerNorm_0",), NORM, False)]
        return rules
    raise ValueError(f"unknown model family {family!r}")


def leaf_pairs(kind: str, has_bias: bool) -> list[tuple[str, str]]:
    """(port/reference leaf name, flax leaf name) pairs of one rule."""
    if kind == NORM:
        return [("weight", "scale"), ("bias", "bias")]
    if kind == BN_STATS:
        return [("running_mean", "mean"), ("running_var", "var")]
    if kind == RAW:
        return [("", "")]
    return [("weight", "kernel")] + ([("bias", "bias")] if has_bias else [])


def _key(prefix: str, leaf: str) -> str:
    return f"{prefix}.{leaf}" if leaf else prefix


def _rules(family: str, params: Mapping | None = None) -> list[_Rule]:
    """The rules of ``family``, for the variant whose flax tree ``params``
    is (``None``: every key of the family's variants; the library families
    need the tree)."""
    if family == "flagship":
        if params is None:
            return build_rules(3, False) + build_rules(5, True) + build_rules(5, dual=True)
        return build_rules(3 if "DenseGN_6" in params else 5, "MLP_0" in params,
                           "OffsetPredModuleDual_0" in params)
    if family == "scene":
        return build_scene_rules(params is None or "instance_head" in params)
    if family == "sppnet":
        return build_sppnet_rules()
    if family == "splinenet":
        return build_splinenet_rules()
    return build_library_rules(family, params)


def key_kinds(family: str = "flagship") -> dict[str, str]:
    """Every port state_dict key the rules of a model family with reference
    checkpoints (``flagship``, ``scene``, ``sppnet``, ``splinenet``) cover,
    with its transform kind."""
    return {_key(prefix, leaf): kind
            for prefix, _, kind, has_bias in _rules(family)
            for leaf, _ in leaf_pairs(kind, has_bias)}


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
    (``family="flagship"``; a tree with ``DenseGN_6`` is a mode-3 model's,
    one with ``MLP_0`` an ``ablation`` model's, one with
    ``OffsetPredModuleDual_0`` a dual-attention model's), ``SoftGroupNet``
    (``family="scene"``; a tree without ``instance_head`` is a
    ``semantic_only`` model's), ``PrimitiveNetSPP`` (``"sppnet"``),
    ``DGCNNControlPoints`` (``"splinenet"``) or a library module
    (``build_library_rules``), as nested dicts of numpy arrays, -> a
    state_dict of the port's counterpart.

    Every transform is a transpose or a flip, so a gradient tree of the
    params maps the same way onto the port's ``.grad`` tensors (either
    family, ``semantic_only`` included); pass ``batch_stats=None`` to map
    the params alone, or a training step's new ``batch_stats`` to compare
    running statistics."""
    out: dict[str, torch.Tensor] = {}
    for prefix, fpath, kind, has_bias in _rules(family, params):
        if kind == BN_STATS and batch_stats is None:
            continue
        node = batch_stats if kind == BN_STATS else params
        for name in fpath:
            node = node[name]
        for leaf, fleaf in leaf_pairs(kind, has_bias):
            w = _from_flax(kind, leaf, np.asarray(node[fleaf] if fleaf else node, np.float32))
            out[_key(prefix, leaf)] = torch.from_numpy(np.array(w, order="C"))
    return out


# reference keys with no counterpart: dead weights (dgcnn-4.py:464-465, 911;
# the -2 model's seg attention, dgcnn-2.py:447), duplicate Sequential
# registrations of shared norms, BN step counters
KNOWN_UNUSED = (
    "mlp_squeeze_output_feature", "bn_normal_squeeze_output_feature",
    "encoder.conv1.1", "encoder.conv2.1", "encoder.conv3.1",
    "conv_normal.1", "offset_pred_block.conv1.1",
    "num_batches_tracked", "tiny_unet_outputlayer.1",
    "encoder.bn4", "encoder.bn5", "offset_pred_block.attention_seg",
)
_KNOWN_UNUSED_BY_FAMILY = {
    "splinenet": ("conv1.1", "conv2.1", "conv3.1", "conv4.1", "conv5.1",
                  "num_batches_tracked"),
}

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
    skipped: list[str] = dataclasses.field(default_factory=list)  # unexpected, known dead


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
    neither used nor a known dead/duplicate key (``KNOWN_UNUSED``; the
    report lists those as ``skipped``).  ``family`` is ``"flagship"`` (the
    ``-4`` and the dual-attention ``-2`` models), ``"sppnet"``,
    ``"splinenet"`` or ``"scene"``.  A ``family="scene"`` source is a port
    state_dict of ``SoftGroupNet`` or a ``torch.save`` of one (the reference
    SoftGroup's own checkpoints are not mapped).
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
    known = _KNOWN_UNUSED_BY_FAMILY.get(family, KNOWN_UNUSED)
    skipped = [k for k in unexpected if any(s in k for s in known)]
    report = LoadReport(sorted(loaded), sorted(missing), unexpected, skipped)
    unknown = [k for k in unexpected if k not in skipped]
    if strict and (missing or unknown):
        raise ValueError(f"checkpoint does not fit the model: missing {missing}, "
                         f"unknown keys {unknown}")
    model.load_state_dict(new, strict=False)
    return report
