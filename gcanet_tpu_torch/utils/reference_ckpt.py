"""Write a port model as a reference checkpoint (the port's counterpart of
``gcanet_tpu/utils/import_torch.py::export_state_dict`` /
``save_reference_checkpoint`` and ``tools/export_reference_ckpt.py``).

The output is a ``checkpoint_eval{N}.tar``-format file that the reference's
``load_checkpoint`` (trainer_new.py:120-142) restores, and that
``utils/from_jax.py::load_reference_checkpoint`` loads back: ``{epoch,
model_state_dict, optimizer_state_dict: {}}`` with ``affinitynet.*`` keys at
the reference's storage shapes (``reference_template``).  The inverse of the
loader's layout transforms:

* Dense / 1x1 conv ``[out, in]`` -> the stored ``[out, in, 1(, 1)]`` (and
  ``Custom1x1Subm3d``'s ``[out, 1, 1, 1, in]``);
* Conv3d ``[out, in, k, k, k]`` and ConvTranspose3d ``[in, out, k, k, k]``
  -> the template's layout, found by the JAX exporter's candidate order:
  spconv 1.x ``[k, k, k, in, out]``, then 2.x ``[out, k, k, k, in]``, then
  dense ``[out, in, k, k, k]``.  The port's transposed-conv taps are already
  in torch's (and spconv's) orientation: only flax kernels are flipped, on
  their way into the port, so nothing is flipped here;
* dead and counter keys at neutral defaults: zeros, ``running_var`` ones,
  ``num_batches_tracked`` 0.

The flagship in mode 5 only (the family the reference's trainer writes);
anything else raises ``ValueError``.  Orbax directories of the JAX package
are not read.

    python -m gcanet_tpu_torch.utils.reference_ckpt --log_dir log/run1 [--tag latest] --out e.tar
    python -m gcanet_tpu_torch.utils.reference_ckpt --checkpoint latest.tar --out e.tar
    python -m gcanet_tpu_torch.utils.reference_ckpt --selftest
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gcanet_tpu_torch.config import Config
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.utils import from_jax

Shape = Tuple[int, ...]


def reference_template(num_primitives: int = 7, out_dim: int = 64) -> Dict[str, Shape]:
    """The storage shape of every key of a mode-5 flagship reference
    checkpoint (trainer_new.py's ``model_state_dict`` of
    dgcnn-hais-concat-direct-4.py; the JAX package's
    ``make_synthetic_state_dict``), ``affinitynet.`` prefix included.
    ``num_batches_tracked`` counters are 0-d."""
    sd: Dict[str, Shape] = {}

    def conv1x1(name, cin, cout, bias=True, conv2d=False):
        sd[f"{name}.weight"] = (cout, cin, 1, 1) if conv2d else (cout, cin, 1)
        if bias:
            sd[f"{name}.bias"] = (cout,)

    def norm(name, c, stats=False):
        sd[f"{name}.weight"] = sd[f"{name}.bias"] = (c,)
        if stats:
            sd[f"{name}.running_mean"] = sd[f"{name}.running_var"] = (c,)
            sd[f"{name}.num_batches_tracked"] = ()

    def subm3(name, cin, cout, k=3, spconv2=True):
        sd[f"{name}.weight"] = (cout, k, k, k, cin) if spconv2 else (k, k, k, cin, cout)

    def res_block(prefix, cin, cout, identity=False):
        norm(f"{prefix}.conv_branch.0", cin, stats=True)
        subm3(f"{prefix}.conv_branch.2", cin, cout)
        norm(f"{prefix}.conv_branch.3", cout, stats=True)
        subm3(f"{prefix}.conv_branch.5", cout, cout, spconv2=False)
        if identity:
            sd[f"{prefix}.i_branch.0.weight"] = (cout, 1, 1, 1, cin)

    # encoder
    conv1x1("encoder.conv1.0", 12, 64, bias=False, conv2d=True)
    norm("encoder.bn1", 64)
    conv1x1("encoder.conv2.0", 128, 64, bias=False, conv2d=True)
    norm("encoder.bn2", 64)
    conv1x1("encoder.conv3.0", 128, 128, bias=False, conv2d=True)
    norm("encoder.bn3", 128)
    conv1x1("encoder.mlp1", 256, 1024)
    norm("encoder.bnmlp1", 1024)
    # trunk and heads
    conv1x1("conv1", 1280, 512)
    norm("bn1", 512)
    conv1x1("conv2", 512, 256)
    norm("bn2", 256)
    conv1x1("mlp_prim_prob1", 256, 256)
    norm("bn_prim_prob1", 256)
    conv1x1("mlp_prim_prob2", 256, num_primitives)
    conv1x1("mlp_param_prob1", 256, 256)
    norm("bn_param_prob1", 256)
    conv1x1("mlp_param_prob2", 256, 22)
    conv1x1("mlp_seg_prob1", 832, 256)
    norm("bn_seg_prob1", 256)
    conv1x1("mlp_seg_prob2", 256, out_dim)
    conv1x1("conv_normal.0", 7, 64, bias=False, conv2d=True)
    norm("bn_normal", 64)
    conv1x1("conv3", 262, 128)
    norm("bn3", 128)
    # offset module
    conv1x1("offset_pred_block.conv1.0", 131, 128, bias=False, conv2d=True)
    norm("offset_pred_block.bn1", 128)
    conv1x1("offset_pred_block.attention.conv1.0", 30, 30, bias=False)
    conv1x1("offset_pred_block.attention.conv1.2", 30, 30, bias=False)
    conv1x1("offset_pred_block.mlp_offset", 256, 3)
    # instance head
    for name, cout in (("cls_linear", num_primitives), ("iou_score_linear", num_primitives),
                       ("mask_linear.0", 64), ("mask_linear.2", num_primitives)):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = (cout, 64), (cout,)
    norm("tiny_unet_outputlayer.0", 64, stats=True)
    # tiny U-Net
    res_block("tiny_unet.blocks.block0", 64, 64)
    res_block("tiny_unet.blocks.block1", 64, 64)
    norm("tiny_unet.conv.0", 64, stats=True)
    subm3("tiny_unet.conv.2", 64, 128, k=2)
    res_block("tiny_unet.u.blocks.block0", 128, 128)
    res_block("tiny_unet.u.blocks.block1", 128, 128)
    norm("tiny_unet.deconv.0", 128, stats=True)
    subm3("tiny_unet.deconv.2", 128, 64, k=2, spconv2=False)
    res_block("tiny_unet.blocks_tail.block0", 128, 64, identity=True)
    res_block("tiny_unet.blocks_tail.block1", 64, 64)
    # dead weights present in real checkpoints
    conv1x1("mlp_squeeze_output_feature", 99 if num_primitives == 7 else 102, 64)
    norm("bn_normal_squeeze_output_feature", 64)
    return {f"affinitynet.{k}": v for k, v in sd.items()}


# candidate stored layouts of a 5-d kernel, as permutations of [k, k, k, in,
# out], in the JAX exporter's order: spconv 1.x, spconv 2.x, torch dense
_STORED_PERMS = ((0, 1, 2, 3, 4), (1, 2, 3, 4, 0), (2, 3, 4, 1, 0))
# the port's 5-d kernels as [k, k, k, in, out]: Conv3d [out, in, k, k, k],
# ConvTranspose3d [in, out, k, k, k]
_TO_KKKIO = {from_jax.CONV3D: (2, 3, 4, 1, 0), from_jax.DECONV3D: (2, 3, 4, 0, 1)}


def _to_stored(kind: str, w: torch.Tensor, shape: Shape) -> torch.Tensor:
    if kind in _TO_KKKIO:
        w = w.permute(_TO_KKKIO[kind])
        for perm in _STORED_PERMS:
            if tuple(shape[i] for i in perm) == tuple(w.shape):
                return w.permute(tuple(np.argsort(perm))).contiguous()
        raise ValueError(f"cannot map a {kind} kernel {tuple(w.shape)} to {shape}")
    if kind == from_jax.LINEAR and w.numel() == int(np.prod(shape)):
        return w.reshape(shape)
    if tuple(w.shape) == shape:
        return w
    raise ValueError(f"cannot map a {kind} tensor {tuple(w.shape)} to {shape}")


@dataclasses.dataclass
class ExportReport:
    mapped: List[str]       # reference keys filled from the model
    defaulted: List[str]    # reference keys left at a neutral default
    missing: List[str]      # rule targets absent from the model's state_dict


def _check_exportable(model: nn.Module) -> Config:
    if not isinstance(model, PrimitiveNet):
        what = type(model).__name__
    else:
        cfg = model.cfg
        if cfg.mode == 5 and not cfg.ablation and cfg.offset_variant == "kpam":
            return cfg
        what = f"mode={cfg.mode}, ablation={cfg.ablation}, offset_variant={cfg.offset_variant!r}"
    raise ValueError(f"the reference-checkpoint writer maps the mode-5 flagship "
                     f"(dgcnn-hais-concat-direct-4) only; got {what}")


def export_reference_state_dict(model: nn.Module, num_primitives: Optional[int] = None,
                                out_dim: Optional[int] = None
                                ) -> Tuple[Dict[str, torch.Tensor], ExportReport]:
    """``model`` (a mode-5 flagship ``PrimitiveNet``) -> ``(state_dict,
    report)``: CPU tensors under ``affinitynet.`` keys at the reference's
    storage shapes.  ``num_primitives`` / ``out_dim`` default to the
    model's config."""
    cfg = _check_exportable(model)
    template = reference_template(num_primitives or cfg.num_primitives,
                                  out_dim or cfg.out_dim)
    sd: Dict[str, torch.Tensor] = {}
    for k, shape in template.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.int64)
        elif k.endswith("running_var"):
            sd[k] = torch.ones(shape)
        else:
            sd[k] = torch.zeros(shape)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    mapped, missing = [], []
    for prefix, _, kind, has_bias in from_jax.build_rules(cfg.mode):
        for leaf, _ in from_jax.leaf_pairs(kind, has_bias):
            key = f"{prefix}.{leaf}"
            tkey = f"affinitynet.{key}"
            if tkey not in sd:
                continue                    # not a checkpointed tensor
            if key not in state:
                missing.append(key)
                continue
            sd[tkey] = _to_stored(kind, state[key], template[tkey]).to(torch.float32).clone()
            mapped.append(tkey)
    done = set(mapped)
    return sd, ExportReport(sorted(mapped), sorted(k for k in sd if k not in done),
                            sorted(missing))


def save_reference_checkpoint(path: str, model: nn.Module, epoch: int = 0,
                              **export_kw) -> ExportReport:
    """``torch.save({epoch, model_state_dict, optimizer_state_dict: {}})`` of
    ``export_reference_state_dict(model)`` at ``path``."""
    sd, report = export_reference_state_dict(model, **export_kw)
    torch.save({"epoch": int(epoch), "model_state_dict": sd, "optimizer_state_dict": {}}, path)
    return report


def selftest(num_primitives: int = 7, out_dim: int = 64) -> ExportReport:
    """The template filled from a seed -> ``load_reference_checkpoint`` ->
    export: every mapped tensor must come back bit for bit."""
    rng = np.random.RandomState(0)
    ref = {k: (torch.tensor(7) if k.endswith("num_batches_tracked")
               else torch.from_numpy(rng.randn(*shape).astype(np.float32)))
           for k, shape in reference_template(num_primitives, out_dim).items()}
    model = _model(num_primitives, out_dim)
    from_jax.load_reference_checkpoint(model, ref)
    sd, report = export_reference_state_dict(model)
    bad = [k for k in report.mapped if not torch.equal(sd[k], ref[k])]
    if bad or report.missing:
        raise RuntimeError(f"round trip differs at {bad[:5]}, missing {report.missing[:5]}")
    return report


def _model(num_primitives: int, out_dim: int) -> nn.Module:
    # widths only: the points, neighbours and proposals shape no weight
    return PrimitiveNet(Config(num_primitives=num_primitives, out_dim=out_dim))


def main(argv: Optional[List[str]] = None) -> ExportReport:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", help="a checkpoint file of the port (Trainer's *.tar)")
    ap.add_argument("--log_dir", help="a training workspace: reads <log_dir>/checkpoint/<tag>.tar")
    ap.add_argument("--tag", default="latest", help="checkpoint tag (latest, max_miou, evalN)")
    ap.add_argument("--out", default="checkpoint_export.tar")
    ap.add_argument("--num_primitives", type=int, default=7)
    ap.add_argument("--out_dim", type=int, default=64)
    ap.add_argument("--selftest", action="store_true",
                    help="load a seeded reference-shaped state_dict, export it back and "
                         "require the round trip bit for bit")
    args = ap.parse_args(argv)
    if args.selftest:
        report = selftest(args.num_primitives, args.out_dim)
        print(f"selftest OK: {len(report.mapped)} tensors round-trip bit for bit; "
              f"{len(report.defaulted)} dead/counter keys at neutral defaults")
        return report
    path = args.checkpoint or (args.log_dir and
                               os.path.join(args.log_dir, "checkpoint", f"{args.tag}.tar"))
    if not path:
        ap.error("--checkpoint or --log_dir is required (or --selftest)")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model = _model(args.num_primitives, args.out_dim)
    from_jax.load_reference_checkpoint(model, ckpt.get("model_state_dict", ckpt))
    epoch = int(ckpt.get("epoch", 0))
    report = save_reference_checkpoint(args.out, model, epoch=epoch)
    print(f"wrote {args.out}: {len(report.mapped)} tensors (epoch {epoch}); "
          f"{len(report.defaulted)} dead/counter keys at neutral defaults")
    return report


if __name__ == "__main__":
    main()
