"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build every hand-written kernel from ``gcanet_tpu_torch/csrc`` (one
     ``nvcc`` per source, all started together) and print the build times;
  3. kernel check: each kernel against its plain PyTorch version on the card
     (random graphs of several densities, a 300-chain, an empty row, odd N,
     padded row strides, uint8 input), exact equality;
  4. card against CPU: the port's model on both, reduced size (N=2048,
     P=24), TF32 off; floats to a stated tolerance, and proposals, voxel
     occupancy and merged labels exactly on identical inputs (grouping is a
     hard threshold on floats; the end-to-end drift is printed);
  5. serving at full width (default ``Config``: N=7000, K=48, P=100, grid
     16): a few ``predict`` calls, then ``predict_batch`` at B=4, with every
     kernel's launch count set to 0 just before and read just after; then
     each kernel timed on the main path's own input beside its plain
     version and its bound;
  6. where the time goes: ``torch.profiler`` over two full-width
     ``predict_batch`` calls: device busy share and the top kernels;
  7. a train step, card against CPU (N=2048, B=2, TF32 off), from the same
     weights, batch and grid shift, with the card's top-k selections and
     proposals replayed on the CPU: every loss, the gradient of every
     parameter tensor, the new batch statistics; run with the instance head
     in fp32 (every gradient to the fp32 tolerance) and in bf16, the
     default (see ``TRAIN_*`` for what is held how); proposals exactly on
     identical inputs;
  8. training at full width (default ``Config``, B=3) through
     ``Trainer.train_one_epoch``: a warm-up epoch, then an epoch of 2
     warm-up and 5 timed steps with the launch counts set to 0 just before
     and read just after: ms/step, examples/s, peak memory, every step's
     losses (all finite), the CC kernel's launches per step and sweeps per
     cloud;
  9. ``torch.profiler`` over two full-width train steps, forward and
     backward together;
 10. the eval step, card against CPU (N=2048, TF32 off), top-k selections
     and proposals replayed: every loss, and the merged labels exactly;
 11. the CLI entry point at full width, in-process:
     ``gcanet_tpu_torch.train_new.main`` trains 2 epochs of 2 synthetic
     batches (B=3), evaluating the 8 synthetic eval clouds (B=1) after each
     and keeping its checkpoints; then ``main([..., "--eval"])`` evaluates
     ``latest.tar`` again and must reproduce epoch 1's record; the host
     ``get_instances`` + ``merge_masks`` must give the card's merged labels
     on each eval cloud.  ms per train step (CUDA events), ms per eval cloud
     (host clock around ``test_one_epoch``), the CC kernel's launches in
     each run, and eval's peak memory.
 12. the scene family, card against CPU (``SoftGroupNet`` through
     ``ScenePredictor``, N=2048, B=2, scene grid 32, 20 classes, the
     scannetv2 grouping recipe, TF32 off), with the U-Net in fp32 and in
     bf16: semantic scores and offsets to a tolerance; the card's shifted
     coordinates and logits through the CPU's ``build_soft_proposals`` give
     the card's proposals exactly; on those proposals (replayed on the
     CPU) the instance head to the bf16 tolerance and the kept instances
     and masks exactly;
 13. scene serving at full width (N=8192, grid 64, 32 channels, 20
     classes, 18 grouped, ``max_proposals`` 100): 3 ``predict``, 3
     ``predict_batch`` at B=8 and ``predict_stream`` over the same 3
     batches at depth 2, with the launch counts set to 0 just before and
     read just after; the stream's dicts against the batches'; then the
     sweep timed on one of the path's own N=8192 class masks;
 14. ``torch.profiler`` over two full-width scene ``predict_batch`` calls:
     device busy share, top ops, the CC kernel's share;
 15. a scene train step, card against CPU (N=2048, B=2, scene grid 32, 20
     classes, TF32 off) with the U-Net in fp32 and in bf16, from the same
     weights, batch and grid shift, the card's proposals replayed on the
     CPU: every loss, the gradients, the new batch statistics (see
     ``SCENE_*``); the CPU's grouping on the card's inputs gives the card's
     proposals exactly;
 16. scene training at full width (N=8192, B=8, grid 64, 32 channels, 20
     classes, bf16 U-Net, ``max_proposals`` 100, Adam 1e-3) through
     ``SceneTrainer.train_one_epoch``: a warm-up epoch, then 2 warm-up and 5
     timed steps with the launch counts set to 0 just before and read just
     after: ms/step, scenes/s, peak memory, every step's losses (finite), CC
     launches per step and sweeps per class per scene; ``test_one_epoch`` on
     the 8 synthetic scenes (ms per scene, the AP/PQ keys, kept instances);
     then ``train_new.main`` with ``--model_dict softgroup.model.softgroup``
     trains 2 epochs of 2 batches and ``--eval`` on ``latest.tar`` must
     reproduce epoch 1's record; then the sweep timed on one of the
     training path's own class masks;
 17. ``torch.profiler`` over two full-width scene train steps: device busy
     share, top ops, the CC kernel's share.
Weights are random from a seed, with pushes so that the path after
grouping does real work (``push_weights``, ``push_scene_weights``).  Each
phase prints its seconds.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gcanet_tpu_torch import train_new
from gcanet_tpu_torch.config import (Config, GroupingConfig, InstanceHeadConfig,
                                     scene_grouping_defaults)
from gcanet_tpu_torch.data.synthetic import synth_batch, synth_clouds, synth_scene_batch
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet
from gcanet_tpu_torch.ops import cc
from gcanet_tpu_torch.ops import grouping as grouping_ops
from gcanet_tpu_torch.ops import voxelize as vox_ops
from gcanet_tpu_torch.serve import Predictor, ScenePredictor
from gcanet_tpu_torch.train import instances as inst_utils
from gcanet_tpu_torch.train import scene_step
from gcanet_tpu_torch.train import step as step_lib
from gcanet_tpu_torch.train import trainer as trainer_mod
from gcanet_tpu_torch.train.scene_trainer import SceneTrainer
from gcanet_tpu_torch.train.trainer import Trainer
from gcanet_tpu_torch.utils import kernels
from gcanet_tpu_torch.utils.transfer import fetch

# memory rates of the cards this runs on (NVIDIA data sheets), bytes/s
HBM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12, "H200": 4.8e12}

# (wrapper, source, TPU function it replaces)
KERNELS = [(cc.masked_min_sweep, cc.SOURCE, "gcanet_tpu/ops/cc_pallas.py:73")]

# fp32 in another summation order, over ~20 layers of dot products up to
# 1280 long and group norms (measured on an H100: at most 1.1e-4 on values
# of order 1-10)
CARD_VS_CPU_FLOAT = dict(rtol=1e-3, atol=1e-3)
CARD_VS_CPU_BF16 = dict(rtol=3e-2, atol=3e-2)     # out of the bf16 instance head

# the train step, card against CPU: losses; gradients, elementwise, with
# atol a share of the largest entry of that loss's whole gradient; new
# batch statistics.  A gradient is not a continuous function of the
# forward's floats: where a max over neighbours or a ReLU sits on a
# near-tie, last-bit differences send a gradient entry elsewhere.  So the
# card and the CPU differ in the gradient by more than in the loss (on an
# H100: at most 1.7e-4 of the largest entry for the gradient of
# total - inst_loss, 6.5e-3 for that of inst_loss through the head's 15
# batch norms and ReLUs).  The gradient of inst_loss through the
# bf16 U-Net moves by tens of percent with any change of rounding (bf16
# against fp32 within one device, or one framework against another;
# tests/test_torch_train_step.py), so in bf16 it is held by its cosine to
# the CPU's; the check of that path to a tolerance is the run with the
# head in fp32.  The weights are pushed (``push_weights``) so that no mask
# score sits near the 0.5 threshold of the IoU target.
TRAIN_LOSS = dict(rtol=1e-3, atol=1e-4)
TRAIN_GRAD_RTOL = 1e-3
TRAIN_GRAD_ATOL_SHARE = {"rest": 1e-3, "inst": 2e-2}
TRAIN_STATS = dict(rtol=1e-3, atol=1e-5)
TRAIN_BF16_MIN_COSINE = 0.9

# ``main([..., "--eval"])`` on latest.tar against the training run's last
# eval record: the same weights on the same clouds; the losses sum in
# another order where float atomics (index_add_) do, the metrics are exact
EVAL_REPEAT_LOSS_RTOL = 1e-5

# the scene train step, card against CPU: the point-wise losses and their
# gradient (the trunk's) as the flagship's with the U-Net in fp32; with the
# bf16 U-Net the losses at CARD_VS_CPU_BF16 and the gradient by its cosine.
# The instance branch runs through the bf16 head either way: its losses at
# CARD_VS_CPU_BF16 and its gradient by cosine, as the flagship's bf16 head.
SCENE_MIN_COSINE = 0.9

# ``--eval`` of a scene checkpoint against the training run's record: the
# voxel means sum with float atomics on the card, so two evaluations of
# one checkpoint may differ in the logits' last bits, which can move a
# point's argmax or swap two tied confidences.  Exact, or else every metric
# within this absolute difference (and which differed is printed).
SCENE_EVAL_REPEAT_ATOL = 0.02


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def hbm_rate(name: str) -> float:
    for key in sorted(HBM_RATE, key=len, reverse=True):
        if key in name:
            return HBM_RATE[key]
    raise RuntimeError(f"no memory rate known for {name!r}")


def push_weights(model: torch.nn.Module) -> None:
    """Random weights leave everything after grouping idle; push them so
    proposals pass the instance thresholds: small live offsets, +10 on class
    0's instance-class bias and on the mask MLP's last bias."""
    with torch.no_grad():
        model.offset_pred_block.mlp_offset.weight.mul_(0.05)
        model.cls_linear.bias[0] += 10.0
        model.mask_linear[2].bias += 10.0


def push_scene_weights(model: torch.nn.Module) -> None:
    """The scene model's push: +4.0 and +3.5 on the semantic biases of
    classes 2 and 3 (the first two grouped classes: soft subsets that
    overlap, every blob a proposal in each), small live offsets, and the
    instance head's class-0 and mask biases as in ``push_weights``."""
    with torch.no_grad():
        model.semantic_linear[2].bias[2] += 4.0
        model.semantic_linear[2].bias[3] += 3.5
        model.offset_linear[2].weight.mul_(0.05)
        model.instance_head.cls_linear.bias[0] += 10.0
        model.instance_head.mask_linear[2].bias += 10.0


def scene_config(n: int) -> Config:
    """The scene serving configuration at ``n`` points: ScanNet v2's 20
    classes, the scannetv2 grouping recipe (classes 0/1 not grouped), the
    mean table at the synthetic scenes' instance size ``n / 5``."""
    return Config(model_dict="softgroup.model.softgroup", num_points=n, num_primitives=20,
                  grouping=scene_grouping_defaults(GroupingConfig(),
                                                   class_numpoint_mean=(n / 5.0,) * 20))


def time_graph(fn, iters: int) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph,
    replayed after a warm-up, timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def _reset_launches() -> None:
    for wrapper, _, _ in KERNELS:
        wrapper.launches = 0


def _launches() -> dict:
    return {w.__name__: w.launches for w, _, _ in KERNELS}


# ---------------------------------------------------------------- phases

def phase_card() -> tuple[str, str]:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[card] nvidia-smi: {smi}")
    name = torch.cuda.get_device_name(0)
    print(f"[card] torch: {name}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()

    def one(source):
        t = time.perf_counter()
        path, log = kernels.build(source)
        return source, path, log, time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        results = list(pool.map(one, [src for _, src, _ in KERNELS]))
    for source, path, log, secs in results:
        print(f"[build] {source} -> {path.name} in {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")


def _graph(n: int, p: float, gen: torch.Generator) -> torch.Tensor:
    a = torch.rand(n, n, generator=gen, device="cuda") < p
    a = torch.triu(a, 1)
    return a | a.t()


def phase_kernel_check() -> float:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for n in (7000, 1001):
        for p in (0.0, 1e-4, 1e-3, 1e-2, 0.2):
            cases.append((f"random n={n} p={p}", _graph(n, p, gen)))
    chain = torch.zeros(7000, 7000, dtype=torch.bool, device="cuda")
    i = torch.arange(299, device="cuda")
    chain[i, i + 1] = True
    chain[i + 1, i] = True
    cases.append(("300-chain n=7000", chain))
    empty = _graph(7000, 1e-3, gen)
    empty[5] = False
    empty[:, 5] = False
    cases.append(("empty row n=7000", empty))
    for n, pad in ((7000, 3), (1001, 16)):      # rows at odd offsets, and padded
        base = torch.zeros(n, n + pad, dtype=torch.bool, device="cuda")
        base[:, :n] = _graph(n, 1e-3, gen)
        cases.append((f"row stride {n + pad} n={n}", base[:, :n]))
    cases.append(("uint8 n=7000", _graph(7000, 1e-3, gen).to(torch.uint8)))

    max_err = 0
    for name, nbr in cases:
        n = nbr.shape[0]
        labels = torch.randperm(n, generator=gen, device="cuda").to(torch.int32)
        got = cc.masked_min_sweep(nbr, labels)
        want = cc.masked_min_sweep_plain(nbr, labels)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if n else 0
        max_err = max(max_err, err)
        cc_got = cc.connected_components(nbr)
        cc_want = cc.connected_components(nbr.cpu())
        same_cc = torch.equal(cc_got.cpu(), cc_want)
        print(f"[kernel] masked_min_sweep {name}: max_abs_err {err}, "
              f"connected_components equal to the CPU loop: {same_cc}")
        check(err == 0 and same_cc, f"masked_min_sweep disagrees on {name}")
    check(bool((cc.masked_min_sweep(empty, torch.arange(7000, dtype=torch.int32,
                                                        device="cuda"))[5]
                == cc.BIG_LABEL).item()), "empty row sentinel")
    return float(max_err)


def _model_inputs_to_grouping(out, xyz):
    b, n, _ = xyz.shape
    return ((xyz + out.pt_offsets.reshape(b, n, 3)).float(),
            out.semantic_scores.reshape(b, n, -1).argmax(-1).to(torch.int32),
            out.embedding.float(), out.param_per_point.float())


class TopkReplay:
    """Stands in for ``torch.topk`` while the card and then the CPU run the
    same forward.  Top-k over near-equal values (the kNN distances and the
    offset module's similarities of a random-weight net) may select other
    rows on the two devices, and one swapped neighbour moves a point's
    features far beyond rounding.  So the card's selections are recorded,
    the CPU counts the rows where its own selection differs, and then
    gathers its values at the card's indices: the float comparison after
    that measures arithmetic, not tie-breaking."""

    def __init__(self):
        self.real = torch.topk
        self.recorded, self.differing = [], []
        self.replaying = False

    def __enter__(self):
        torch.topk = self
        return self

    def __exit__(self, *exc):
        torch.topk = self.real

    def __call__(self, x, k, dim=-1, largest=True, sorted=True):
        res = self.real(x, k, dim=dim, largest=largest, sorted=sorted)
        if not self.replaying:
            self.recorded.append(res.indices.cpu())
            return res
        idx = self.recorded[len(self.differing)].to(x.device)
        rows = (res.indices != idx).any(dim=-1)
        self.differing.append((int(rows.sum()), rows.numel()))
        return TopkResult(torch.gather(x, dim, idx), idx)


class TopkResult(tuple):
    def __new__(cls, values, indices):
        return super().__new__(cls, (values, indices))

    values = property(lambda self: self[0])
    indices = property(lambda self: self[1])


def _to(props, device):
    return type(props)(*(t.to(device) for t in props))


class ProposalReplay:
    """Stands in for ``grouping_ops.<name>`` (``build_proposals`` or
    ``build_soft_proposals``) while the card and then the CPU run the same
    step.  Grouping is a hard threshold on floats that differ in the last
    bits between the devices, so the card's proposals are recorded and
    handed to the CPU, which records whether its own were equal; grouping
    itself is checked on identical inputs apart."""

    def __init__(self, name: str = "build_proposals"):
        self.name = name
        self.real = getattr(grouping_ops, name)
        self.recorded, self.own_equal = [], []
        self.replaying = False

    def __enter__(self):
        setattr(grouping_ops, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(grouping_ops, self.name, self.real)

    def __call__(self, shifted, *args, **kw):
        props = self.real(shifted, *args, **kw)
        if not self.replaying:
            self.recorded.append(props)
            return props
        card = _to(self.recorded[len(self.own_equal)], shifted.device)
        self.own_equal.append(all(torch.equal(a, b) for a, b in zip(props, card)))
        return card


def _head_and_merge(model, cfg, props, xyz, emb):
    b, n, _ = xyz.shape
    ih = cfg.instance_head
    vx = vox_ops.clusters_voxelization(xyz.reshape(b * n, 3), emb.reshape(b * n, -1),
                                       props.point_pid, ih.max_proposals, ih.grid_size)
    head = model.instance_head(vx.feats, vx.active, vx.entry_voxel, props.point_pid)
    merged = inst_utils.merged_labels_device(props.point_pid, head.cls_scores,
                                             head.iou_scores, head.mask_scores,
                                             props.valid, cfg.num_primitives)
    return vx, head, merged


def phase_card_vs_cpu() -> None:
    """The card against the CPU on one input.  The network's floats agree
    to a tolerance, with the card's top-k selections replayed on the CPU
    (``TopkReplay``); grouping and instance extraction are hard thresholds
    on those floats (radius, embedding gate, class argmax), so they are
    held exactly on IDENTICAL inputs on both devices, and the end-to-end
    drift is reported."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(num_points=2048, instance_head=InstanceHeadConfig(max_proposals=24))
    cpu = Predictor(cfg, device="cpu")
    push_weights(cpu.model)
    card = Predictor(cfg, checkpoint=cpu.model.state_dict(), device="cuda")
    xyz, nrm = synth_clouds(cfg, 2, seed=1)
    xyz_cpu, nrm_cpu = torch.as_tensor(xyz), torch.as_tensor(nrm)
    xyz_card, nrm_card = xyz_cpu.cuda(), nrm_cpu.cuda()
    with torch.inference_mode():
        with TopkReplay() as topk:
            out_card = card.model(xyz_card, nrm_card)
            topk.replaying = True
            out_cpu = cpu.model(xyz_cpu, nrm_cpu)
        print(f"[card-vs-cpu] top-k rows the CPU alone would select differently, per "
              f"call (replaced by the card's selection): {topk.differing}")

        for name in ("type_per_point", "param_per_point", "semantic_scores",
                     "embedding", "pt_offsets"):
            g, w = getattr(out_card, name).cpu(), getattr(out_cpu, name)
            check(bool(torch.isfinite(g).all()), f"{name} not finite")
            err = float((g - w).abs().max())
            ok = torch.allclose(g, w, **CARD_VS_CPU_FLOAT)
            print(f"[card-vs-cpu] {name}: max_abs_err {err:.3g} of max |x| "
                  f"{float(w.abs().max()):.3g} "
                  f"(rtol {CARD_VS_CPU_FLOAT['rtol']}, atol {CARD_VS_CPU_FLOAT['atol']}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"{name} differs between card and CPU")

        # grouping on identical inputs: the CPU forward's, on both devices
        g_cpu = _model_inputs_to_grouping(out_cpu, xyz_cpu)
        g_card = tuple(t.cuda() for t in g_cpu)
        kw = dict(num_classes=cfg.num_primitives, cfg=cfg.grouping,
                  max_proposals=cfg.instance_head.max_proposals)
        props_cpu = grouping_ops.build_proposals(*g_cpu, **kw)
        props_card = grouping_ops.build_proposals(*g_card, **kw)
        for field in props_cpu._fields:
            check(torch.equal(getattr(props_card, field).cpu(), getattr(props_cpu, field)),
                  f"proposals.{field} differs between card and CPU on the same inputs")
        print(f"[card-vs-cpu] proposals on identical inputs: equal "
              f"(num {int(props_cpu.num)}, sizes {props_cpu.size.tolist()})")

        # voxelisation, instance head and merged labels on identical inputs
        vx_cpu, head_cpu, merged_cpu = _head_and_merge(cpu.model, cfg, props_cpu,
                                                       xyz_cpu, g_cpu[2])
        vx_card, head_card, merged_card = _head_and_merge(
            card.model, cfg, _to(props_cpu, "cuda"), xyz_card, g_card[2])
        check(torch.equal(vx_card.active.cpu(), vx_cpu.active)
              and torch.equal(vx_card.entry_voxel.cpu(), vx_cpu.entry_voxel),
              "voxel occupancy differs between card and CPU")
        for name in ("cls_scores", "iou_scores", "mask_scores"):
            g, w = getattr(head_card, name).cpu(), getattr(head_cpu, name)
            err = float((g - w).abs().max())
            ok = torch.allclose(g, w, **CARD_VS_CPU_BF16)
            print(f"[card-vs-cpu] instance head {name} (bf16): max_abs_err {err:.3g} "
                  f"(rtol {CARD_VS_CPU_BF16['rtol']}, atol {CARD_VS_CPU_BF16['atol']}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"instance head {name} differs between card and CPU")
        for name, g, w in zip(("merged", "keep", "conf", "npoint", "covered"),
                              merged_card, merged_cpu):
            g = g.cpu()
            if g.dtype.is_floating_point:
                check(torch.allclose(g, w, **CARD_VS_CPU_BF16), f"{name} differs")
            else:
                check(torch.equal(g, w), f"{name} differs between card and CPU")
        kept = int(merged_cpu[1].sum())
        print(f"[card-vs-cpu] merged labels, keep, npoint, covered on identical inputs: "
              f"equal (kept instances {kept}, covered points {int(merged_cpu[4].sum())})")
        check(int(props_cpu.num) > 0 and kept > 0, "the reduced run did no work")

        # end to end: the card's forward against the CPU's (top-k replayed)
        g_own = _model_inputs_to_grouping(out_card, xyz_card)
        nbr_own, _ = grouping_ops.gated_neighbor_mask(*(t[0] for t in g_own),
                                                      cfg.num_primitives, cfg.grouping)
        nbr_same, _ = grouping_ops.gated_neighbor_mask(*(t[0] for t in g_card),
                                                       cfg.num_primitives, cfg.grouping)
        flips = int((nbr_own != nbr_same).sum())
        same_pid = float((out_card.proposals.point_pid.cpu()
                          == out_cpu.proposals.point_pid).float().mean())
        print(f"[card-vs-cpu] end to end (CPU with the card's top-k): proposals.num card "
              f"{int(out_card.proposals.num)} / CPU {int(out_cpu.proposals.num)}, "
              f"point_pid equal at {same_pid:.4%} of entries, gated-mask entries "
              f"flipped by the float differences (cloud 0): {flips} of {int(nbr_same.sum())}")


def dict_difference(g: dict, w: dict) -> str | None:
    """The first key where two prediction dicts differ, or None: arrays of
    integers and instance lists (labels, npoint, RLE) exactly, floats at
    ``CARD_VS_CPU_FLOAT``."""
    if g.keys() != w.keys():
        return "keys"
    for key, value in w.items():
        if isinstance(value, np.ndarray) and value.dtype.kind == "f":
            same = np.allclose(g[key], value, **CARD_VS_CPU_FLOAT)
        elif isinstance(value, np.ndarray):
            same = np.array_equal(g[key], value)
        elif key == "instances":
            same = ([(i["label_id"], i["npoint"], i["pred_mask"]) for i in g[key]]
                    == [(i["label_id"], i["npoint"], i["pred_mask"]) for i in value]
                    and np.allclose([i["conf"] for i in g[key]], [i["conf"] for i in value],
                                    **CARD_VS_CPU_FLOAT))
        else:
            same = g[key] == value
        if not same:
            return key
    return None


def same_dicts(got: list[dict], want: list[dict]) -> bool:
    return len(got) == len(want) and all(dict_difference(g, w) is None
                                         for g, w in zip(got, want))


def phase_serving(card_name: str, max_err: float) -> list[dict]:
    cfg = Config()
    n, b, reps = cfg.num_points, 4, 3
    pred = Predictor(cfg, device="cuda")
    push_weights(pred.model)
    xyz, nrm = synth_clouds(cfg, b, seed=2)
    pred.predict(xyz[0], nrm[0])                         # warm-up
    pred.predict_batch(xyz, nrm)
    torch.cuda.synchronize()

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    singles = [pred.predict(xyz[i], nrm[i]) for i in range(reps)]
    t_single = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        batch = pred.predict_batch(xyz, nrm)
    t_batch = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    clouds = reps + reps * b

    # predict_stream over two batches: predict_batch's dicts, in order
    t0 = time.perf_counter()
    stream = list(pred.predict_stream([(xyz, nrm)] * 2, depth=2))
    t_stream = time.perf_counter() - t0
    check(len(stream) == 2 * b and same_dicts(stream[:b], batch)
          and same_dicts(stream[b:], batch), "predict_stream differs from predict_batch")

    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    for r in singles + batch:
        check(r["type_per_point"].shape == (n, 7) and r["param_per_point"].shape == (n, 22)
              and r["pt_offsets"].shape == (n, 3) and r["instance_labels"].shape == (n,),
              "output shapes")
        check(all(np.isfinite(r[k]).all() for k in
                  ("type_per_point", "param_per_point", "pt_offsets")), "finite outputs")

    with torch.inference_mode():
        xt = torch.as_tensor(xyz, device="cuda")
        out = pred.model(xt, torch.as_tensor(nrm, device="cuda"))
    print(f"[serve] N={n} B={b} K={cfg.nn_nb} P={cfg.instance_head.max_proposals} "
          f"grid={cfg.instance_head.grid_size}: proposals.num {int(out.proposals.num)}, "
          f"kept instances per cloud {[len(r['instances']) for r in batch]}")
    print(f"[serve] predict: {t_single * 1e3:.1f} ms/cloud; predict_batch B={b}: "
          f"{b * reps / t_batch:.2f} clouds/s ({t_batch / reps * 1e3:.1f} ms/batch); "
          f"peak memory {peak / 2**30:.2f} GiB")
    print(f"[serve] launches on the main path ({clouds} clouds): {launches}; "
          f"masked_min_sweep sweeps per cloud {launches['masked_min_sweep'] / clouds:.1f}")
    print(f"[serve] predict_stream B={b}, 2 batches, depth 2: {2 * b / t_stream:.2f} clouds/s; "
          f"its dicts equal predict_batch's")

    # the sweep on the main path's own input: cloud 0's gated mask
    shifted = (xt + out.pt_offsets.reshape(b, n, 3))[0]
    cls0 = out.semantic_scores.reshape(b, n, -1)[0].argmax(-1).to(torch.int32)
    nbr, _ = grouping_ops.gated_neighbor_mask(
        shifted, cls0, out.embedding[0], out.param_per_point[0],
        cfg.num_primitives, cfg.grouping)
    labels = torch.arange(n, dtype=torch.int32, device="cuda")
    check(torch.equal(cc.masked_min_sweep(nbr, labels),
                      cc.masked_min_sweep_plain(nbr, labels)), "sweep on the main-path mask")
    ms = time_graph(lambda: cc.masked_min_sweep(nbr, labels), 100)
    plain_ms = time_graph(lambda: cc.masked_min_sweep_plain(nbr, labels), 10)
    nbytes = n * n + 4 * n + 4 * n          # mask, labels in, labels out
    bound_ms = nbytes / hbm_rate(card_name) * 1e3
    print(f"[kernel] masked_min_sweep on the N={n} main-path mask "
          f"({int(nbr.sum())} edges): {ms * 1e3:.2f} us/sweep, plain {plain_ms * 1e3:.2f} us, "
          f"bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.1f} MB at "
          f"{hbm_rate(card_name) / 1e12:.2f} TB/s), library_ms: none")
    return [{"name": "masked_min_sweep", "route": "cuda",
             "source": f"gcanet_tpu_torch/csrc/{cc.SOURCE}",
             "replaces": KERNELS[0][2], "launches": launches["masked_min_sweep"],
             "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}]


def phase_profile() -> None:
    """Device time by kernel over a steady window of two full-width
    ``predict_batch`` calls (B=4), and the share of the window the device
    was busy (kernel and copy time summed over the host-clock window)."""
    cfg = Config()
    pred = Predictor(cfg, device="cuda")
    push_weights(pred.model)
    xyz, nrm = synth_clouds(cfg, 4, seed=2)
    pred.predict_batch(xyz, nrm)                          # warm-up
    torch.cuda.synchronize()

    def two_batches():
        for _ in range(2):
            pred.predict_batch(xyz, nrm)

    _profile(f"2 x predict_batch(B=4, N={cfg.num_points})", two_batches)


def _forward_backward(model, batch, r1):
    """The train step up to the optimizer: forward in training mode, the
    losses, and the gradients of ``total - inst_loss`` and of ``inst_loss``
    apart (the second is the only one through the instance head)."""
    model.train()
    out = model(batch["gt_pc"], batch["gt_normal"], r1=r1)
    total, ld = step_lib.compute_losses(model.cfg, out, batch)
    names, ps = zip(*model.named_parameters())
    grads = []
    for loss, keep in ((total - ld["inst_loss"], True), (ld["inst_loss"], False)):
        gs = torch.autograd.grad(loss, ps, retain_graph=keep, allow_unused=True)
        grads.append({n: (torch.zeros_like(p) if g is None else g).detach().cpu()
                      for n, p, g in zip(names, ps, gs)})
    ld = {k: v.detach().cpu() for k, v in dict(ld, total_loss=total).items()}
    return out, ld, grads[0], grads[1]


def _grad_cosine(want: dict, got: dict) -> float:
    """Cosine between two gradients, every tensor flattened into one vector."""
    g = torch.cat([got[k].flatten() for k in want])
    w = torch.cat([want[k].flatten() for k in want])
    return float(g @ w / (g.norm() * w.norm()))


def _hold_gradients(label: str, tag: str, want: dict, got: dict,
                    atol_share: float) -> tuple[float, float]:
    """Every gradient tensor of the card (``got``) against the CPU's
    (``want``), elementwise within ``TRAIN_GRAD_RTOL`` and ``atol_share`` of
    the largest entry of the whole gradient; prints the worst four and
    returns the share needed and the worst relative L2 error."""
    scale = max(float(w.abs().max()) for w in want.values())
    rows = []
    for name, w in want.items():
        g = got[name]
        check(bool(torch.isfinite(g).all()), f"{tag} gradient of {name} not finite")
        excess = float(((g - w).abs() - TRAIN_GRAD_RTOL * w.abs()).max()) / scale
        rel_l2 = float((g - w).norm() / w.norm().clamp(min=1e-30))
        rows.append((excess, rel_l2, float((g - w).abs().max()), name))
    rows.sort(reverse=True)
    print(f"[{label}]   {tag} gradients, worst 4 (excess over rtol as a share of "
          f"the largest entry {scale:.3g}, relative L2 error, max_abs_err): "
          + "; ".join(f"{n} {e:.3g} {r:.3g} {a:.3g}" for e, r, a, n in rows[:4]))
    check(rows[0][0] <= atol_share, f"{tag} gradient of {rows[0][3]} out of tolerance")
    return rows[0][0], max(r[1] for r in rows)


def train_step_card_vs_cpu(cfg: Config, state: dict, batch_np: dict, r1: torch.Tensor,
                           head_bf16: bool) -> dict:
    """One train step's losses, gradients and new batch statistics on the
    card and on the CPU, from the same weights, batch and grid shift, the
    card's top-k and proposals replayed on the CPU.  Returns the worst
    errors; raises on any that is out of tolerance."""
    models, batches = {}, {}
    for dev in ("cuda", "cpu"):
        models[dev] = PrimitiveNet(cfg).to(dev)
        models[dev].load_state_dict(state)
        models[dev].instance_head.compute_bf16 = head_bf16
        batches[dev] = step_lib.batch_to_device(batch_np, dev)
    with TopkReplay() as topk, ProposalReplay() as props:
        card = _forward_backward(models["cuda"], batches["cuda"], r1.cuda())
        topk.replaying = props.replaying = True
        cpu = _forward_backward(models["cpu"], batches["cpu"], r1.cpu())
    res = {"topk_rows_differing": topk.differing, "cpu_proposals_equal": props.own_equal,
           "num_pos": float(cpu[1]["num_pos"]), "proposals": int(cpu[0].proposals.num)}
    check(res["proposals"] > 0 and float(cpu[1]["inst_loss"]) > 0,
          "the train step's instance path did no work")

    worst = 0.0
    for k, w in cpu[1].items():
        g = card[1][k]
        check(bool(torch.isfinite(g)), f"{k} not finite on the card")
        tol = CARD_VS_CPU_BF16 if head_bf16 and k in ("inst_loss", "total_loss") else TRAIN_LOSS
        check(torch.allclose(g, w, **tol), f"{k}: card {float(g)} CPU {float(w)}")
        worst = max(worst, float((g - w).abs()) / max(abs(float(w)), 1e-12))
    res["loss_max_rel_err"] = worst

    for tag, i in (("rest", 2), ("inst", 3)):
        want, got = cpu[i], card[i]
        if tag == "inst" and head_bf16:
            cos = _grad_cosine(want, got)
            res["inst_grad_cosine"] = cos
            check(cos >= TRAIN_BF16_MIN_COSINE, f"inst_loss gradient cosine {cos}")
            continue
        res[f"{tag}_grad_atol_share_needed"], res[f"{tag}_grad_max_rel_l2"] = _hold_gradients(
            "train-vs-cpu", tag, want, got, TRAIN_GRAD_ATOL_SHARE[tag])

    stats_tol = CARD_VS_CPU_BF16 if head_bf16 else TRAIN_STATS
    card_sd, cpu_sd = models["cuda"].state_dict(), models["cpu"].state_dict()
    keys = [k for k in cpu_sd if "running" in k]
    err = 0.0
    for k in keys:
        g, w = card_sd[k].cpu(), cpu_sd[k]
        check(not torch.equal(w, state[k]), f"{k} did not move")
        check(torch.allclose(g, w, **stats_tol), f"batch statistic {k}")
        err = max(err, float((g - w).abs().max()))
    res["stats_max_abs_err"] = err
    res["cpu_forward"] = cpu[0]
    return res


def phase_train_card_vs_cpu() -> None:
    """Phase 7: the train step, card against CPU, head in fp32 and in bf16;
    then grouping of the training path (no set aggregation) exactly on
    identical inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(num_points=2048, batch_size=2,
                 grouping=GroupingConfig(class_numpoint_mean=(-1.0,) * 7,
                                         similarity_threshold_inst=0.9),
                 instance_head=InstanceHeadConfig(max_proposals=24))
    model = PrimitiveNet(cfg)
    push_weights(model)
    state = model.state_dict()
    batch = synth_batch(cfg, cfg.batch_size, seed=3)
    r1 = torch.rand((2, 3), generator=torch.Generator().manual_seed(4))
    for head_bf16 in (False, True):
        res = train_step_card_vs_cpu(cfg, state, batch, r1, head_bf16)
        out = res.pop("cpu_forward")
        print(f"[train-vs-cpu] head {'bf16' if head_bf16 else 'fp32'}: "
              + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in res.items()))
    print(f"[train-vs-cpu] tolerances: losses {TRAIN_LOSS} (inst_loss and total with a "
          f"bf16 head {CARD_VS_CPU_BF16}); gradients rtol {TRAIN_GRAD_RTOL}, atol "
          f"{TRAIN_GRAD_ATOL_SHARE} x the largest entry; inst_loss gradient with a bf16 "
          f"head cosine >= {TRAIN_BF16_MIN_COSINE}; batch statistics {TRAIN_STATS} "
          f"(bf16 head {CARD_VS_CPU_BF16})")

    b, n = cfg.batch_size, cfg.num_points
    xyz = torch.as_tensor(batch["gt_pc"])
    g_cpu = tuple(t.detach() for t in _model_inputs_to_grouping(out, xyz))
    kw = dict(num_classes=cfg.num_primitives, cfg=cfg.grouping,
              max_proposals=cfg.instance_head.max_proposals, using_set_aggr=False)
    props_cpu = grouping_ops.build_proposals(*g_cpu, **kw)
    props_card = grouping_ops.build_proposals(*(t.cuda() for t in g_cpu), **kw)
    for field in props_cpu._fields:
        check(torch.equal(getattr(props_card, field).cpu(), getattr(props_cpu, field)),
              f"training proposals.{field} differs between card and CPU on the same inputs")
    print(f"[train-vs-cpu] training proposals on identical inputs (B={b}, N={n}): equal "
          f"(num {int(props_cpu.num)})")


@contextlib.contextmanager
def step_events(module=step_lib, name: str = "train_step"):
    """While open, every ``module.<name>`` call (the flagship's
    ``step_lib.train_step``, or ``scene_step.scene_train_step``) is
    bracketed by CUDA events, a host clock read at its start and a read of
    the CC kernel's launch count; yields the list of ``(start, end,
    launches, result, host_start)``."""
    marks = []
    real = getattr(module, name)

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = cc.masked_min_sweep.launches
        host_start = time.perf_counter()
        start.record()
        out = real(*args, **kw)
        end.record()
        marks.append((start, end, cc.masked_min_sweep.launches - before, out, host_start))
        return out

    setattr(module, name, timed)
    try:
        yield marks
    finally:
        setattr(module, name, real)
        torch.cuda.synchronize()


def phase_training(log_dir: str) -> int:
    """Phase 8: full width through ``Trainer.train_one_epoch``: a warm-up
    epoch of 2 steps, then one epoch of 2 + 5 steps whose last 5 are timed.
    The window runs from the start of the epoch's 3rd step to the end of
    its 7th, so it holds what a long epoch repeats (a step; the next batch
    made and copied on the prefetch thread) and not what an epoch does
    once (starting that thread, which slows the epoch's first step; its
    time is printed apart).  Returns the CC kernel's launches in the
    epoch."""
    cfg = Config(log_dir=log_dir, data_path=log_dir)
    warm, steps, b = 2, 5, cfg.batch_size
    trainer = Trainer(cfg)
    try:
        push_weights(trainer.model)
        trainer.train_one_epoch(0, num_batches=2)              # first use: builds, cuDNN
        torch.cuda.synchronize()
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with step_events() as marks:
            history = trainer.train_one_epoch(1, num_batches=warm + steps)
        wall = time.perf_counter() - marks[warm][4]
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()
        # what the prefetch thread copied equals the host batch, bit for bit
        host = [synth_batch(cfg, b, seed=1000 + i) for i in range(4)]
        for i, dev in enumerate(trainer_mod.prefetch_to_device(iter(host), "cuda")):
            for k, v in host[i].items():
                check(np.array_equal(dev[k].cpu().numpy(), v), f"prefetched {k} differs")
    finally:
        trainer.close()
    ms = marks[warm][0].elapsed_time(marks[-1][1]) / steps
    per_step = [(s.elapsed_time(e), n) for s, e, n, _, _ in marks]
    timed = per_step[warm:]
    totals = [float(m["total_loss"]) for m in history]
    print(f"[train] N={cfg.num_points} B={b} K={cfg.nn_nb} P={cfg.instance_head.max_proposals} "
          f"grid={cfg.instance_head.grid_size}, {steps} steps after {warm} warm-up steps of "
          f"one epoch: {ms:.1f} ms/step (CUDA events; host clock {wall / steps * 1e3:.1f}), "
          f"{b * 1e3 / ms:.2f} examples/s, peak memory {peak / 2**30:.2f} GiB")
    print(f"[train] per step ms (the epoch's first {warm} untimed): "
          f"{[round(t, 1) for t, _ in per_step]}; CC launches per step: "
          f"{[n for _, n in per_step]}")
    print(f"[train] {len(host)} prefetched batches equal the host's bit for bit")
    for i, m in enumerate(history[warm:]):
        print(f"[train] step {i}: " + ", ".join(f"{k} {float(v):.4g}" for k, v in m.items()))
    check(all(np.isfinite(totals)), f"non-finite total_loss {totals}")
    check(all(n > 0 for _, n in per_step), "a train step launched no CC sweep")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the training path")
    timed_launches = sum(n for _, n in timed)
    print(f"[train] launches on the training path ({warm + steps} steps): {launches}; "
          f"masked_min_sweep per timed step {timed_launches / steps:.1f}, sweeps per cloud "
          f"{timed_launches / (steps * b):.1f}")
    return launches["masked_min_sweep"]


def _profile(label: str, fn) -> None:
    """Device time by op over ``fn()``, and the device's busy share of the
    host-clock window (kernel and copy time summed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels_ = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels_)
    if busy_us == 0:
        print(f"[profile] {label}: the profiler saw no device time: not measured")
        return
    print(f"[profile] {label}: window {wall_us / 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms ({busy_us / wall_us:.1%}), "
          f"{sum(e.count for e in kernels_)} kernel/copy launches")
    ops = [e for e in events if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms device {e.count:6d}x  {e.key}")
    for e in kernels_:
        if "masked_min_sweep" in e.key:
            print(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms device {e.count:6d}x  "
                  f"{e.key[:60]} (hand-written; {e.self_device_time_total / busy_us:.1%} of "
                  f"device time)")


def phase_train_profile(log_dir: str) -> None:
    """Phase 9: two full-width train steps (B=3) under the profiler."""
    cfg = Config(log_dir=log_dir, data_path=log_dir, not_load_model=True)
    trainer = Trainer(cfg)
    try:
        push_weights(trainer.model)
        trainer.train_one_epoch(0, num_batches=1)               # warm-up
        torch.cuda.synchronize()
        _profile(f"2 train steps (B={cfg.batch_size}, N={cfg.num_points}, forward + "
                 f"backward + Adam)", lambda: trainer.train_one_epoch(1, num_batches=2))
    finally:
        trainer.close()


def eval_step_card_vs_cpu(cfg: Config, state: dict, batch_np: dict) -> dict:
    """The eval step on the card and on the CPU from the same weights and
    batch, the card's top-k selections and proposals replayed on the CPU:
    every loss to a tolerance (``inst_loss`` and the total out of the bf16
    head at ``CARD_VS_CPU_BF16``) and the merged labels exactly.  Returns
    the worst loss error and what the path did; raises on a difference."""
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = PrimitiveNet(cfg).to(dev)
        models[dev].load_state_dict(state)
    with TopkReplay() as topk, ProposalReplay() as props:
        card = step_lib.eval_step(models["cuda"], step_lib.batch_to_device(batch_np, "cuda"))
        topk.replaying = props.replaying = True
        cpu = step_lib.eval_step(models["cpu"], step_lib.batch_to_device(batch_np, "cpu"))
    worst = 0.0
    for k, w in dict(cpu[3], total_loss=cpu[2]).items():
        g = dict(card[3], total_loss=card[2])[k].cpu()
        check(bool(torch.isfinite(g)), f"eval {k} not finite on the card")
        head = models["cuda"].instance_head.compute_bf16 and k in ("inst_loss", "total_loss")
        tol = CARD_VS_CPU_BF16 if head else TRAIN_LOSS
        check(torch.allclose(g, w, **tol), f"eval {k}: card {float(g)} CPU {float(w)}")
        worst = max(worst, float((g - w).abs()) / max(abs(float(w)), 1e-12))
    merged_card, merged_cpu = card[1].cpu(), cpu[1]
    check(torch.equal(merged_card, merged_cpu), "eval merged labels differ between card and CPU")
    return {"loss_max_rel_err": worst, "topk_rows_differing": topk.differing,
            "cpu_proposals_equal": props.own_equal, "proposals": int(cpu[0].proposals.num),
            "distinct_merged_labels": int(merged_cpu.unique().numel())}


def phase_eval_card_vs_cpu() -> None:
    """Phase 10: the eval step, card against CPU, on one N=2048 cloud."""
    cfg = Config(num_points=2048, instance_head=InstanceHeadConfig(max_proposals=24))
    model = PrimitiveNet(cfg)
    push_weights(model)
    res = eval_step_card_vs_cpu(cfg, model.state_dict(), synth_batch(cfg, 1, seed=5))
    check(res["proposals"] > 0 and res["distinct_merged_labels"] > 1,
          "the reduced eval step kept no instance")
    print("[eval-vs-cpu] " + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                                       for k, v in res.items())
          + f"; tolerances: losses {TRAIN_LOSS} (inst_loss and total {CARD_VS_CPU_BF16}), "
          f"merged labels exact")


@contextlib.contextmanager
def cli_hooks(synth_batches: int, push=None, trainer_name: str = "Trainer"):
    """While open: synthetic epochs of ``synth_batches`` batches, every
    model the trainer builds gets ``push`` (``push_weights``), and every
    ``train_new.<trainer_name>`` that ``train_new.main`` builds is recorded,
    with the host-clock seconds of each ``test_one_epoch`` call.  Yields
    ``(trainers, eval_seconds)``."""
    trainers, eval_seconds = [], []
    push = push or push_weights
    real_build, real_trainer = trainer_mod.build_model, getattr(train_new, trainer_name)

    def pushed(cfg):
        model = real_build(cfg)
        push(model)
        return model

    class Recorded(real_trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            trainers.append(self)

        def test_one_epoch(self, epoch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = super().test_one_epoch(epoch)
            torch.cuda.synchronize()
            eval_seconds.append(time.perf_counter() - t0)
            return res

    old = os.environ.get("GCA_SYNTH_BATCHES")
    os.environ["GCA_SYNTH_BATCHES"] = str(synth_batches)
    trainer_mod.build_model = pushed
    setattr(train_new, trainer_name, Recorded)
    try:
        yield trainers, eval_seconds
    finally:
        trainer_mod.build_model = real_build
        setattr(train_new, trainer_name, real_trainer)
        if old is None:
            del os.environ["GCA_SYNTH_BATCHES"]
        else:
            os.environ["GCA_SYNTH_BATCHES"] = old


def _host_pair_matches_device(log_dir: str, n_clouds: int) -> list[int]:
    """``get_instances`` + ``merge_masks`` on the host, from the fetched
    outputs of latest.tar's eval step on each synthetic eval cloud, against
    the card's ``merged_labels_device``; returns the kept instances per
    cloud."""
    cfg = Config()
    model = trainer_mod.build_model(cfg).cuda()
    ckpt = torch.load(os.path.join(log_dir, "checkpoint", "latest.tar"), map_location="cuda",
                      weights_only=True)
    model.load_state_dict(ckpt["model_state_dict"])
    kept = []
    for i in range(n_clouds):
        batch = step_lib.batch_to_device(synth_batch(cfg, 1, seed=90000 + i), "cuda")
        out, merged, _, _ = step_lib.eval_step(model, batch)
        pid, sem, cls_s, iou_s, mask_s, valid, merged = fetch([
            out.proposals.point_pid, out.semantic_scores, out.instance.cls_scores,
            out.instance.iou_scores, out.instance.mask_scores, out.proposals.valid, merged])
        insts = inst_utils.get_instances(pid, sem, cls_s, iou_s, mask_s, valid,
                                         cfg.num_primitives)
        kept.append(len(insts))
        if insts:
            check(np.array_equal(inst_utils.merge_masks(insts), merged),
                  f"eval cloud {i}: host get_instances + merge_masks differ from the card")
        else:
            check(not merged.any(), f"eval cloud {i}: no instance kept, labels not all 0")
    return kept


def phase_cli(smi: str) -> dict:
    """Phase 11: ``train_new.main`` at full width, training and then
    ``--eval``.  Returns the CC kernel's launches in each run."""
    n_eval = 8                                      # the trainer's synthetic eval clouds
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as root, \
            cli_hooks(synth_batches=2) as (trainers, eval_seconds):
        log_dir = os.path.join(root, "log")
        argv = ["--log_dir", log_dir, "--data_path", os.path.join(root, "none"),
                "--max_epoch", "2", "--eval_interval", "1", "--save_interval", "1"]
        _reset_launches()
        with step_events() as marks:
            check(train_new.main(argv + ["--not_load_model"]) == 0, "main (train) exit code")
        train_run = _launches()["masked_min_sweep"]
        cfg = trainers[0].cfg
        steps = [(s.elapsed_time(e), n, out) for s, e, n, out, _ in marks]
        ckpts = set(os.listdir(os.path.join(log_dir, "checkpoint")))
        check({"eval0.tar", "eval1.tar", "latest.tar"} <= ckpts, f"checkpoints {sorted(ckpts)}")
        check(bool(ckpts & {"max_miou.tar", "max_type_miou.tar"}), "no best-metric checkpoint")
        check(os.path.exists(os.path.join(log_dir, "output_results.csv")), "no results CSV")
        with open(os.path.join(log_dir, "scalars_test.jsonl")) as f:
            records = [json.loads(line) for line in f]
        check(len(records) == 2, f"{len(records)} test records after 2 epochs")

        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        check(train_new.main(argv + ["--eval"]) == 0, "main (--eval) exit code")
        eval_run = _launches()["masked_min_sweep"]
        eval_peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(log_dir, "scalars_test.jsonl")) as f:
            records = [json.loads(line) for line in f]
        kept = _host_pair_matches_device(log_dir, n_eval)

    check(len(trainers) == 2 and all(t.eval_errors == 0 for t in trainers),
          f"eval errors {[t.eval_errors for t in trainers]}")
    check(all(bool(torch.isfinite(v)) for _, _, m in steps for v in m.values()),
          "a CLI train step's loss is not finite")
    check(all(np.isfinite(v) for r in records for v in r.values()), "a test record is not finite")
    epoch1, again = records[1], records[2]
    check(again["step"] == 2, f"--eval resumed at epoch {again['step']}, not 2")
    check((again["miou"], again["type_miou"]) == (epoch1["miou"], epoch1["type_miou"]),
          f"--eval metrics {again['miou']}, {again['type_miou']} differ from epoch 1's "
          f"{epoch1['miou']}, {epoch1['type_miou']}")
    loss_err = max(abs(again[k] - epoch1[k]) / max(abs(epoch1[k]), 1e-12)
                   for k in epoch1 if k not in ("step", "time", "miou", "type_miou"))
    check(loss_err <= EVAL_REPEAT_LOSS_RTOL, f"--eval losses differ from epoch 1's by {loss_err}")

    b, n = cfg.batch_size, cfg.num_points
    step_ms = [t for t, _, _ in steps]
    eval_ms = [1e3 * t / n_eval for t in eval_seconds]
    step_launches = sum(k for _, k, _ in steps)
    print(f"[cli] main(train): N={n} B={b}, {len(steps)} steps in 2 epochs, eval of "
          f"{n_eval} clouds (B=1) after each; ms per train step (CUDA events) "
          f"{[round(t, 1) for t in step_ms]}, after the first "
          f"{np.mean(step_ms[1:]):.1f} ms ({smi})")
    print(f"[cli] ms per eval cloud (host clock around test_one_epoch): epoch 0 "
          f"{eval_ms[0]:.1f}, epoch 1 {eval_ms[1]:.1f}, --eval {eval_ms[2]:.1f}; eval peak "
          f"memory {eval_peak / 2**30:.2f} GiB ({smi})")
    print(f"[cli] masked_min_sweep launches: train run {train_run} (train steps "
          f"{step_launches}, evals {train_run - step_launches}); --eval run {eval_run}, "
          f"{eval_run / n_eval:.1f} sweeps per eval cloud ({smi})")
    print(f"[cli] --eval reproduces epoch 1: miou {again['miou']:.4f}, type_miou "
          f"{again['type_miou']:.4f} exact, losses max relative difference {loss_err:.3g} "
          f"(rtol {EVAL_REPEAT_LOSS_RTOL}); eval_errors {[t.eval_errors for t in trainers]}; "
          f"host get_instances + merge_masks equal to the card's labels, kept instances per "
          f"cloud {kept}")
    check(train_run > 0 and eval_run > 0, "the CLI path launched no CC sweep")
    check(sum(kept) > 0, "no eval cloud kept an instance")
    return {"cli_train": train_run, "cli_eval": eval_run}


def scene_card_vs_cpu(cfg: Config, state: dict, xyz: np.ndarray, feats: np.ndarray,
                      scene_grid: int) -> dict:
    """The scene model on the card and on the CPU (``ScenePredictor``'s
    models) from the same weights and scenes, U-Net in ``cfg.scene_bf16``.
    Semantic scores and offsets to ``CARD_VS_CPU_FLOAT`` (bf16 U-Net:
    ``CARD_VS_CPU_BF16``); the card's shifted coordinates and logits through
    the CPU's ``build_soft_proposals`` give the card's proposals exactly;
    those proposals replayed on the CPU, the bf16 instance head to
    ``CARD_VS_CPU_BF16`` and ``instance_masks_device``'s keep, npoint and
    masks exactly, where no mask score is within 0.12 of -3.0 and no class
    softmax within 1e-3 of 0.45 (checked).  Returns what the path did and
    the worst errors; raises on a difference."""
    models = {dev: ScenePredictor(cfg, checkpoint=state, device=dev, scene_grid=scene_grid).model
              for dev in ("cuda", "cpu")}
    inputs = {dev: (torch.as_tensor(xyz, device=dev), torch.as_tensor(feats, device=dev))
              for dev in ("cuda", "cpu")}
    with torch.inference_mode():
        with ProposalReplay("build_soft_proposals") as props:
            card = models["cuda"](*inputs["cuda"])
            props.replaying = True
            cpu = models["cpu"](*inputs["cpu"])
        res = {"proposals": int(cpu.proposals.num), "cpu_own_proposals_equal": props.own_equal}
        tol = CARD_VS_CPU_BF16 if cfg.scene_bf16 else CARD_VS_CPU_FLOAT
        for name in ("semantic_scores", "pt_offsets"):
            g, w = getattr(card, name).cpu(), getattr(cpu, name)
            check(bool(torch.isfinite(g).all()), f"scene {name} not finite")
            check(torch.allclose(g, w, **tol), f"scene {name} differs between card and CPU")
            res[f"{name}_max_abs_err"] = float((g - w).abs().max())

        b, n = xyz.shape[:2]
        shifted = (inputs["cuda"][0] + card.pt_offsets.reshape(b, n, 3)).float().cpu()
        logits = card.semantic_scores.reshape(b, n, -1).float().cpu()
        again = grouping_ops.build_soft_proposals(shifted, logits, cfg.num_primitives,
                                                  cfg.grouping, cfg.instance_head.max_proposals)
        for field in again._fields:
            check(torch.equal(getattr(card.proposals, field).cpu(), getattr(again, field)),
                  f"scene proposals.{field}: the CPU on the card's inputs differs")

        for name in ("cls_scores", "iou_scores", "mask_scores"):
            g, w = getattr(card.instance, name).cpu(), getattr(cpu.instance, name)
            check(torch.allclose(g, w, **CARD_VS_CPU_BF16), f"scene instance head {name}")
            res[f"{name}_max_abs_err"] = float((g - w).abs().max())
        ext = {}
        for dev, out in (("cuda", card), ("cpu", cpu)):
            ext[dev] = [t.cpu() for t in inst_utils.instance_masks_device(
                out.proposals.point_pid, out.instance.cls_scores, out.instance.iou_scores,
                out.instance.mask_scores, out.proposals.valid, cfg.num_primitives)]
        valid = cpu.proposals.valid
        cls_soft = torch.softmax(cpu.instance.cls_scores, dim=1)[valid]
        entry = cpu.proposals.point_pid >= 0
        res["cls_margin"] = float((cls_soft - 0.45).abs().min()) if valid.any() else 1.0
        res["mask_margin"] = (float((cpu.instance.mask_scores[entry] + 3.0).abs().min())
                              if entry.any() else 1.0)
        check(res["cls_margin"] > 1e-3 and res["mask_margin"] > 0.12,
              f"a score sits at an extraction threshold: {res}")
        for i, name in ((0, "keep"), (2, "npoint"), (3, "masks")):
            check(torch.equal(ext["cuda"][i], ext["cpu"][i]), f"scene {name} differs")
        check(torch.allclose(ext["cuda"][1], ext["cpu"][1], **CARD_VS_CPU_BF16), "scene conf")
        res["kept"] = int(ext["cpu"][0].sum())
    return res


def phase_scene_card_vs_cpu() -> None:
    """Phase 12: the scene model, card against CPU, reduced size, U-Net in
    fp32 and in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = 32
    cfg = scene_config(2048)
    model = ScenePredictor(cfg, device="cpu", scene_grid=grid).model
    push_scene_weights(model)
    batch = synth_scene_batch(cfg, 2, seed=11)
    for bf16 in (False, True):
        res = scene_card_vs_cpu(cfg.replace(scene_bf16=bf16), model.state_dict(),
                                batch["xyz"], batch["feats"], grid)
        check(res["proposals"] > 0 and res["kept"] > 0, "the reduced scene run did no work")
        print(f"[scene-vs-cpu] N={cfg.num_points} B=2 grid {grid}, U-Net "
              f"{'bf16' if bf16 else 'fp32'}: "
              + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in res.items()))
    print(f"[scene-vs-cpu] tolerances: semantic scores and offsets {CARD_VS_CPU_FLOAT} (bf16 "
          f"U-Net {CARD_VS_CPU_BF16}); instance head and conf {CARD_VS_CPU_BF16}; proposals on "
          f"the card's inputs, keep, npoint and masks exact")


def _scene_stream_check(stream: list[dict], batches: list[list[dict]]) -> str:
    """The stream's dicts against ``predict_batch``'s on the same batches:
    exact, or else (float atomics in the voxel means move the logits in the
    last bits between calls) ``semantic_preds`` on >= 99.9% of points."""
    want = [d for batch in batches for d in batch]
    check(len(stream) == len(want), "predict_stream yielded another number of scenes")
    if same_dicts(stream, want):
        return "equal"
    agree = np.mean([np.mean(g["semantic_preds"] == w["semantic_preds"])
                     for g, w in zip(stream, want)])
    check(agree >= 0.999, f"predict_stream: semantic_preds agree on {agree:.4%} of points")
    differing = {}
    for i, (g, w) in enumerate(zip(stream, want)):
        key = dict_difference(g, w)
        if key is not None:
            differing[i] = key
            if key == "instances":
                gi, wi = g[key], w[key]
                differing[i] += (f" ({len(gi)} vs {len(wi)} instances, npoint "
                                 f"{[x['npoint'] for x in gi]} vs {[x['npoint'] for x in wi]})")
    return (f"not exact in {len(differing)} of {len(want)} scenes {differing}; "
            f"semantic_preds agree on {agree:.4%} of points")


def phase_scene_serving(card_name: str, smi: str) -> dict:
    """Phase 13: scene serving at full width.  Returns the CC kernel's
    launches in the window and the sweep's times on a scene class mask."""
    cfg = scene_config(8192)
    n, b, reps, grid = cfg.num_points, 8, 3, 64
    pred = ScenePredictor(cfg, device="cuda", scene_grid=grid)
    push_scene_weights(pred.model)
    batches = [synth_scene_batch(cfg, b, seed=20 + i) for i in range(reps)]
    inputs = [(bt["xyz"], bt["feats"]) for bt in batches]
    pred.predict(*(a[0] for a in inputs[0]))                   # warm-up
    pred.predict_batch(*inputs[0])
    torch.cuda.synchronize()

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    singles = [pred.predict(inputs[i][0][0], inputs[i][1][0]) for i in range(reps)]
    t_single = (time.perf_counter() - t0) / reps
    single_launches = _launches()["masked_min_sweep"]
    t0 = time.perf_counter()
    results = [pred.predict_batch(*inp) for inp in inputs]
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream = list(pred.predict_stream(inputs, depth=2))
    t_stream = time.perf_counter() - t0
    launches = _launches()["masked_min_sweep"]
    peak = torch.cuda.max_memory_allocated()
    stream_check = _scene_stream_check(stream, results)

    gc = cfg.num_primitives - len(cfg.grouping.ignore_classes)
    scenes = reps + 2 * reps * b
    cc_runs = gc * scenes
    kept = [len(r["instances"]) for batch in results for r in batch]
    for r in singles + [d for batch in results for d in batch]:
        check(r["semantic_preds"].shape == (n,) and r["pt_offsets"].shape == (n, 3)
              and r["instance_labels"].shape == (n,) and np.isfinite(r["pt_offsets"]).all(),
              "scene output shapes")
    check(launches > 0, "masked_min_sweep was not launched on the scene path")
    with torch.inference_mode():
        xt = torch.as_tensor(inputs[0][0], device="cuda")
        out = pred.model(xt, torch.as_tensor(inputs[0][1], device="cuda"))
    num = int(out.proposals.num)
    check(all(k > 0 for k in kept) and num > 0,
          f"a full-width scene kept no instance: proposals {num}, kept {kept}")
    per_scene = np.bincount(out.proposals.batch[out.proposals.valid].cpu().numpy(), minlength=b)
    print(f"[scene] N={n} B={b} grid {grid} channels {pred.model.channels} classes "
          f"{cfg.num_primitives} ({gc} grouped) P={cfg.instance_head.max_proposals} "
          f"bf16 {cfg.scene_bf16}: proposals per scene (batch 0) {per_scene.tolist()}, kept "
          f"instances per scene {kept}")
    print(f"[scene] predict: {t_single * 1e3:.1f} ms/scene; predict_batch B={b}: "
          f"{reps * b / t_batch:.2f} scenes/s ({t_batch / reps * 1e3:.1f} ms/batch); "
          f"predict_stream depth 2: {reps * b / t_stream:.2f} scenes/s; peak memory "
          f"{peak / 2**30:.2f} GiB ({smi})")
    print(f"[scene] masked_min_sweep launches {launches} over {scenes} scenes ({cc_runs} CC "
          f"runs, {gc} per scene; {gc * b} per batch): {launches / cc_runs:.2f} sweeps per "
          f"class per scene, {(launches - single_launches) / (2 * reps):.1f} sweeps (and "
          f"host syncs) per batch of {b}; predict_stream against predict_batch: {stream_check}")

    # the sweep on one of the path's own class masks: scene 0, first grouped class
    shifted = (xt + out.pt_offsets.reshape(b, n, 3))[0].float()
    ci = [c for c in range(cfg.num_primitives) if c not in cfg.grouping.ignore_classes][0]
    member = torch.softmax(out.semantic_scores.reshape(b, n, -1)[0], -1)[:, ci] \
        > cfg.grouping.score_thr
    nbr = (grouping_ops.radius_neighbor_mask(shifted, cfg.grouping.radius)
           & member[:, None] & member[None, :])
    labels = torch.arange(n, dtype=torch.int32, device="cuda")
    check(torch.equal(cc.masked_min_sweep(nbr, labels), cc.masked_min_sweep_plain(nbr, labels)),
          "sweep on the scene class mask")
    ms = time_graph(lambda: cc.masked_min_sweep(nbr, labels), 100)
    plain_ms = time_graph(lambda: cc.masked_min_sweep_plain(nbr, labels), 10)
    nbytes = n * n + 8 * n
    bound_ms = nbytes / hbm_rate(card_name) * 1e3
    print(f"[kernel] masked_min_sweep on the N={n} scene mask of class {ci} "
          f"({int(member.sum())} members, {int(nbr.sum())} edges; {nbytes / 1e6:.1f} MB, "
          f"{'above' if nbytes > 50e6 else 'within'} the 50 MB L2): {ms * 1e3:.2f} us/sweep, "
          f"plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us, {bound_ms / ms:.1%} "
          f"of the bound ({smi})")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "n": n}


def phase_scene_profile() -> None:
    """Phase 14: two full-width scene ``predict_batch`` calls (B=8) under
    the profiler."""
    cfg = scene_config(8192)
    pred = ScenePredictor(cfg, device="cuda", scene_grid=64)
    push_scene_weights(pred.model)
    bt = synth_scene_batch(cfg, 8, seed=20)
    pred.predict_batch(bt["xyz"], bt["feats"])                  # warm-up
    torch.cuda.synchronize()

    def two_batches():
        for _ in range(2):
            pred.predict_batch(bt["xyz"], bt["feats"])

    _profile(f"2 x scene predict_batch(B=8, N={cfg.num_points}, grid 64)", two_batches)


def _scene_forward_backward(model, batch, r1):
    """The scene train step up to the optimizer: forward in training mode,
    the losses, and the gradients of the point-wise losses (semantic +
    offset, the trunk's) and of the instance losses apart."""
    model.train()
    out = model(batch["xyz"], batch["feats"], r1=r1)
    total, ld = scene_step.compute_scene_losses(model.cfg, out, batch)
    point = ld["semantic_loss"] + ld["offset_loss"]
    names, ps = zip(*model.named_parameters())
    grads = []
    for loss, keep in ((point, True), (total - point, False)):
        gs = torch.autograd.grad(loss, ps, retain_graph=keep, allow_unused=True)
        grads.append({n: (torch.zeros_like(p) if g is None else g).detach().cpu()
                      for n, p, g in zip(names, ps, gs)})
    ld = {k: v.detach().cpu() for k, v in dict(ld, total_loss=total).items()}
    return out, ld, grads[0], grads[1]


def scene_train_card_vs_cpu(cfg: Config, state: dict, batch_np: dict, r1: torch.Tensor,
                            grid: int) -> dict:
    """One scene train step's losses, gradients and new batch statistics on
    the card and on the CPU, from the same weights, batch and grid shift,
    the card's proposals replayed on the CPU, U-Net in ``cfg.scene_bf16``
    (see ``SCENE_MIN_COSINE``); then the CPU's ``build_soft_proposals`` on
    the card's shifted coordinates and logits must give the card's
    proposals.  Returns the worst errors; raises on any out of tolerance."""
    bf16 = bool(cfg.scene_bf16)
    models, batches = {}, {}
    for dev in ("cuda", "cpu"):
        models[dev] = SoftGroupNet(cfg, scene_grid=grid, compute_bf16=bf16).to(dev)
        models[dev].load_state_dict(state)
        batches[dev] = step_lib.batch_to_device(batch_np, dev)
    with ProposalReplay("build_soft_proposals") as props:
        card = _scene_forward_backward(models["cuda"], batches["cuda"], r1.cuda())
        props.replaying = True
        cpu = _scene_forward_backward(models["cpu"], batches["cpu"], r1.cpu())
    res = {"cpu_own_proposals_equal": props.own_equal, "proposals": int(cpu[0].proposals.num),
           "num_pos": float(cpu[1]["num_pos"])}
    check(res["proposals"] > 0 and float(cpu[1]["cls_loss"]) > 0,
          "the scene train step's instance path did no work")

    worst = 0.0
    for k, w in cpu[1].items():
        g = card[1][k]
        check(bool(torch.isfinite(g)), f"scene {k} not finite on the card")
        if k == "num_pos":
            check(torch.equal(g, w), f"num_pos: card {float(g)} CPU {float(w)}")
            continue
        point = k in ("semantic_loss", "offset_loss")
        tol = TRAIN_LOSS if point and not bf16 else CARD_VS_CPU_BF16
        check(torch.allclose(g, w, **tol), f"scene {k}: card {float(g)} CPU {float(w)}")
        worst = max(worst, float((g - w).abs()) / max(abs(float(w)), 1e-12))
    res["loss_max_rel_err"] = worst

    for tag, i in (("point", 2), ("inst", 3)):
        want, got = cpu[i], card[i]
        if tag == "point" and not bf16:
            res["point_grad_atol_share_needed"], res["point_grad_max_rel_l2"] = \
                _hold_gradients("scene-train-vs-cpu", tag, want, got,
                                TRAIN_GRAD_ATOL_SHARE["rest"])
        else:
            cos = _grad_cosine(want, got)
            res[f"{tag}_grad_cosine"] = cos
            check(cos >= SCENE_MIN_COSINE, f"scene {tag} gradient cosine {cos}")

    card_sd, cpu_sd = models["cuda"].state_dict(), models["cpu"].state_dict()
    err = 0.0
    for k in (k for k in cpu_sd if "running" in k):
        g, w = card_sd[k].cpu(), cpu_sd[k]
        head = k.startswith("instance_head.")
        check(not torch.equal(w, state[k]), f"{k} did not move")
        check(torch.allclose(g, w, **(CARD_VS_CPU_BF16 if head or bf16 else TRAIN_STATS)),
              f"scene batch statistic {k}")
        if not head:
            err = max(err, float((g - w).abs().max()))
    res["trunk_stats_max_abs_err"] = err

    b, n = batch_np["xyz"].shape[:2]
    out = card[0]
    shifted = (batches["cuda"]["xyz"] + out.pt_offsets.reshape(b, n, 3)).detach().float().cpu()
    logits = out.semantic_scores.reshape(b, n, -1).detach().float().cpu()
    again = grouping_ops.build_soft_proposals(shifted, logits, cfg.num_primitives,
                                              cfg.grouping, cfg.instance_head.max_proposals)
    for field in again._fields:
        check(torch.equal(getattr(out.proposals, field).cpu(), getattr(again, field)),
              f"scene training proposals.{field}: the CPU on the card's inputs differs")
    return res


def phase_scene_train_card_vs_cpu() -> None:
    """Phase 15: the scene train step, card against CPU, reduced size, U-Net
    in fp32 and in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = 32
    cfg = scene_config(2048).replace(batch_size=2)
    model = SoftGroupNet(cfg, scene_grid=grid)
    push_scene_weights(model)
    batch = synth_scene_batch(cfg, cfg.batch_size, seed=13)
    r1 = torch.rand((2, 3), generator=torch.Generator().manual_seed(14))
    for bf16 in (False, True):
        res = scene_train_card_vs_cpu(cfg.replace(scene_bf16=bf16), model.state_dict(), batch,
                                      r1, grid)
        print(f"[scene-train-vs-cpu] N={cfg.num_points} B={cfg.batch_size} grid {grid}, U-Net "
              f"{'bf16' if bf16 else 'fp32'}: "
              + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in res.items()))
    print(f"[scene-train-vs-cpu] tolerances: semantic and offset losses {TRAIN_LOSS} (bf16 "
          f"U-Net {CARD_VS_CPU_BF16}), instance losses {CARD_VS_CPU_BF16}, num_pos exact; "
          f"point-wise gradients rtol {TRAIN_GRAD_RTOL}, atol {TRAIN_GRAD_ATOL_SHARE['rest']} x "
          f"the largest entry (bf16 U-Net: cosine >= {SCENE_MIN_COSINE}); instance gradients "
          f"cosine >= {SCENE_MIN_COSINE}; trunk statistics {TRAIN_STATS} (bf16 U-Net and the "
          f"head's {CARD_VS_CPU_BF16}); proposals on the card's inputs exact")


@contextlib.contextmanager
def soft_grouping_calls():
    """While open, every ``build_soft_proposals`` call is recorded: yields a
    list of ``(shifted, logits, proposals.num)``, the tensors of the last
    call only."""
    calls = []
    real = grouping_ops.build_soft_proposals

    def recorded(shifted, logits, *args, **kw):
        props = real(shifted, logits, *args, **kw)
        if calls:
            calls[-1] = (None, None, calls[-1][2])
        calls.append((shifted, logits, int(props.num)))
        return props

    grouping_ops.build_soft_proposals = recorded
    try:
        yield calls
    finally:
        grouping_ops.build_soft_proposals = real


def scene_train_config(log_dir: str) -> Config:
    """The scene training configuration at full width: the serving one
    (``scene_config(8192)``) at B=8, synthetic data, Adam 1e-3."""
    return scene_config(8192).replace(batch_size=8, log_dir=log_dir, data_path=log_dir,
                                      not_load_model=True)


def _scene_records(log_dir: str) -> list[dict]:
    with open(os.path.join(log_dir, "scalars_test.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_scene_training(trainer: SceneTrainer, card_name: str, smi: str) -> dict:
    """Phase 16: scene training and evaluation at full width, the scene CLI,
    and the sweep on the training path's class mask.  Returns the CC
    kernel's launches by run and the sweep's times."""
    cfg = trainer.cfg
    warm, steps, b, n = 2, 5, cfg.batch_size, cfg.num_points
    gc = cfg.num_primitives - len(cfg.grouping.ignore_classes)
    trainer.train_one_epoch(0, num_batches=2)                   # first use: builds, cuDNN
    torch.cuda.synchronize()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with step_events(scene_step, "scene_train_step") as marks, soft_grouping_calls() as groups:
        history = trainer.train_one_epoch(1, num_batches=warm + steps)
    wall = time.perf_counter() - marks[warm][4]
    train_launches = _launches()["masked_min_sweep"]
    peak = torch.cuda.max_memory_allocated()
    ms = marks[warm][0].elapsed_time(marks[-1][1]) / steps
    per_step = [(s.elapsed_time(e), k) for s, e, k, _, _ in marks]
    timed_launches = sum(k for _, k in per_step[warm:])
    print(f"[scene-train] N={n} B={b} grid {trainer.model.scene_grid} channels "
          f"{trainer.model.channels} classes {cfg.num_primitives} ({gc} grouped) "
          f"P={cfg.instance_head.max_proposals} bf16 U-Net {cfg.scene_bf16}: {steps} steps after "
          f"{warm} warm-up steps of one epoch: {ms:.1f} ms/step (CUDA events; host clock "
          f"{wall / steps * 1e3:.1f}), {b * 1e3 / ms:.2f} scenes/s, peak memory "
          f"{peak / 2**30:.2f} GiB ({smi})")
    print(f"[scene-train] per step ms (the epoch's first {warm} untimed): "
          f"{[round(t, 1) for t, _ in per_step]}; CC launches per step "
          f"{[k for _, k in per_step]}; proposals per step {[c[2] for c in groups]}")
    for i, m in enumerate(history):
        print(f"[scene-train] step {i}: " + ", ".join(f"{k} {float(v):.4g}" for k, v in m.items()))
    check(all(bool(torch.isfinite(v)) for m in history for v in m.values()),
          "a scene train step's loss is not finite")
    check(all(k > 0 for _, k in per_step) and train_launches > 0,
          "a scene train step launched no CC sweep")
    check(all(c[2] > 0 for c in groups), "a full-width scene train batch made no proposal")
    print(f"[scene-train] masked_min_sweep launches {train_launches} over {warm + steps} steps; "
          f"per timed step {timed_launches / steps:.1f} ({gc * b} CC runs), "
          f"{timed_launches / (steps * gc * b):.2f} sweeps per class per scene ({smi})")

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    miou, ap50 = trainer.test_one_epoch(1)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    eval_launches = _launches()["masked_min_sweep"]
    eval_peak = torch.cuda.max_memory_allocated()
    rec = _scene_records(cfg.log_dir)[-1]
    kept = []
    for batch in trainer._test_batches():
        keep = trainer._eval_forward(batch)[0]
        kept.append(int(keep[:, : cfg.num_primitives - 1].sum()))
    check({"miou", "acc", "pq", "all_ap", "all_ap_50%", "all_ap_25%"} <= set(rec)
          and all(np.isfinite(v) for v in rec.values()), f"scene eval record {rec}")
    check(trainer.eval_errors == 0, f"scene eval errors {trainer.eval_errors}")
    check(all(k > 0 for k in kept), f"a full-width eval scene kept no instance: {kept}")
    print(f"[scene-eval] test_one_epoch, 8 synthetic scenes (B=1): "
          f"{t_eval / 8 * 1e3:.1f} ms per scene (host clock), peak memory "
          f"{eval_peak / 2**30:.2f} GiB, {eval_launches} sweeps, "
          f"{eval_launches / (8 * gc):.2f} per class per scene; kept instances per scene {kept}; "
          f"miou {miou:.4f} AP50 {ap50:.4f} " + ", ".join(
              f"{k} {rec[k]:.4f}" for k in ("acc", "pq", "all_ap", "all_ap_25%")) + f" ({smi})")

    cli = _scene_cli(smi)

    # the sweep on one of the training path's own class masks: the last
    # train step's scene 0, first grouped class
    shifted, logits, _ = groups[-1]
    ci = [c for c in range(cfg.num_primitives) if c not in cfg.grouping.ignore_classes][0]
    member = torch.softmax(logits[0], -1)[:, ci] > cfg.grouping.score_thr
    nbr = (grouping_ops.radius_neighbor_mask(shifted[0], cfg.grouping.radius)
           & member[:, None] & member[None, :])
    labels = torch.arange(n, dtype=torch.int32, device="cuda")
    check(torch.equal(cc.masked_min_sweep(nbr, labels), cc.masked_min_sweep_plain(nbr, labels)),
          "sweep on the scene training class mask")
    ms_sweep = time_graph(lambda: cc.masked_min_sweep(nbr, labels), 100)
    plain_ms = time_graph(lambda: cc.masked_min_sweep_plain(nbr, labels), 10)
    nbytes = n * n + 8 * n
    bound_ms = nbytes / hbm_rate(card_name) * 1e3
    print(f"[kernel] masked_min_sweep on the N={n} scene training mask of class {ci} "
          f"({int(member.sum())} members, {int(nbr.sum())} edges; {nbytes / 1e6:.1f} MB): "
          f"{ms_sweep * 1e3:.2f} us/sweep, plain {plain_ms * 1e3:.2f} us, bound "
          f"{bound_ms * 1e3:.2f} us, {bound_ms / ms_sweep:.1%} of the bound ({smi})")
    return {"scene_train": train_launches, "scene_eval": eval_launches, **cli,
            "mask": {"n": n, "ms": ms_sweep, "plain_ms": plain_ms, "bound_ms": bound_ms}}


def _scene_cli(smi: str) -> dict:
    """``train_new.main`` with the scene family at full width: 2 epochs of
    2 synthetic batches, evaluating after each, then ``--eval`` on
    ``latest.tar`` against epoch 1's record."""
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as root, \
            cli_hooks(2, push_scene_weights, "SceneTrainer") as (trainers, eval_seconds):
        log_dir = os.path.join(root, "log")
        argv = ["--log_dir", log_dir, "--data_path", os.path.join(root, "none"),
                "--model_dict", "softgroup.model.softgroup", "--num_points", "8192",
                "--num_primitives", "20", "--batch_size", "8", "--max_epoch", "2",
                "--eval_interval", "1", "--save_interval", "1"]
        _reset_launches()
        with step_events(scene_step, "scene_train_step") as marks:
            check(train_new.main(argv + ["--not_load_model"]) == 0, "scene main (train) exit code")
        train_run = _launches()["masked_min_sweep"]
        ckpts = set(os.listdir(os.path.join(log_dir, "checkpoint")))
        check({"eval0.tar", "eval1.tar", "latest.tar"} <= ckpts, f"checkpoints {sorted(ckpts)}")
        check(len(_scene_records(log_dir)) == 2, "scene test records after 2 epochs")
        _reset_launches()
        check(train_new.main(argv + ["--eval"]) == 0, "scene main (--eval) exit code")
        eval_run = _launches()["masked_min_sweep"]
        records = _scene_records(log_dir)
    check(len(trainers) == 2 and all(t.eval_errors == 0 for t in trainers),
          f"scene eval errors {[t.eval_errors for t in trainers]}")
    check(all(bool(torch.isfinite(v)) for _, _, _, m, _ in marks for v in m.values()),
          "a scene CLI train step's loss is not finite")
    epoch1, again = records[1], records[2]
    check(again["step"] == 2, f"scene --eval resumed at epoch {again['step']}, not 2")
    keys = [k for k in epoch1 if k not in ("step", "time")]
    differing = {k: (epoch1[k], again[k]) for k in keys if again[k] != epoch1[k]}
    check(all(abs(a - e) <= SCENE_EVAL_REPEAT_ATOL for e, a in differing.values()),
          f"scene --eval differs from epoch 1's record: {differing}")
    step_ms = [s.elapsed_time(e) for s, e, _, _, _ in marks]
    print(f"[scene-cli] main(train): {len(marks)} steps in 2 epochs, ms per step (CUDA events) "
          f"{[round(t, 1) for t in step_ms]}; ms per eval scene: epoch 0 "
          f"{eval_seconds[0] / 8 * 1e3:.1f}, epoch 1 {eval_seconds[1] / 8 * 1e3:.1f}, --eval "
          f"{eval_seconds[2] / 8 * 1e3:.1f} ({smi})")
    print(f"[scene-cli] masked_min_sweep launches: train run {train_run}, --eval run {eval_run}; "
          f"--eval against epoch 1's record: "
          + ("exact" if not differing else f"not exact (within {SCENE_EVAL_REPEAT_ATOL}): "
             f"{differing}") + f"; miou {again['miou']:.4f}, AP50 {again['all_ap_50%']:.4f}")
    check(train_run > 0 and eval_run > 0, "the scene CLI launched no CC sweep")
    return {"scene_cli_train": train_run, "scene_cli_eval": eval_run}


def phase_scene_train_profile(trainer: SceneTrainer) -> None:
    """Phase 17: two full-width scene train steps (B=8) under the profiler."""
    cfg = trainer.cfg
    _profile(f"2 scene train steps (B={cfg.batch_size}, N={cfg.num_points}, grid "
             f"{trainer.model.scene_grid}, forward + backward + Adam)",
             lambda: trainer.train_one_epoch(2, num_batches=2))


def run_phase(number: int, fn, *args):
    """``fn(*args)``, its host-clock seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase {number}] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card_name, smi = run_phase(1, phase_card)
    run_phase(2, phase_build)
    max_err = run_phase(3, phase_kernel_check)
    run_phase(4, phase_card_vs_cpu)
    kernel_rows = run_phase(5, phase_serving, card_name, max_err)
    run_phase(6, phase_profile)
    run_phase(7, phase_train_card_vs_cpu)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as log_dir:
        train_launches = run_phase(8, phase_training, log_dir)
        run_phase(9, phase_train_profile, log_dir)
    run_phase(10, phase_eval_card_vs_cpu)
    cli_launches = run_phase(11, phase_cli, smi)
    run_phase(12, phase_scene_card_vs_cpu)
    scene = run_phase(13, phase_scene_serving, card_name, smi)
    run_phase(14, phase_scene_profile)
    run_phase(15, phase_scene_train_card_vs_cpu)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as log_dir:
        trainer = SceneTrainer(scene_train_config(log_dir))
        try:
            push_scene_weights(trainer.model)
            scene_train = run_phase(16, phase_scene_training, trainer, card_name, smi)
            run_phase(17, phase_scene_train_profile, trainer)
        finally:
            trainer.close()
    row = kernel_rows[0]
    scene_train_mask = scene_train.pop("mask")
    row["launches_by_path"] = {"serve": row["launches"], "train": train_launches,
                               **cli_launches, "scene_serve": scene["launches"], **scene_train}
    row["launches"] = sum(row["launches_by_path"].values())
    row["scene_mask"] = {k: scene[k] for k in ("n", "ms", "plain_ms", "bound_ms")}
    row["scene_train_mask"] = scene_train_mask
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
