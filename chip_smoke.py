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
     share, top ops, the CC kernel's share;
 18. the flagship's knobs, card against CPU (N=2048, B=2, TF32 off, top-k
     and proposals replayed): one train step each under
     ``precision="bf16"``, ``encoder_bf16`` + ``shared_graph`` +
     ``edge_backward="revgather:64"``, ``mode=3`` and ``ablation``, at phase
     7's tolerances (a bf16 trunk's losses at the bf16 tolerance, its
     gradients by cosine); ``remat`` against no remat on the card (fp32, and
     bf16 with ``encoder_bf16``); the reverse-gather backward against the
     scatter backward at B=2, N=8192, K=48, C=64 with M the largest
     in-degree, and both timed;
 19. the bench at full width, in-process (``gcanet_tpu_torch.bench.main``,
     torch's default TF32 settings): the flagship (B=10, N=8192), the scene
     family (B=8, grid 48) and the flagship with ``GCA_BENCH_ENC_BF16=1
     GCA_BENCH_EDGE_BWD=revgather:64 GCA_BENCH_SHARED_GRAPH=1``; each line
     checked to be the bench's one JSON line, with peak memory and the CC
     kernel's launches per step (a batch that does not fit is replaced by
     the largest of 8, 6, 4, 3 that does, and both are printed); a profile
     of two flagship bench steps; then the sweep timed on the bench's own
     N=8192 mask;
 20. the serving extras at full width (default ``Config``): ``predict(
     return_masks=True, panoptic=True)`` on 3 clouds against the host
     ``get_instances`` / ``merge_masks`` / ``panoptic_fusion`` on the card's
     own fetched arrays, exactly; set aggregation with the ``--strict_caps``
     absorb caps and tighter ones, card against CPU on identical inputs,
     exactly; ``serve_http`` on 127.0.0.1 over a card ``Predictor`` with 16
     concurrent requests in micro-batches of 4, each response equal to
     ``Predictor.predict`` on its cloud (integers exact, floats 1e-3):
     requests/s, p50 and p99 latency.
 21. the model variants.  The dual-attention ``-2`` model
     (``--model_dict models.dgcnn-hais-concat-direct-2``): phase 4's card
     against CPU forward and phase 7's train step (head in fp32 and bf16)
     at N=2048, its key-point kNN replayed with the encoder's top-k; at full
     width ``predict_batch`` at B=4 (clouds/s, peak memory) with
     ``predict_stream`` equal to it, ``Trainer.train_one_epoch`` at B=3 (2
     warm-up and 5 timed steps), phase 11's ``train_new`` then ``--eval``,
     each with the CC kernel's launches counted from 0.  SPP-Net: card
     against CPU at N=2048, four head-loss Adam steps (finite, falling), its
     forward timed at N=7000, B=4.  SplineNet (modes 0 and 1, train and
     eval), a multi-scale SA module, an FP module, soft projection, ViT and
     the query decoder, card against CPU at a small size with the card's
     top-k, FPS and ball-query picks replayed (floats 1e-3, integers
     exact), and the Hungarian criterion (assignments exact, losses at
     phase 7's tolerance).
 22. the geometry package and meanshift serving.  ``Predictor(cluster_mode=
     "meanshift")`` at the default ``Config`` (N=7000, 64-d embedding,
     bandwidth 0.85): ``predict`` on 3 clouds after a warm-up with the
     launch counts set to 0 just before and read just after (ms per cloud;
     the forward and the mean shift apart by CUDA events; iterations, host
     syncs, centres, peak memory), each cloud's labels the mean shift of its
     returned embedding, and a trace through ``utils/profiling.trace``; the
     mean shift card against CPU (N=7000 blobs and the card's N=2048
     embedding, labels exactly); ``construction_affinity_matrix_type`` and
     ``_normal`` at N=7000 (ms, peak memory) and card against CPU at N=2048;
     ``simple_clusters`` on an N=8192 scene with the scannetv2 recipe,
     card against CPU exactly, its launches counted from 0 and the sweep
     timed on its mask; the fits, spline functions and ``arap_deform`` card
     against CPU (see ``GEOMETRY_RTOL``).
 23. data parallelism: two gloo ranks share the card (``phase_data_parallel``).
 24. sequence parallelism, d shards all on ``cuda:0``: ring kNN (N=16384,
     k=48, d = 2 and 4, euclidean and position-normal) against the
     unsharded kNN by sorted pick distances, enqueued with no host sync, and
     card against CPU at N=2048; the sharded trunk against the unsharded
     model on the card (N=16384, the sharded picks replayed, the share of
     points whose neighbours differ printed and bounded) and card against
     CPU at N=2048; ``Predictor.predict_type_sharded`` at the default
     ``Config`` over 4 shards on one N=131072 cloud (ms, peak memory, a
     profile, the CC kernel's launches from 0: the path groups nothing) and its
     ``serve_http`` route at N=16384 against the direct call; the
     reference-checkpoint writer on phase 8's model (equal to a CPU copy's
     file, loads back bit for bit); whether TensorBoard events are written.
 25. the serving bench in-process (``gcanet_tpu_torch.serve_bench.main``,
     the predictors' own seeded weights, 5 timed calls a path): the
     flagship (B=10, N=8192) on ``fwd``, ``predict``, ``batch``,
     ``stream``, the scene family (B=10, grid 48) on the last three; every
     metric line of ``tools/serve_bench.py`` once, finite and positive, the
     CC kernel's launches counted from 0 for each family (warm-ups and all
     paths); the sweep card against its plain version, both timed, on the
     bench's own N=8192 mask (cloud 0's gated mask under the bench
     ``Predictor``'s seeded weights); the voxelize parity ops
     (``ops/voxelize.py``, ``data/native.py``) card against CPU exactly on
     M=65536 coordinates.
 26. the per-stage timer and the convergence runs in-process: first a
     line with each family's largest ``|w| * sqrt(fan_in)`` over the
     convergence runs' random start (seed 0), each at most flax's
     truncated lecun-normal cut 2 / 0.8796...; then
     ``gcanet_tpu_torch.micro_bench.main`` at the bench workload (B=10,
     N=8192) with every default stage and ``edgebwd``, each line of
     ``tools/micro_bench.py`` once, in its order, finite and positive;
     ``convergence_run`` and ``scene_convergence_run`` at their default
     widths for 20 steps with an eval every 10 (the header names the card;
     the rows carry the JAX tools' keys; metrics finite and inside [0, 1]);
     the CC kernel's launches counted from 0 for each of the three; the
     sweep card against its plain version, both timed, on the ``graph``
     stage's item-0 mask.
Weights are random from a seed, with pushes so that the path after
grouping does real work (``push_weights``, ``push_scene_weights``; not in
phases 25 and 26, which run as the tools do).  Each phase prints its seconds.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import glob
import io
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from gcanet_tpu_torch import (bench, convergence_run, micro_bench, scene_convergence_run,
                              serve_bench, train_new)
from gcanet_tpu_torch.losses import mask2former
from gcanet_tpu_torch.config import (Config, GroupingConfig, InstanceHeadConfig,
                                     bench_config, scene_grouping_defaults)
from gcanet_tpu_torch.data import native
from gcanet_tpu_torch.data.synthetic import synth_batch, synth_clouds, synth_scene_batch
from gcanet_tpu_torch.geometry import affinity, fitting, spline
from gcanet_tpu_torch.models import pointnet2 as p2_models
from gcanet_tpu_torch.models.offset_dual import OffsetPredModuleDual
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.models.query_decoder import QueryDecoder
from gcanet_tpu_torch.models.registry import build_model
from gcanet_tpu_torch.models.soft_projection import SoftProjection
from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet
from gcanet_tpu_torch.models.splinenet import DGCNNControlPoints
from gcanet_tpu_torch.models.sppnet import head_losses
from gcanet_tpu_torch.models.transformer import ViT
from gcanet_tpu_torch.ops import cc
from gcanet_tpu_torch.ops import grouping as grouping_ops
from gcanet_tpu_torch.ops import knn as knn_ops
from gcanet_tpu_torch.ops import pointnet2 as p2_ops
from gcanet_tpu_torch.ops import voxelize as vox_ops
from gcanet_tpu_torch.parallel import sharded_encoder
from gcanet_tpu_torch.parallel.sharded_knn import ring_knn, shard_rows, sharded_knn
from gcanet_tpu_torch.serve import Predictor, ScenePredictor
from gcanet_tpu_torch.serve_http import PredictionServer
from gcanet_tpu_torch.train import instances as inst_utils
from gcanet_tpu_torch.train import scene_step
from gcanet_tpu_torch.train import step as step_lib
from gcanet_tpu_torch.train import trainer as trainer_mod
from gcanet_tpu_torch.train.scene_trainer import SceneTrainer
from gcanet_tpu_torch.train.trainer import Trainer
from gcanet_tpu_torch.utils import (from_jax, kernels, profiling, reference_ckpt, threefry,
                                    timing)
from gcanet_tpu_torch.utils.flax_init import TRUNC_STD
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

# the flagship's knobs, card against CPU (phase 18): each one train step at
# phase 7's tolerances (``train_step_card_vs_cpu``; a bf16 trunk at the bf16
# ones)
KNOB_RUNS = {
    "precision=bf16": dict(precision="bf16"),
    "encoder_bf16+shared_graph+revgather:64": dict(encoder_bf16=True, shared_graph=True,
                                                   edge_backward="revgather:64"),
    "mode=3": dict(mode=3),
    "ablation": dict(ablation=True),
}
# remat against no remat on the card: the same program but for the
# recomputation (run with deterministic algorithms, so float atomics do
# not move it)
REMAT_LOSS_RTOL = 1e-6
REMAT_GRAD_ATOL_SHARE = 1e-5
# the reverse-gather backward against the scatter backward: one sum of at
# most M rows in another order (M = the largest in-degree, up to ~100 here)
REVGATHER = dict(rtol=1e-5, atol_share=1e-5)
# HTTP responses against Predictor.predict on the same cloud
HTTP_FLOAT = dict(rtol=1e-3, atol=1e-3)

# the model variants (phase 21): the dual-attention model's registry name
DUAL = "models.dgcnn-hais-concat-direct-2"

# phase 22, card against CPU: the affinities (float32 elementwise, another
# order of the kNN gather's sums; the kNN selections replayed); the fits,
# spline functions and ARAP within 1e-3 relative and of the largest entry
# (3x3 eigh, SVD and small solves in float32 through cuSOLVER).  The mean
# shift's labels exactly, on the card's own embedding too (its distances
# are float64 on both)
AFFINITY = dict(rtol=1e-3, atol=1e-5)
GEOMETRY_RTOL = 1e-3

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
    proposals pass the instance thresholds: small live offsets (the offset
    module's, or ``ablation``'s MLP's), +3 on type 1's bias (most points of
    one type, so a proposal reaches ``min_npoint``: without it the random
    types decide, and under flax's truncated draw phase 4's N=2048 cloud
    kept no instance), +10 on class 0's
    instance-class bias and on the mask MLP's last bias.  In mode 3 the
    normal head's output bias is zeroed and its kernel scaled by 5, so its
    normals vary from point to point (else the normal-angle features of a
    neighbourhood nearly tie under the max over k)."""
    with torch.no_grad():
        offset = (model.offset_linear[2] if model.cfg.ablation
                  else model.offset_pred_block.mlp_offset)
        offset.weight.mul_(0.05)
        model.mlp_prim_prob2.bias[1] += 3.0
        model.cls_linear.bias[0] += 10.0
        model.mask_linear[2].bias += 10.0
        if model.cfg.mode == 3:
            model.mlp_normal_prob2.bias.zero_()
            model.mlp_normal_prob2.weight.mul_(5.0)


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
    smi = timing.device_line("cuda:0")
    check("power limit not read" not in smi, f"nvidia-smi: {smi}")
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


class CallReplay:
    """Stands in for ``module.<name>`` while the card and then the CPU run
    the same step: a grouping (``build_proposals``, ``build_soft_proposals``;
    a hard threshold on floats that differ in the last bits between the
    devices, so grouping itself is checked on identical inputs apart), an
    index search of ``ops/pointnet2.py`` (``furthest_point_sample``,
    ``ball_query``) or the sharded trunk's ring kNN (a list of shards).  The card's results (a tensor or a tuple of tensors)
    are recorded and handed to the CPU, which records whether its own were
    equal, as ``TopkReplay`` does for ``torch.topk``."""

    def __init__(self, name: str = "build_proposals", module=grouping_ops):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.recorded, self.own_equal = [], []
        self.replaying = False

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def __call__(self, *args, **kw):
        res = self.real(*args, **kw)
        if not self.replaying:
            self.recorded.append(res)
            return res
        card = self.recorded[len(self.own_equal)]
        if isinstance(card, torch.Tensor):
            card = card.to(res.device)
            self.own_equal.append(torch.equal(res, card))
        elif isinstance(card, list):                # per-shard results (ring kNN)
            card = [c.to(r.device) for c, r in zip(card, res)]
            self.own_equal.append(all(torch.equal(a, b) for a, b in zip(res, card)))
        else:
            card = _to(card, res[0].device)
            self.own_equal.append(all(torch.equal(a, b) for a, b in zip(res, card)))
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


def phase_card_vs_cpu(model_dict: str = Config.model_dict, tag: str = "card-vs-cpu") -> None:
    """The card against the CPU on one input.  The network's floats agree
    to a tolerance, with the card's top-k selections replayed on the CPU
    (``TopkReplay``); grouping and instance extraction are hard thresholds
    on those floats (radius, embedding gate, class argmax), so they are
    held exactly on IDENTICAL inputs on both devices, and the end-to-end
    drift is reported.  ``model_dict`` names the model (phase 21: the
    dual-attention variant); ``tag`` prefixes the lines."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config(model_dict=model_dict, num_points=2048,
                 instance_head=InstanceHeadConfig(max_proposals=24))
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
        print(f"[{tag}] top-k rows the CPU alone would select differently, per "
              f"call (replaced by the card's selection): {topk.differing}")

        for name in ("type_per_point", "param_per_point", "semantic_scores",
                     "embedding", "pt_offsets"):
            g, w = getattr(out_card, name).cpu(), getattr(out_cpu, name)
            check(bool(torch.isfinite(g).all()), f"{name} not finite")
            err = float((g - w).abs().max())
            ok = torch.allclose(g, w, **CARD_VS_CPU_FLOAT)
            print(f"[{tag}] {name}: max_abs_err {err:.3g} of max |x| "
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
        print(f"[{tag}] proposals on identical inputs: equal "
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
            print(f"[{tag}] instance head {name} (bf16): max_abs_err {err:.3g} "
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
        print(f"[{tag}] merged labels, keep, npoint, covered on identical inputs: "
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
        print(f"[{tag}] end to end (CPU with the card's top-k): proposals.num card "
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
    out = step_lib.train_forward(model, batch, r1=r1)
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
    errors; raises on any that is out of tolerance.  With the trunk in bf16
    (``precision="bf16"`` or ``encoder_bf16``) every loss is held at
    ``CARD_VS_CPU_BF16`` and both gradients by their cosine, as the bf16
    head's are."""
    trunk_bf16 = cfg.precision == "bf16" or cfg.encoder_bf16
    models, batches = {}, {}
    for dev in ("cuda", "cpu"):
        models[dev] = PrimitiveNet(cfg).to(dev)
        models[dev].load_state_dict(state)
        models[dev].instance_head.compute_bf16 = head_bf16
        batches[dev] = step_lib.batch_to_device(batch_np, dev)
    with TopkReplay() as topk, CallReplay() as props:
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
        tol = (CARD_VS_CPU_BF16 if trunk_bf16 or (head_bf16 and k in ("inst_loss", "total_loss"))
               else TRAIN_LOSS)
        check(torch.allclose(g, w, **tol), f"{k}: card {float(g)} CPU {float(w)}")
        worst = max(worst, float((g - w).abs()) / max(abs(float(w)), 1e-12))
    res["loss_max_rel_err"] = worst

    for tag, i in (("rest", 2), ("inst", 3)):
        want, got = cpu[i], card[i]
        if trunk_bf16 or (tag == "inst" and head_bf16):
            cos = _grad_cosine(want, got)
            res[f"{tag}_grad_cosine"] = cos
            check(cos >= TRAIN_BF16_MIN_COSINE, f"{tag} gradient cosine {cos}")
            continue
        res[f"{tag}_grad_atol_share_needed"], res[f"{tag}_grad_max_rel_l2"] = _hold_gradients(
            "train-vs-cpu", tag, want, got, TRAIN_GRAD_ATOL_SHARE[tag])

    stats_tol = CARD_VS_CPU_BF16 if head_bf16 or trunk_bf16 else TRAIN_STATS
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


def phase_training(log_dir: str) -> tuple[int, torch.nn.Module]:
    """Phase 8: full width through ``Trainer.train_one_epoch``: a warm-up
    epoch of 2 steps, then one epoch of 2 + 5 steps whose last 5 are timed.
    The window runs from the start of the epoch's 3rd step to the end of
    its 7th, so it holds what a long epoch repeats (a step; the next batch
    made and copied on the prefetch thread) and not what an epoch does
    once (starting that thread, which slows the epoch's first step; its
    time is printed apart).  Returns the CC kernel's launches in the
    epoch and the trained model (phase 24 writes it as a reference
    checkpoint)."""
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
    return launches["masked_min_sweep"], trainer.model


def _profile(label: str, fn) -> None:
    """Device time by op over ``fn()``, and the device's busy share of the
    host-clock window (kernel and copy time summed)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _print_profile(label, prof, wall_us)


def _print_profile(label: str, prof, wall_us: float) -> None:
    from torch.autograd import DeviceType

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
    with TopkReplay() as topk, CallReplay() as props:
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


def _host_pair_matches_device(log_dir: str, n_clouds: int,
                              model_dict: str = Config.model_dict) -> list[int]:
    """``get_instances`` + ``merge_masks`` on the host, from the fetched
    outputs of latest.tar's eval step on each synthetic eval cloud, against
    the card's ``merged_labels_device``; returns the kept instances per
    cloud."""
    cfg = Config(model_dict=model_dict)
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


def phase_cli(smi: str, model_dict: str = Config.model_dict, tag: str = "cli") -> dict:
    """Phase 11: ``train_new.main`` at full width, training and then
    ``--eval`` (phase 21: with ``--model_dict`` the dual-attention variant;
    ``tag`` prefixes the lines).  Returns the CC kernel's launches in each
    run."""
    n_eval = 8                                      # the trainer's synthetic eval clouds
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as root, \
            cli_hooks(synth_batches=2) as (trainers, eval_seconds):
        log_dir = os.path.join(root, "log")
        argv = ["--model_dict", model_dict, "--log_dir", log_dir,
                "--data_path", os.path.join(root, "none"),
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
        kept = _host_pair_matches_device(log_dir, n_eval, model_dict)

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
    print(f"[{tag}] main(train): N={n} B={b}, {len(steps)} steps in 2 epochs, eval of "
          f"{n_eval} clouds (B=1) after each; ms per train step (CUDA events) "
          f"{[round(t, 1) for t in step_ms]}, after the first "
          f"{np.mean(step_ms[1:]):.1f} ms ({smi})")
    print(f"[{tag}] ms per eval cloud (host clock around test_one_epoch): epoch 0 "
          f"{eval_ms[0]:.1f}, epoch 1 {eval_ms[1]:.1f}, --eval {eval_ms[2]:.1f}; eval peak "
          f"memory {eval_peak / 2**30:.2f} GiB ({smi})")
    print(f"[{tag}] masked_min_sweep launches: train run {train_run} (train steps "
          f"{step_launches}, evals {train_run - step_launches}); --eval run {eval_run}, "
          f"{eval_run / n_eval:.1f} sweeps per eval cloud ({smi})")
    print(f"[{tag}] --eval reproduces epoch 1: miou {again['miou']:.4f}, type_miou "
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
        with CallReplay("build_soft_proposals") as props:
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
    with CallReplay("build_soft_proposals") as props:
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


def _remat_card_run(cfg: Config, state: dict, batch_np: dict, r1: torch.Tensor):
    model = PrimitiveNet(cfg).cuda()
    model.load_state_dict(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, ld, g_rest, g_inst = _forward_backward(model, step_lib.batch_to_device(batch_np, "cuda"),
                                              r1.cuda())
    return ld, g_rest, g_inst, torch.cuda.max_memory_allocated()


def _revgather_check(card_name: str) -> None:
    """``gather_neighbors_rev``'s backward against the scatter backward at a
    bench-like shape: the kNN graph of B=2 random clouds of N=8192 at K=48,
    C=64, M = the graph's largest in-degree."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, n, k, c = 2, 8192, 48, 64
    idx = knn_ops.knn_indices(torch.rand(b, n, 3, device="cuda", generator=gen), k)
    m = int(max(torch.bincount(idx[i].flatten(), minlength=n).max() for i in range(b)))
    x = torch.randn(b, n, c, device="cuda", generator=gen, requires_grad=True)
    g = torch.randn(b, n, k, c, device="cuda", generator=gen)

    def backward(gather):
        return torch.autograd.grad(gather(x, idx), x, g)[0]

    want = backward(knn_ops.gather_neighbors)
    got = backward(lambda xx, ii: knn_ops.gather_neighbors_rev(xx, ii, m))
    scale = float(want.abs().max())
    excess = float(((got - want).abs() - REVGATHER["rtol"] * want.abs()).max()) / scale
    check(excess <= REVGATHER["atol_share"],
          f"revgather backward differs from the scatter backward ({excess:.3g})")
    times = {}
    for name, gather in (("scatter", knn_ops.gather_neighbors),
                         ("revgather", lambda xx, ii: knn_ops.gather_neighbors_rev(xx, ii, m))):
        out = gather(x, idx)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for rep in range(6):                                  # one warm-up, five timed
            if rep == 1:
                start.record()
            torch.autograd.grad(out, x, g, retain_graph=True)
        end.record()
        end.synchronize()
        times[name] = start.elapsed_time(end) / 5
    print(f"[knobs] gather backward B={b} N={n} K={k} C={c}, M = largest in-degree {m}: "
          f"revgather against scatter max_abs_err {float((got - want).abs().max()):.3g} of "
          f"max |g| {scale:.3g} (excess over rtol {REVGATHER['rtol']}: {excess:.3g} of the "
          f"largest entry); backward ms scatter {times['scatter']:.3f}, revgather "
          f"{times['revgather']:.3f} ({card_name})")


def phase_knobs_card_vs_cpu(card_name: str) -> None:
    """Phase 18: one train step under each of ``KNOB_RUNS``, card against
    CPU (N=2048, B=2, TF32 off, top-k and proposals replayed), the head in
    bf16 as shipped; ``remat`` against no remat on the card (fp32, and bf16
    with ``encoder_bf16``); the reverse-gather backward against the scatter
    backward at a bench-like shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = Config(num_points=2048, batch_size=2,
                  grouping=GroupingConfig(class_numpoint_mean=(-1.0,) * 7,
                                          similarity_threshold_inst=0.9),
                  instance_head=InstanceHeadConfig(max_proposals=24))
    batch = synth_batch(base, base.batch_size, seed=3)
    r1 = torch.rand((2, 3), generator=torch.Generator().manual_seed(4))
    for label, kw in KNOB_RUNS.items():
        cfg = base.replace(**kw)
        model = PrimitiveNet(cfg)
        push_weights(model)
        res = train_step_card_vs_cpu(cfg, model.state_dict(), batch, r1, head_bf16=True)
        res.pop("cpu_forward")
        print(f"[knobs-vs-cpu] {label}: "
              + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in res.items()))

    def differences(a, b):
        """The largest relative loss difference and gradient difference as a
        share of the largest entry, between two ``_remat_card_run``s."""
        loss = max(float((b[0][k] - w).abs()) / max(abs(float(w)), 1e-12)
                   for k, w in a[0].items())
        grad = max(max(float((got[k] - w).abs().max()) for k, w in want.items())
                   / max(float(w.abs().max()) for w in want.values())
                   for want, got in ((a[1], b[1]), (a[2], b[2])))
        return loss, grad

    # float atomics (index_add_ after grouping, the gather's scatter
    # backward) make two runs of one step differ in the last bits; the
    # comparison runs with torch's deterministic algorithms, which have a
    # deterministic form of each, and prints the default mode's repeat
    # difference beside it
    for kw in ({}, dict(precision="bf16", encoder_bf16=True)):
        model = PrimitiveNet(base.replace(**kw))
        push_weights(model)
        state = model.state_dict()
        repeat = differences(*(_remat_card_run(base.replace(**kw), state, batch, r1)
                               for _ in range(2)))
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            plain, remat = (_remat_card_run(base.replace(remat=remat, **kw), state, batch, r1)
                            for remat in (False, True))
        finally:
            torch.use_deterministic_algorithms(False)
        loss, grad = differences(plain, remat)
        print(f"[knobs] remat against no remat on the card {kw or 'fp32'}, deterministic "
              f"algorithms: losses within {loss:.3g} relative, gradients within {grad:.3g} x "
              f"the largest entry (two runs without remat, default algorithms: {repeat[0]:.3g}, "
              f"{repeat[1]:.3g}); peak memory {plain[3] / 2**30:.2f} -> {remat[3] / 2**30:.2f} "
              f"GiB (N=2048, B=2)")
        check(loss <= REMAT_LOSS_RTOL and grad <= REMAT_GRAD_ATOL_SHARE,
              f"remat moves a loss by {loss:.3g} or a gradient by {grad:.3g}")
    _revgather_check(card_name)


@contextlib.contextmanager
def bench_env(**env: str):
    """``os.environ`` with the given ``GCA_BENCH_*`` knobs, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _bench_line(label: str, smi: str, **env: str) -> tuple[dict, int]:
    """One in-process ``bench.main`` run at full width: its JSON line, peak
    memory and the CC kernel's launches per step (warm-up included).  If the
    batch does not fit in the card's memory, the largest of 8, 6, 4, 3 that
    does is run, and both are printed."""
    batch = int(env.get("GCA_BENCH_BATCH", "8" if env.get("GCA_BENCH_FAMILY") == "scene"
                        else "10"))
    tried = []
    while True:
        with bench_env(**env, GCA_BENCH_BATCH=str(batch)):
            _reset_launches()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    row = bench.main([])
            except torch.cuda.OutOfMemoryError as e:
                tried.append(batch)
                print(f"[bench] {label}: B={batch} does not fit: {str(e).splitlines()[0]}")
                smaller = [b for b in (8, 6, 4, 3) if b < batch]
                check(bool(smaller), f"{label}: no batch fits")
                batch = smaller[0]
                continue
        break
    lines = out.getvalue().splitlines()
    check(len(lines) == 1 and json.loads(lines[0]) == row,
          f"{label}: the bench printed {lines}, not one JSON line")
    steps = int(os.environ.get("GCA_BENCH_ITERS", "10")) + 1
    launches = _launches()["masked_min_sweep"]
    peak = torch.cuda.max_memory_allocated()
    check(launches > 0, f"masked_min_sweep was not launched by the bench ({label})")
    check(row["value"] > 0, f"{label}: {row}")
    print(f"[bench] {label}: B={batch}{f' (did not fit: {tried})' if tried else ''} "
          f"{json.dumps(row)}; {1e3 * batch / row['value']:.1f} ms/step, peak memory "
          f"{peak / 2**30:.2f} GiB, masked_min_sweep {launches / steps:.1f} launches per step "
          f"({launches / (steps * batch):.1f} sweeps per cloud) ({smi})")
    return row, launches


def phase_bench(card_name: str, smi: str) -> dict:
    """Phase 19: ``gcanet_tpu_torch.bench.main`` at full width, in-process,
    torch's default TF32 settings: the flagship (B=10, N=8192), the scene
    family (B=8, grid 48), the flagship with ``GCA_BENCH_ENC_BF16=1
    GCA_BENCH_EDGE_BWD=revgather:64 GCA_BENCH_SHARED_GRAPH=1``; a profile of
    two flagship bench steps; then the sweep timed on the bench's own N=8192
    mask (cloud 0's gated mask)."""
    torch.backends.cuda.matmul.allow_tf32 = False          # torch's defaults
    torch.backends.cudnn.allow_tf32 = True
    launches = {}
    for label, env in (("flagship", {}), ("scene", {"GCA_BENCH_FAMILY": "scene"}),
                       ("flagship knobs", {"GCA_BENCH_ENC_BF16": "1",
                                           "GCA_BENCH_EDGE_BWD": "revgather:64",
                                           "GCA_BENCH_SHARED_GRAPH": "1"})):
        launches[label] = _bench_line(label, smi, **env)[1]

    cfg, model, optimizer, batch, step, _ = bench.build("abc", torch.device("cuda"))
    shifts = [step_lib.grid_shift(threefry.key(1), i, "cuda") for i in range(3)]
    step(model, optimizer, batch, r1=shifts[0])                    # warm-up
    _profile(f"2 bench steps (B={cfg.batch_size}, N={cfg.num_points}, forward + backward "
             f"+ Adam)", lambda: [step(model, optimizer, batch, r1=r1) for r1 in shifts[1:]])
    with torch.inference_mode():
        out = model.eval()(batch["gt_pc"][:1], batch["gt_normal"][:1])
    n = cfg.num_points
    shifted = (batch["gt_pc"][0] + out.pt_offsets).float()
    nbr, _ = grouping_ops.gated_neighbor_mask(
        shifted, out.semantic_scores.argmax(-1).to(torch.int32), out.embedding[0].float(),
        out.param_per_point[0].float(), cfg.num_primitives, cfg.grouping)
    labels = torch.arange(n, dtype=torch.int32, device="cuda")
    check(torch.equal(cc.masked_min_sweep(nbr, labels), cc.masked_min_sweep_plain(nbr, labels)),
          "sweep on the bench's mask")
    ms = time_graph(lambda: cc.masked_min_sweep(nbr, labels), 100)
    plain_ms = time_graph(lambda: cc.masked_min_sweep_plain(nbr, labels), 10)
    bound_ms = (n * n + 8 * n) / hbm_rate(card_name) * 1e3
    print(f"[kernel] masked_min_sweep on the bench's N={n} mask ({int(nbr.sum())} edges): "
          f"{ms * 1e3:.2f} us/sweep, plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} "
          f"us, {bound_ms / ms:.1%} of the bound ({smi})")
    return {"launches": launches,
            "mask": {"n": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}}


def _post_json(url: str, body: bytes) -> tuple[int, dict, float]:
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read()), time.perf_counter() - t0


def _http_matches_predict(got: dict, want: dict) -> bool:
    """A JSON response against ``Predictor.predict``'s dict: types, labels
    and instances exactly, ``conf`` at ``HTTP_FLOAT``."""
    return (got["types"] == want["type_per_point"].argmax(-1).tolist()
            and got["instance_labels"] == want["instance_labels"].tolist()
            and [(i["label_id"], i["npoint"], i["pred_mask"]) for i in got["instances"]]
            == [(i["label_id"], i["npoint"], i["pred_mask"]) for i in want["instances"]]
            and np.allclose([i["conf"] for i in got["instances"]],
                            [i["conf"] for i in want["instances"]], **HTTP_FLOAT))


def phase_serving_extras(smi: str) -> dict:
    """Phase 20: the serving extras at full width (default ``Config``,
    N=7000, pushed weights): ``predict(return_masks=True, panoptic=True)`` on
    3 clouds, whose instances, labels and panoptic labels must equal the
    host ``get_instances`` / ``merge_masks`` / ``panoptic_fusion`` on the
    card's own fetched arrays; ``--strict_caps`` grouping (and tighter caps)
    with set aggregation, card against CPU on identical inputs, exactly;
    ``serve_http`` on 127.0.0.1 over a card ``Predictor`` (B=4, a proposal
    cap no micro-batch reaches), 16 concurrent requests, each response
    equal to ``Predictor.predict`` on its cloud.  Returns the CC kernel's
    launches of the masks path and of the HTTP requests."""
    cfg = Config()
    n, clouds = cfg.num_points, 3
    pred = Predictor(cfg, device="cuda")
    push_weights(pred.model)
    xyz, nrm = synth_clouds(cfg, 16, seed=8)
    pred.predict(xyz[0], nrm[0], return_masks=True)               # warm-up
    fetched, real = [], pred._forward_masks
    pred._forward_masks = lambda a, b: fetched.append(real(a, b)) or fetched[-1]
    _reset_launches()
    t0 = time.perf_counter()
    results = [pred.predict(xyz[i], nrm[i], return_masks=True, panoptic=True)
               for i in range(clouds)]
    t_masks = (time.perf_counter() - t0) / clouds
    masks_launches = _launches()["masked_min_sweep"]
    del pred._forward_masks
    check(masks_launches > 0, "masked_min_sweep was not launched on the masks path")
    for res, (pid, sem, cls_s, iou_s, mask_s, valid, tpp, _, _, _) in zip(results, fetched):
        want = inst_utils.get_instances(pid, sem, cls_s, iou_s, mask_s, valid,
                                        cfg.num_primitives)
        check(res["instances"] == want, "return_masks instances differ from get_instances")
        merged = inst_utils.merge_masks(want) if want else np.zeros(n, np.int32)
        check(np.array_equal(res["instance_labels"], merged), "return_masks labels")
        check(np.array_equal(res["panoptic"], inst_utils.panoptic_fusion(
            tpp.argmax(-1), want, cfg.num_primitives)), "panoptic labels")
    kept = [len(r["instances"]) for r in results]
    check(all(k > 0 for k in kept), f"the masks path kept no instance: {kept}")
    print(f"[extras] predict(return_masks=True, panoptic=True) N={n}: {t_masks * 1e3:.1f} "
          f"ms per cloud, instances {kept} (overlapping RLE masks; equal to the host "
          f"get_instances / merge_masks / panoptic_fusion on the fetched arrays), "
          f"masked_min_sweep {masks_launches} launches ({smi})")

    # set aggregation with the absorb caps: card against CPU on identical inputs
    with torch.inference_mode():
        out = pred.model(torch.as_tensor(xyz[:2], device="cuda"),
                         torch.as_tensor(nrm[:2], device="cuda"))
        g_cpu = tuple(t.cpu() for t in _model_inputs_to_grouping(
            out, torch.as_tensor(xyz[:2], device="cuda")))
    absorbed = {}
    for label, caps in (("uncapped", {}),
                        ("strict_caps", dict(neighbor_cap=3000, absorb_fragment_cap=1000,
                                             absorb_point_cap=3000)),
                        ("tight caps", dict(absorb_fragment_cap=2, absorb_point_cap=50))):
        # the mean table at the synthetic clouds' scale (N/5), so primaries
        # exist below the proposal cap and fragments are absorbed
        kw = dict(num_classes=cfg.num_primitives, max_proposals=cfg.instance_head.max_proposals,
                  using_set_aggr=True, cfg=dataclasses.replace(
                      cfg.grouping, class_numpoint_mean=(n / 5.0,) * 10, **caps))
        props_cpu = grouping_ops.build_proposals(*g_cpu, **kw)
        props_card = grouping_ops.build_proposals(*(t.cuda() for t in g_cpu), **kw)
        for field in props_cpu._fields:
            check(torch.equal(getattr(props_card, field).cpu(), getattr(props_cpu, field)),
                  f"{label} proposals.{field} differ between card and CPU")
        absorbed[label] = int((props_cpu.point_pid[1] >= 0).sum())
    print(f"[extras] set aggregation with absorb caps, card = CPU exactly on identical "
          f"inputs (B=2, N={n}, mean table N/5); absorbed points {absorbed}")
    check(0 < absorbed["tight caps"] < absorbed["uncapped"],
          f"the absorb caps did not bite: {absorbed}")

    # serve_http: 16 concurrent requests over a card Predictor, micro-batches
    # of 4.  A batch's clouds share its proposal cap, so a cloud's result
    # depends on the clouds batched with it once the cap binds; the server
    # here gets a cap that 4 of these clouds cannot reach (4 times the most
    # proposals one of them makes uncapped), and each response must equal
    # Predictor.predict of its cloud at that cap.
    with torch.inference_mode():
        nums = []
        for i in range(16):
            xi = torch.as_tensor(xyz[i:i + 1], device="cuda")
            oi = pred.model(xi, torch.as_tensor(nrm[i:i + 1], device="cuda"))
            nums.append(int(grouping_ops.build_proposals(
                *_model_inputs_to_grouping(oi, xi), cfg.num_primitives, cfg.grouping,
                max_proposals=n).num))
    http_cfg = cfg.replace(batch_size=4, instance_head=dataclasses.replace(
        cfg.instance_head, max_proposals=4 * max(nums)))
    srv = PredictionServer(http_cfg, pred.model.state_dict(), family="abc", max_wait_ms=15.0,
                           device="cuda")
    want = [srv.predictor.predict(xyz[i], nrm[i]) for i in range(16)]
    ready = threading.Event()
    thread = threading.Thread(target=srv.serve, kwargs=dict(host="127.0.0.1", port=0,
                                                            ready_event=ready), daemon=True)
    thread.start()
    try:
        check(ready.wait(60), "the HTTP server did not start")
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/predict"
        bodies = [json.dumps({"xyz": xyz[i].tolist(), "normals": nrm[i].tolist()}).encode()
                  for i in range(16)]
        _post_json(url, bodies[0])                                  # warm-up
        _reset_launches()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            answers = list(pool.map(lambda body: _post_json(url, body), bodies))
        wall = time.perf_counter() - t0
        http_launches = _launches()["masked_min_sweep"]
    finally:
        srv.shutdown()
        thread.join(60)
    check(not thread.is_alive(), "the HTTP server did not stop")
    check(http_launches > 0, "masked_min_sweep was not launched by the HTTP requests")
    same = [status == 200 and _http_matches_predict(body, w)
            for (status, body, _), w in zip(answers, want)]
    lat = sorted(t for _, _, t in answers)
    print(f"[extras] serve_http, 16 concurrent requests, N={n}, micro-batches of 4 (uncapped "
          f"proposals per cloud {nums}, cap {http_cfg.instance_head.max_proposals} per batch): "
          f"{16 / wall:.2f} requests/s, latency p50 {lat[7] * 1e3:.1f} ms, p99 "
          f"{lat[-1] * 1e3:.1f} ms; responses equal to Predictor.predict: {sum(same)} of 16; "
          f"masked_min_sweep {http_launches} launches ({smi})")
    check(all(same), f"HTTP responses differ from Predictor.predict: {same}")
    return {"serve_masks": masks_launches, "serve_http": http_launches}


# ---------------------------------------------------------------- phase 21


def _card_vs_cpu_module(label: str, make, args_cpu: tuple, train: bool = False,
                        tol=CARD_VS_CPU_FLOAT):
    """One module built by ``make()`` (seeded weights), copied to the card,
    run on ``args_cpu`` there and on the CPU with the card's index searches
    replayed; every float output at ``tol``, integer outputs exactly, and in
    training mode the new running statistics.  Returns both outputs."""
    cpu = make().train(train)
    card = make().train(train).cuda()
    card.load_state_dict(cpu.state_dict())
    args_card = tuple(a.cuda() if isinstance(a, torch.Tensor) else a for a in args_cpu)
    with TopkReplay() as topk, CallReplay("furthest_point_sample", p2_ops) as fps, \
            CallReplay("ball_query", p2_ops) as ball, torch.no_grad():
        got = card(*args_card)
        topk.replaying = fps.replaying = ball.replaying = True
        want = cpu(*args_cpu)
    flat = (lambda o: [o] if isinstance(o, torch.Tensor) else
            [t for v in (o.values() if isinstance(o, dict) else o) for t in flat(v)])
    pairs = list(zip(flat(got), flat(want)))
    worst = 0.0
    for g, w in pairs:
        g = g.detach().cpu()
        w = w.detach()
        if w.dtype.is_floating_point:
            check(bool(torch.isfinite(g).all()), f"{label}: output not finite")
            check(torch.allclose(g, w, **tol), f"{label}: card and CPU differ")
            worst = max(worst, float((g - w).abs().max()))
        else:
            check(torch.equal(g, w), f"{label}: integer output differs")
    if train:
        sd_card, sd_cpu = card.state_dict(), cpu.state_dict()
        for k, w in sd_cpu.items():
            if "running" in k:
                check(torch.allclose(sd_card[k].cpu(), w, **tol), f"{label}: {k}")
    print(f"[variants] {label}: {len(pairs)} outputs card = CPU, float max_abs_err "
          f"{worst:.3g} ({tol}); CPU's own top-k / FPS / ball-query equal to the card's: "
          f"{sum(r == 0 for r, _ in topk.differing)}/{len(topk.differing)}, "
          f"{sum(fps.own_equal)}/{len(fps.own_equal)}, {sum(ball.own_equal)}/{len(ball.own_equal)}")
    return got, want


def _library_modules() -> None:
    """SplineNet (both modes, train and eval), a multi-scale SA module, an
    FP module, soft projection, ViT and the query decoder with its
    Hungarian criterion, each once on the card and on the CPU at a small
    size (TF32 off)."""
    gen = torch.Generator().manual_seed(21)
    pts = torch.rand(8, 512, 3, generator=gen) * 2 - 1
    for mode in (0, 1):
        for train in (False, True):
            _card_vs_cpu_module(f"SplineNet mode {mode} {'train' if train else 'eval'}",
                                lambda: DGCNNControlPoints(20, 20, mode), (pts,), train)
    xyz, feats = torch.rand(2, 1024, 3, generator=gen), torch.randn(2, 1024, 6, generator=gen)
    (new_xyz, new_f), _ = _card_vs_cpu_module(
        "PointnetSAModuleMSG", lambda: p2_models.PointnetSAModuleMSG(
            128, [0.1, 0.2], [16, 32], [[32, 32, 64], [64, 64, 128]], in_channels=6),
        (xyz, feats), train=True)
    # unknown points apart from the known ones: at a known point the 3-NN
    # distance is 0 up to the expansion's rounding, and 1 / (dist + 1e-8)
    # turns that rounding into percents of the interpolation weights
    unknown = torch.rand(2, 1024, 3, generator=gen)
    _card_vs_cpu_module("PointnetFPModule", lambda: p2_models.PointnetFPModule(
        [128, 64], in_channels=192 + 6), (unknown, new_xyz.cpu(), feats, new_f.cpu()),
        train=True)
    cloud, query = torch.rand(2, 1024, 3, generator=gen), torch.rand(2, 256, 3, generator=gen)
    _card_vs_cpu_module("SoftProjection", lambda: SoftProjection(8, 0.1),
                        (cloud, query, torch.randn(2, 1024, 16, generator=gen),
                         "project_and_propagate"))
    img = torch.randn(4, 3, 32, 32, generator=gen)
    _card_vs_cpu_module("ViT", lambda: ViT(32, 8, 10, 64, 2, 4, 128, dim_head=16), (img,))
    x = torch.randn(2, 256, 32, generator=gen)
    got, want = _card_vs_cpu_module("QueryDecoder", lambda: QueryDecoder(
        num_layer=2, num_query=8, num_class=6, in_channel=32, d_model=64, nhead=4,
        hidden_dim=128, use_pe=True), (x,))
    gt_masks = (torch.rand(6, 256, generator=gen) < 0.2).float()
    gt_cls = torch.tensor([0, 1, 2, 3, 4, 1])
    gt_valid = torch.tensor([True, True, True, False, True, True])
    for b in range(2):
        res = [mask2former.criterion({"labels": o["labels"][b], "masks": o["masks"][b]},
                                     gt_masks.to(dev), gt_cls.to(dev), gt_valid.to(dev), 6)
               for o, dev in ((got, "cuda"), (want, "cpu"))]
        check(torch.equal(res[0]["assign"].cpu(), res[1]["assign"]),
              f"Hungarian assignment of item {b} differs between card and CPU")
        for k in ("cls_loss", "dice_loss", "bce_loss", "loss"):
            check(torch.allclose(res[0][k].cpu(), res[1][k], **TRAIN_LOSS), f"criterion {k}")
        losses = ", ".join(f"{k} {float(v):.4g}" for k, v in res[1].items() if k != "assign")
        print(f"[variants] criterion item {b}: assignment {res[1]['assign'].tolist()} equal on "
              f"card and CPU; losses {losses} within {TRAIN_LOSS}")


def _dual_serving(card_name: str, smi: str) -> int:
    """The dual model at full width through ``Predictor``: ``predict_batch``
    at B=4 (3 batches, clouds/s, peak memory, the CC kernel's launches with
    the counts set to 0 just before and read just after), then
    ``predict_stream`` over 2 batches equal to ``predict_batch``, and a
    profile of two batches."""
    cfg = Config(model_dict=DUAL)
    n, b, reps = cfg.num_points, 4, 3
    pred = Predictor(cfg, device="cuda")
    check(isinstance(pred.model.offset_pred_block, OffsetPredModuleDual), "not the dual model")
    push_weights(pred.model)
    xyz, nrm = synth_clouds(cfg, b, seed=2)
    pred.predict_batch(xyz, nrm)                          # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        batch = pred.predict_batch(xyz, nrm)
    t_batch = time.perf_counter() - t0
    launches = _launches()["masked_min_sweep"]
    peak = torch.cuda.max_memory_allocated()
    stream = list(pred.predict_stream([(xyz, nrm)] * 2, depth=2))
    check(len(stream) == 2 * b and same_dicts(stream[:b], batch)
          and same_dicts(stream[b:], batch), "dual predict_stream differs from predict_batch")
    _profile(f"dual: 2 x predict_batch(B={b}, N={n})",
             lambda: [pred.predict_batch(xyz, nrm) for _ in range(2)])
    for r in batch:
        check(r["pt_offsets"].shape == (n, 3) and r["instance_labels"].shape == (n,)
              and all(np.isfinite(r[k]).all() for k in
                      ("type_per_point", "param_per_point", "pt_offsets")), "dual outputs")
    check(launches > 0, "masked_min_sweep was not launched on the dual serving path")
    print(f"[variants] dual serving N={n} B={b}: predict_batch {b * reps / t_batch:.2f} "
          f"clouds/s ({t_batch / reps * 1e3:.1f} ms/batch), peak memory {peak / 2**30:.2f} GiB, "
          f"kept instances per cloud {[len(r['instances']) for r in batch]}; masked_min_sweep "
          f"{launches} launches, {launches / (b * reps):.1f} sweeps per cloud; predict_stream "
          f"(2 batches, depth 2) equal to predict_batch ({smi})")
    return launches


def _dual_training(log_dir: str, smi: str) -> int:
    """The dual model at full width through ``Trainer.train_one_epoch``
    (B=3): a warm-up epoch of 2 steps, then 2 + 5 steps of which the last 5
    are timed (CUDA events), with the launch counts set to 0 just before and
    read just after; then a profile of two steps."""
    cfg = Config(model_dict=DUAL, log_dir=log_dir, data_path=log_dir)
    warm, steps, b = 2, 5, cfg.batch_size
    trainer = Trainer(cfg)
    try:
        check(isinstance(trainer.model.offset_pred_block, OffsetPredModuleDual),
              "not the dual model")
        push_weights(trainer.model)
        trainer.train_one_epoch(0, num_batches=2)
        torch.cuda.synchronize()
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with step_events() as marks:
            history = trainer.train_one_epoch(1, num_batches=warm + steps)
        launches = _launches()["masked_min_sweep"]
        peak = torch.cuda.max_memory_allocated()
        _profile(f"dual: 2 train steps (B={b}, N={cfg.num_points}, forward + backward + Adam)",
                 lambda: trainer.train_one_epoch(2, num_batches=2))
    finally:
        trainer.close()
    ms = marks[warm][0].elapsed_time(marks[-1][1]) / steps
    per_step = [n for _, _, n, _, _ in marks]
    totals = [float(m["total_loss"]) for m in history]
    check(all(np.isfinite(float(v)) for m in history for v in m.values()),
          f"a dual train step's loss is not finite: {totals}")
    check(all(n > 0 for n in per_step), "a dual train step launched no CC sweep")
    timed = sum(per_step[warm:])
    print(f"[variants] dual training N={cfg.num_points} B={b}: {ms:.1f} ms/step over {steps} "
          f"steps (CUDA events), {b * 1e3 / ms:.2f} examples/s, peak memory "
          f"{peak / 2**30:.2f} GiB; total_loss {[round(t, 4) for t in totals]}; "
          f"masked_min_sweep {launches} launches, {timed / steps:.1f} per timed step, "
          f"{timed / (steps * b):.1f} sweeps per cloud ({smi})")
    return launches


def _sppnet_checks(smi: str) -> None:
    """SPP-Net: the forward card against CPU at N=2048 (the card's top-k
    replayed), 4 head-loss Adam steps on the card (finite, falling), and
    the forward timed at N=7000, B=4."""
    cfg = Config(model_dict="models.sppnet", num_points=2048)
    batch = synth_batch(cfg, 2, seed=6)
    xyz, nrm = torch.as_tensor(batch["gt_pc"]), torch.as_tensor(batch["gt_normal"])
    _card_vs_cpu_module("SPP-Net N=2048", lambda: build_model(cfg).eval(), (xyz, nrm))
    model = build_model(cfg).cuda()
    opt = step_lib.make_optimizer(cfg, model.parameters())
    tb = step_lib.batch_to_device(batch, "cuda")
    losses = []
    for _ in range(4):
        opt.zero_grad()
        loss = head_losses(model(tb["gt_pc"], tb["gt_normal"]), tb, cfg.max_instances)["total"]
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"SPP-Net head-loss steps: {losses}")

    full = Config(model_dict="models.sppnet")
    b = 4
    model = build_model(full).cuda().eval()
    x, n = (torch.as_tensor(a, device="cuda") for a in synth_clouds(full, b, seed=7))
    with torch.inference_mode():
        model(x, n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            out = model(x, n)
        end.record()
        end.synchronize()
    ms = start.elapsed_time(end) / 5
    check(all(bool(torch.isfinite(t).all()) for t in out), "SPP-Net outputs not finite")
    print(f"[variants] SPP-Net head-loss Adam steps (N=2048, B=2) total {losses}; forward "
          f"N={full.num_points} B={b}: {ms:.1f} ms ({b * 1e3 / ms:.1f} clouds/s, CUDA events "
          f"over 5), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")


def phase_variants(card_name: str, smi: str) -> dict:
    """Phase 21: the model variants.  The dual-attention (``-2``) model card
    against CPU (N=2048, B=2, TF32 off: the forward as phase 4 holds it, a
    train step as phase 7 does, head in fp32 and bf16); at full width its
    serving, training and ``train_new`` then ``--eval``; SPP-Net; the
    library modules.  Returns the CC kernel's launches on the dual paths."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card_vs_cpu(DUAL, "dual-vs-cpu")
    cfg = Config(num_points=2048, batch_size=2, offset_variant="dual",
                 grouping=GroupingConfig(class_numpoint_mean=(-1.0,) * 7,
                                         similarity_threshold_inst=0.9),
                 instance_head=InstanceHeadConfig(max_proposals=24))
    model = PrimitiveNet(cfg)
    push_weights(model)
    batch = synth_batch(cfg, cfg.batch_size, seed=3)
    r1 = torch.rand((2, 3), generator=torch.Generator().manual_seed(4))
    for head_bf16 in (False, True):
        res = train_step_card_vs_cpu(cfg, model.state_dict(), batch, r1, head_bf16)
        res.pop("cpu_forward")
        print(f"[dual-vs-cpu] train step, head {'bf16' if head_bf16 else 'fp32'}: "
              + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in res.items()))
    launches = {"dual serve": _dual_serving(card_name, smi)}
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as log_dir:
        launches["dual train"] = _dual_training(log_dir, smi)
    launches.update({f"dual {k}": v for k, v in phase_cli(smi, DUAL, "dual-cli").items()})
    _sppnet_checks(smi)
    _library_modules()
    return launches


# ------------------------------------------------ phase 22: geometry, meanshift

def _events(n: int) -> list:
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def _meanshift_serving(smi: str) -> int:
    """``Predictor(cluster_mode="meanshift")`` at the default ``Config``
    (N=7000, 64-d embedding, bandwidth 0.85), pushed weights: ``predict`` on
    3 clouds after a warm-up, with the launch counts and the mean shift's
    host reads set to 0 just before and read just after; then the forward
    and the mean shift timed apart (CUDA events) on the same clouds, and a
    trace of one ``predict`` through ``utils/profiling.trace``."""
    cfg = Config()
    n, reps = cfg.num_points, 3
    pred = Predictor(cfg, device="cuda", cluster_mode="meanshift")
    push_weights(pred.model)
    xyz, nrm = synth_clouds(cfg, reps + 1, seed=22)
    pred.predict(xyz[reps], nrm[reps])                       # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    affinity.mean_shift.host_syncs = 0
    torch.cuda.reset_peak_memory_stats()
    results, iters = [], []
    t0 = time.perf_counter()
    for i in range(reps):
        results.append(pred.predict(xyz[i], nrm[i]))
        iters.append(affinity.mean_shift.iterations)
    t_cloud = (time.perf_counter() - t0) / reps
    launches = _launches()["masked_min_sweep"]
    syncs = affinity.mean_shift.host_syncs
    peak = torch.cuda.max_memory_allocated()
    check(launches > 0, "masked_min_sweep was not launched on the meanshift serving path")
    centres = []
    for r in results:
        labels = r["instance_labels"]
        check(r["type_per_point"].shape == (n, 7) and r["param_per_point"].shape == (n, 22)
              and r["pt_offsets"].shape == (n, 3) and r["embedding"].shape == (n, cfg.out_dim)
              and labels.shape == (n,) and labels.dtype == np.int64,
              "meanshift output shapes")
        check(all(np.isfinite(r[k]).all() for k in
                  ("type_per_point", "param_per_point", "pt_offsets", "embedding")),
              "meanshift outputs not finite")
        again = affinity.mean_shift(torch.as_tensor(r["embedding"], device="cuda")[None],
                                    cfg.bandwidth)[0].cpu().numpy()
        check(np.array_equal(again, labels), "meanshift labels are not the mean shift of "
                                             "the returned embedding")
        centres.append(int(labels.max()) + 1)
        check(np.array_equal(np.unique(labels), np.arange(centres[-1])), "labels not 0..K-1")

    fwd, shift = [], []
    with torch.inference_mode():
        for i in range(reps):
            xt, nt = (torch.as_tensor(a[i][None], device="cuda") for a in (xyz, nrm))
            e = _events(3)
            e[0].record()
            out = pred.model(xt, nt)
            e[1].record()
            affinity.mean_shift(out.embedding, cfg.bandwidth)
            e[2].record()
            e[2].synchronize()
            fwd.append(e[0].elapsed_time(e[1]))
            shift.append(e[1].elapsed_time(e[2]))
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as trace_dir:
        t0 = time.perf_counter()
        with profiling.trace(trace_dir) as prof:
            pred.predict(xyz[0], nrm[0])
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    check(len(traces) == 1, f"profiling.trace wrote {traces}")
    _print_profile(f"meanshift predict(N={n}) via utils/profiling.trace", prof, wall_us)
    print(f"[geometry] meanshift serving N={n} F={cfg.out_dim} bandwidth {cfg.bandwidth}: "
          f"predict {t_cloud * 1e3:.1f} ms/cloud (host clock, {reps} clouds); forward "
          f"{[round(v, 2) for v in fwd]} ms, mean shift {[round(v, 2) for v in shift]} ms "
          f"(CUDA events); mean-shift iterations {iters} (largest {max(iters)}), host syncs "
          f"{syncs / reps:.1f} per cloud; centres {centres}; peak memory "
          f"{peak / 2**30:.2f} GiB; masked_min_sweep {launches} launches, "
          f"{launches / reps:.1f} sweeps per cloud ({smi})")
    return launches


def _meanshift_card_vs_cpu() -> None:
    """The mean shift on the card against its CPU run, labels exactly:
    constructed blobs at N=7000, F=64, and the card's own embedding of a
    pushed N=2048 cloud."""
    rng = np.random.RandomState(22)
    sizes = [1200, 1000, 900, 800, 700, 600, 500, 400, 300, 250, 150, 100, 60, 40]
    centres = rng.randn(len(sizes), 64) * 2.0
    x = np.concatenate([c + 0.3 / 8 * rng.randn(m, 64) for c, m in zip(centres, sizes)])
    x = torch.as_tensor(x[rng.permutation(len(x))].astype(np.float32))[None]
    e = _events(2)
    e[0].record()
    card = affinity.mean_shift(x.cuda(), 0.85)
    e[1].record()
    e[1].synchronize()
    card_iters = affinity.mean_shift.iterations
    t0 = time.perf_counter()
    cpu = affinity.mean_shift(x, 0.85)
    cpu_s = time.perf_counter() - t0
    check(torch.equal(card.cpu(), cpu), f"mean shift of the N={x.shape[1]} blobs: card != CPU")
    check(len(torch.unique(cpu)) == len(sizes), f"blobs: {len(torch.unique(cpu))} clusters")
    print(f"[geometry] mean shift N={x.shape[1]} F=64, {len(sizes)} blobs: card labels equal the "
          f"CPU's ({len(sizes)} clusters, {card_iters} iterations); card "
          f"{e[0].elapsed_time(e[1]):.1f} ms, CPU {cpu_s * 1e3:.0f} ms")

    cfg = Config(num_points=2048)
    pred = Predictor(cfg, device="cuda", cluster_mode="meanshift")
    push_weights(pred.model)
    xyz, nrm = synth_clouds(cfg, 1, seed=23)
    emb = torch.as_tensor(pred.predict(xyz[0], nrm[0])["embedding"])[None]
    card = affinity.mean_shift(emb.cuda(), cfg.bandwidth)[0].cpu().numpy()
    cpu = affinity.mean_shift(emb, cfg.bandwidth)[0].numpy()
    check(np.array_equal(card, cpu), f"mean shift of the card's N={cfg.num_points} embedding: "
                                     f"labels differ on {np.mean(card != cpu):.4%} of points")
    print(f"[geometry] mean shift of the card's N={cfg.num_points} embedding: {cpu.max() + 1} "
          f"clusters, labels equal on card and CPU")


def _affinities(smi: str) -> None:
    """``construction_affinity_matrix_type`` and ``_normal`` (knn 50) from the
    full-width predictor's outputs (N=7000, B=1): ms (``utils/timing.
    time_fn``) and peak memory; then card against CPU at N=2048 on the
    card's outputs, the kNN selections replayed."""
    for n in (7000, 2048):
        cfg = Config(num_points=n)
        model = PrimitiveNet(cfg)
        push_weights(model)
        model.cuda().eval()
        xyz, nrm = (torch.as_tensor(a, device="cuda") for a in synth_clouds(cfg, 1, seed=24))
        with torch.inference_mode():
            out = model(xyz, nrm)
        args = {"type": (xyz, out.type_per_point, out.param_per_point), "normal": (xyz, nrm)}
        fns = {"type": affinity.construction_affinity_matrix_type,
               "normal": functools.partial(affinity.construction_affinity_matrix_normal, knn=50)}
        if n == 7000:
            for name, fn in fns.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                a = fn(*args[name])
                check(a.shape == (1, n, n) and bool(torch.isfinite(a).all()),
                      f"{name} affinity shape or values")
                peak = torch.cuda.max_memory_allocated() - base
                del a
                ms = timing.time_fn(fn, *args[name], iters=3, warmup=1) * 1e3
                print(f"[geometry] construction_affinity_matrix_{name} N={n}: {ms:.2f} ms "
                      f"(utils/timing.time_fn, CUDA events), {peak / 2**30:.2f} GiB above its "
                      f"inputs ({smi})")
            continue
        for name, fn in fns.items():
            with TopkReplay() as replay:
                card = fn(*args[name]).cpu()
                replay.replaying = True
                cpu = fn(*(t.cpu() for t in args[name]))
            err = float((card - cpu).abs().max())
            check(torch.allclose(card, cpu, **AFFINITY), f"{name} affinity card vs CPU: {err:.3g}")
            print(f"[geometry] construction_affinity_matrix_{name} N={n} card vs CPU: max abs "
                  f"diff {err:.3g} within {AFFINITY}; top-k rows the CPU picks otherwise "
                  f"(replayed): {replay.differing}")


def _simple_clusters_scene(card_name: str, smi: str) -> dict:
    """``simple_clusters`` on a synthetic N=8192 scene with the scannetv2
    recipe's radius, ``npoint_thr`` and ``class_numpoint_mean`` (N/5): the
    launch counts set to 0 just before and read just after; labels and keep
    card against CPU exactly, on coordinates on a 2**-10 grid (their squared
    distances are exact in float32, so no pair sits on the radius on one
    device only); ms (``utils/timing.time_fn``); the sweep timed on its mask."""
    cfg = scene_config(8192)
    g, n = cfg.grouping, cfg.num_points
    batch = synth_scene_batch(cfg, 1, seed=25)
    xyz = torch.as_tensor(np.round(batch["xyz"][0] * 1024) / 1024, dtype=torch.float32)
    sem = torch.as_tensor(batch["semantic"][0])
    args = (g.radius, g.npoint_thr, g.class_numpoint_mean)
    xt, st = xyz.cuda(), sem.cuda()
    torch.cuda.synchronize()
    _reset_launches()
    labels, keep = grouping_ops.simple_clusters(xt, st, *args)
    torch.cuda.synchronize()
    launches = _launches()["masked_min_sweep"]
    check(launches > 0, "masked_min_sweep was not launched by simple_clusters")
    cpu = grouping_ops.simple_clusters(xyz, sem, *args)
    check(torch.equal(labels.cpu(), cpu[0]) and torch.equal(keep.cpu(), cpu[1]),
          "simple_clusters: card != CPU")
    kept = len(torch.unique(cpu[0][cpu[1]]))
    check(kept > 0, "simple_clusters kept no cluster")
    ms = timing.time_fn(grouping_ops.simple_clusters, xt, st, *args, iters=5, warmup=1) * 1e3

    nbr = grouping_ops.radius_neighbor_mask(xt, g.radius) & (st[:, None] == st[None, :])
    lab0 = torch.arange(n, dtype=torch.int32, device="cuda")
    check(torch.equal(cc.masked_min_sweep(nbr, lab0), cc.masked_min_sweep_plain(nbr, lab0)),
          "sweep on the simple_clusters mask")
    sweep_ms = time_graph(lambda: cc.masked_min_sweep(nbr, lab0), 100)
    plain_ms = time_graph(lambda: cc.masked_min_sweep_plain(nbr, lab0), 10)
    bound_ms = (n * n + 8 * n) / hbm_rate(card_name) * 1e3
    print(f"[geometry] simple_clusters N={n} radius {g.radius} npoint_thr {g.npoint_thr} "
          f"mean {g.class_numpoint_mean[0]}: {kept} clusters kept ({int(cpu[1].sum())} points); "
          f"labels and keep card = CPU; {ms:.2f} ms (utils/timing.time_fn); masked_min_sweep "
          f"{launches} launches = sweeps ({smi})")
    print(f"[kernel] masked_min_sweep on the N={n} simple_clusters mask ({int(nbr.sum())} "
          f"edges): {sweep_ms * 1e3:.2f} us/sweep, plain {plain_ms * 1e3:.2f} us, bound "
          f"{bound_ms * 1e3:.2f} us, {bound_ms / sweep_ms:.1%} of the bound ({smi})")
    return {"launches": launches, "n": n, "ms": sweep_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms}


def _hold_geometry(label: str, card, cpu, up_to_sign: bool = False) -> float:
    """Card against CPU within ``GEOMETRY_RTOL`` of the largest entry (and
    relative); an eigenvector-derived output up to its sign.  -> max error."""
    card = torch.as_tensor(card).detach().cpu().double()
    cpu = torch.as_tensor(cpu).detach().cpu().double()
    if up_to_sign:
        card = card * torch.sign(torch.sum(card * cpu))
    err = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    check(torch.allclose(card, cpu, rtol=GEOMETRY_RTOL, atol=GEOMETRY_RTOL * scale),
          f"{label}: card vs CPU differ by {err:.3g} (largest entry {scale:.3g})")
    return err


def _geometry_card_vs_cpu() -> None:
    """The fits, spline sampling, footpoints, refit, PCA standardisation,
    ``arap_deform`` and the open spline refinement, card against CPU at the
    CPU tests' sizes (tests/test_torch_geometry.py)."""
    rng = np.random.RandomState(26)
    pts = (rng.randn(120, 3) * [1.0, 0.6, 0.2]).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (120, 1)).astype(np.float32)
    theta, h = rng.uniform(0, 2 * np.pi, 300), rng.uniform(-1, 1, 300)
    cyl = np.stack([0.4 * np.cos(theta), 0.4 * np.sin(theta), h], 1) + 0.01 * rng.randn(300, 3)
    cyl_n = np.stack([np.cos(theta), np.sin(theta), 0.02 * rng.randn(300)], 1)
    t = rng.uniform(0.2, 1.0, 300)
    # the apex off the origin: its coordinates are held relative to their size
    cone = np.stack([t * np.tan(0.5) * np.cos(theta), t * np.tan(0.5) * np.sin(theta), t], 1) \
        + [0.3, -0.2, 0.5]
    cone_n = np.stack([np.cos(0.5) * np.cos(theta), np.cos(0.5) * np.sin(theta),
                       np.full(300, -np.sin(0.5))], 1)
    w3 = rng.uniform(0.5, 1.0, (300, 1))
    inputs = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in dict(
        pts=pts, w=w, cyl=cyl, cyl_n=cyl_n / np.linalg.norm(cyl_n, axis=1, keepdims=True),
        cone=cone, cone_n=cone_n, w3=w3).items()}
    errs = {}

    def run(dev):
        x = {k: v.to(dev) for k, v in inputs.items()}
        return {"plane": fitting.fit_plane(x["pts"], x["w"]),
                "sphere": fitting.fit_sphere(x["pts"], x["w"]),
                "cylinder": fitting.fit_cylinder(x["cyl"], x["cyl_n"], x["w3"]),
                "cone": fitting.fit_cone(x["cone"], x["cone_n"], x["w3"])}

    card, cpu = run("cuda"), run("cpu")
    sign = float(torch.sign(torch.sum(card["plane"][0].cpu() * cpu["plane"][0])))
    errs["fit_plane"] = max(_hold_geometry("fit_plane normal", card["plane"][0], cpu["plane"][0],
                                           True),
                            _hold_geometry("fit_plane offset", sign * card["plane"][1],
                                           cpu["plane"][1]))
    errs["fit_sphere"] = max(_hold_geometry(f"fit_sphere {i}", a, b)
                             for i, (a, b) in enumerate(zip(card["sphere"], cpu["sphere"])))
    errs["fit_cylinder"] = max(
        _hold_geometry("fit_cylinder axis", card["cylinder"][0], cpu["cylinder"][0], True),
        *(_hold_geometry(f"fit_cylinder {i}", a, b)
          for i, (a, b) in enumerate(zip(card["cylinder"][1:], cpu["cylinder"][1:]))))
    errs["fit_cone"] = max(_hold_geometry(f"fit_cone {i}", a, b)
                           for i, (a, b) in enumerate(zip(card["cone"], cpu["cone"])))

    # the guarded eigh's backward: a loss that does not see the normal's sign
    def plane_grad(dev):
        p = inputs["pts"].to(dev).requires_grad_()
        a, d = fitting.fit_plane(p, inputs["w"].to(dev))
        (torch.sum(a.T @ a * torch.arange(9.0, device=dev).reshape(3, 3)) + d * d).backward()
        return p.grad

    errs["fit_plane gradient"] = _hold_geometry("fit_plane gradient", plane_grad("cuda"),
                                                plane_grad("cpu"))

    nu, nv = spline.uniform_knot_bspline(10, 10, 3, 3, 30)
    u, v = np.meshgrid(np.linspace(0, 1, 10), np.linspace(0, 1, 10), indexing="ij")
    cp = torch.as_tensor(np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)], -1)
                         .reshape(1, 100, 3), dtype=torch.float32)
    surf = spline.sample_points_from_control_points(nu, nv, cp)
    errs["sample_points"] = _hold_geometry(
        "sample_points_from_control_points",
        spline.sample_points_from_control_points(nu, nv, cp.cuda()), surf)
    noisy = surf[0] + 0.001 * torch.as_tensor(rng.randn(900, 3), dtype=torch.float32)
    # the footpoints are grid indices over (grid - 1): a CUDA division by a
    # scalar multiplies by its reciprocal, one rounding off the CPU's, and
    # the refit truncates u * (grid - 1) to an index, so the CPU refits at
    # the card's footpoints
    uv_card = spline.footpoint_uv(noisy.cuda(), surf[0].cuda(), 30)
    uv_cpu = spline.footpoint_uv(noisy, surf[0], 30)
    check(torch.allclose(uv_card.cpu(), uv_cpu, rtol=1e-6, atol=0), "footpoint_uv: card != CPU")
    errs["refit_control_points"] = _hold_geometry(
        "refit_control_points", spline.refit_control_points(noisy.cuda(), uv_card, nu, nv),
        spline.refit_control_points(noisy, uv_card.cpu(), nu, nv))
    cloud = torch.as_tensor(rng.randn(2, 80, 3) * [2.0, 1.0, 0.3], dtype=torch.float32)
    std_card = spline.standardize_points(cloud.cuda())
    std_cpu = spline.standardize_points(cloud)
    axis_sign = torch.sign(torch.sum(std_card[3].cpu() * std_cpu[3], -1))        # [B, 3]
    errs["standardize_points"] = max(
        _hold_geometry("standardize_points aligned", std_card[0].cpu() * axis_sign[:, None, :],
                       std_cpu[0]),
        _hold_geometry("standardize_points rot", std_card[3].cpu() * axis_sign[:, :, None],
                       std_cpu[3]),
        *(_hold_geometry(f"standardize_points {i}", std_card[i], std_cpu[i]) for i in (1, 2)))
    g = 10
    u, v = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g), indexing="ij")
    grid = torch.as_tensor(np.stack([u.ravel(), v.ravel(), np.zeros(g * g)], 1))
    targets = grid + torch.as_tensor([0.05, 0.05, 0.1]) + 0.02 * torch.as_tensor(
        rng.randn(g * g, 3))
    errs["arap_deform"] = _hold_geometry(
        "arap_deform", spline.arap_deform(grid.cuda(), targets.cuda(), g, g, iters=8, w_fit=0.5),
        spline.arap_deform(grid, targets, g, g, iters=8, w_fit=0.5))
    reg40 = spline.regular_parameterization(40, 40)
    cp_true = np.stack([u, v, 0.3 * np.sin(2 * u) * np.cos(2 * v)], -1).reshape(100, 3)
    dense = spline.surface_basis_at(reg40, 10, 10, 2, 2) @ cp_true + 0.005 * rng.randn(1600, 3)
    cp_pred = spline.fit_surface_kronecker(torch.as_tensor(dense),
                                           torch.as_tensor(spline.surface_basis_at(
                                               reg40, 20, 20, 3, 3)), reg=1e-4).numpy()
    kw = dict(closed=False, new_cp_size=10, new_degree=2, n_params=1600, out_grid=20)
    card_opt = spline.optimize_spline_kronecker(dense, cp_pred, device="cuda", **kw)
    cpu_opt = spline.optimize_spline_kronecker(dense, cp_pred, device="cpu", **kw)
    errs["optimize_spline_kronecker"] = max(_hold_geometry(f"optimize_spline_kronecker {i}", a, b)
                                            for i, (a, b) in enumerate(zip(card_opt, cpu_opt)))
    print("[geometry] card vs CPU (TF32 off), max abs differences, held at "
          f"{GEOMETRY_RTOL} relative and of the largest entry; footpoints within a rounding: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))


def phase_geometry(card_name: str, smi: str) -> tuple[dict, dict]:
    """Phase 22: meanshift serving at full width (torch's default TF32
    settings), then with TF32 off the mean shift, the affinities, the fits
    and the spline functions card against CPU, and ``simple_clusters`` at
    scene size.  Returns the CC kernel's launches on the meanshift serving
    and ``simple_clusters`` runs, and the sweep's times on the latter's
    mask."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    launches = {"meanshift serve": _meanshift_serving(smi)}
    torch.backends.cudnn.allow_tf32 = False
    _meanshift_card_vs_cpu()
    _affinities(smi)
    mask = _simple_clusters_scene(card_name, smi)
    launches["simple_clusters"] = mask.pop("launches")
    _geometry_card_vs_cpu()
    return launches, mask


# ------------------------------------------------------- phase 23: data parallelism

# two ranks of one gloo group share the one card (NCCL refuses two ranks on
# one card); their times are not a scaling figure
DP_WORLD = 2


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _digest(model: torch.nn.Module) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_step(model, batch, r1) -> tuple:
    """One data-parallel ``train_step`` from a fresh Adam: the group's
    metrics and gradient, the new state, the CC launches (all on the CPU)."""
    opt = step_lib.make_optimizer(model.cfg, model.parameters())
    before = cc.masked_min_sweep.launches
    metrics = step_lib.train_step(model, opt, batch, r1=r1)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    return ({k: v.detach().cpu() for k, v in metrics.items()}, grads,
            {k: v.detach().cpu() for k, v in model.state_dict().items()},
            cc.masked_min_sweep.launches - before)


def dp_step_card_vs_cpu(rank: int, world: int, cfg: Config, state: dict, batch: dict,
                        r1: torch.Tensor) -> dict:
    """This rank's part of one data-parallel train step (instance head in
    fp32) on the card and then on the CPU, from the same weights, global
    batch and grid shift, the card's top-k and proposals replayed on the
    CPU: the group's losses (``TRAIN_LOSS``), gradient (``TRAIN_GRAD_RTOL``,
    the instance gradient's atol share, as the gradient holds it), batch
    statistics (``TRAIN_STATS``) and new weights (within 2 lr of each other:
    Adam's first step moves a weight by about lr).  Raises on any out of
    tolerance; returns the worst errors."""
    from gcanet_tpu_torch.parallel.dist import local_shard

    models, batches = {}, {}
    for dev in ("cuda", "cpu"):
        models[dev] = PrimitiveNet(cfg).to(dev)
        models[dev].load_state_dict(state)
        models[dev].instance_head.compute_bf16 = False
        batches[dev] = step_lib.batch_to_device(local_shard(batch, rank, world), dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with TopkReplay() as topk, CallReplay() as props:
            card = _dp_step(models["cuda"], batches["cuda"], r1.cuda())
            topk.replaying = props.replaying = True
            cpu = _dp_step(models["cpu"], batches["cpu"], r1.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    res = {"launches": card[3], "cpu_proposals_equal": props.own_equal,
           "topk_rows_differing": topk.differing, "num_pos": float(cpu[0]["num_pos"])}
    check(res["num_pos"] > 0, "the data-parallel step's instance path did no work")
    worst = 0.0
    for k, w in cpu[0].items():
        g = card[0][k]
        check(bool(torch.isfinite(g)) and torch.allclose(g, w, **TRAIN_LOSS),
              f"data-parallel {k}: card {float(g)} CPU {float(w)}")
        worst = max(worst, float((g - w).abs()) / max(abs(float(w)), 1e-12))
    res["loss_max_rel_err"] = worst
    res["grad_atol_share_needed"], res["grad_max_rel_l2"] = _hold_gradients(
        f"dp-vs-cpu rank {rank}", "group", cpu[1], card[1], TRAIN_GRAD_ATOL_SHARE["inst"])
    stat_err = weight_err = 0.0
    for k, w in cpu[2].items():
        g = card[2][k]
        if "running" in k:
            check(torch.allclose(g, w, **TRAIN_STATS), f"data-parallel statistic {k}")
            stat_err = max(stat_err, float((g - w).abs().max()))
        elif g.is_floating_point():
            weight_err = max(weight_err, float((g - w).abs().max()))
    check(weight_err <= 2 * cfg.learning_rate + 1e-6, f"new weights {weight_err} apart")
    res["stats_max_abs_err"], res["weights_max_abs_err"] = stat_err, weight_err
    res["digest"] = _digest(models["cuda"])
    return res


@contextlib.contextmanager
def _first_cc_mask(store: list):
    """While open, the first adjacency ``connected_components`` gets is
    copied into ``store``."""
    real = grouping_ops.connected_components

    def spy(nbr, max_iters=64):
        if not store:
            store.append(nbr.clone())
        return real(nbr, max_iters)

    grouping_ops.connected_components = spy
    try:
        yield store
    finally:
        grouping_ops.connected_components = real


def _timed_epoch(trainer, module, name: str, warm: int, steps: int) -> dict:
    """A warm-up epoch of ``warm`` steps, then an epoch of ``warm + steps``
    whose last ``steps`` are timed (CUDA events), the launch counts and
    peak memory counted from 0 just before."""
    trainer.train_one_epoch(0, num_batches=warm)
    torch.cuda.synchronize()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with step_events(module, name) as marks:
        history = trainer.train_one_epoch(1, num_batches=warm + steps)
    return {"ms": marks[warm][0].elapsed_time(marks[-1][1]) / steps,
            "per_step_launches": [k for _, _, k, _, _ in marks],
            "launches": _launches()["masked_min_sweep"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "losses": [{k: float(v) for k, v in m.items()} for m in history]}


def dp_training(rank: int, world: int, log_dir: str, card_name: str) -> dict:
    """Flagship training at the default ``Config`` on this rank (global
    B=4): a timed epoch, the rank-strided evaluation of the 8 eval clouds
    (merged; rank 0 keeps the checkpoint it evaluated), and the sweep timed
    on a mask of one more data-parallel step (rank 0, the other rank
    waiting)."""
    import torch.distributed as dist

    cfg = Config(log_dir=log_dir, data_path=log_dir, batch_size=2 * DP_WORLD,
                 mesh_shape=str(DP_WORLD))
    trainer = Trainer(cfg, device="cuda:0")
    try:
        push_weights(trainer.model)
        out = _timed_epoch(trainer, step_lib, "train_step", 2, 5)
        t0 = time.perf_counter()
        trainer.test_one_epoch(1)
        out["eval_s"] = time.perf_counter() - t0
        out["checkpoint"] = trainer.save_checkpoint(2, tag="dp")     # every rank; 0 writes
        if rank == 0:
            out["record"] = _scene_records(log_dir)[-1]
        with _first_cc_mask([]) as masks:
            trainer.train_one_epoch(2, num_batches=1)
        out["digest"] = _digest(trainer.model)
    finally:
        trainer.close()
    dist.barrier()
    if rank == 0:
        nbr = masks[0]
        n = nbr.shape[0]
        labels = torch.randperm(n, generator=torch.Generator().manual_seed(0)).to(
            torch.int32).cuda()
        err = int((cc.masked_min_sweep(nbr, labels).long()
                   - cc.masked_min_sweep_plain(nbr, labels).long()).abs().max())
        out["mask"] = {"n": n, "max_abs_err": err, "edges": int(nbr.sum()),
                       "ms": time_graph(lambda: cc.masked_min_sweep(nbr, labels), 100),
                       "plain_ms": time_graph(lambda: cc.masked_min_sweep_plain(nbr, labels),
                                              10),
                       "bound_ms": (n * n + 8 * n) / hbm_rate(card_name) * 1e3}
    dist.barrier()
    return out


def dp_scene_training(rank: int, world: int, log_dir: str) -> dict:
    """Scene training at full width on this rank (N=8192, global B=8, grid
    64): a timed epoch of 3 steps after 2."""
    cfg = scene_train_config(log_dir).replace(mesh_shape=str(DP_WORLD))
    trainer = SceneTrainer(cfg, device="cuda:0")
    try:
        push_scene_weights(trainer.model)
        out = _timed_epoch(trainer, scene_step, "scene_train_step", 2, 3)
        out["digest"] = _digest(trainer.model)
    finally:
        trainer.close()
    return out


def dp_bench(rank: int, world: int) -> dict:
    """``GCA_BENCH_MESH=2`` at the bench's full width (B=10 global, N=8192,
    5 timed steps): the line (rank 0 prints it), CC launches, peak memory."""
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    with bench_env(GCA_BENCH_MESH=str(DP_WORLD), GCA_BENCH_ITERS="5"), \
            contextlib.redirect_stdout(out):
        row = bench.main([], device="cuda:0")
    return {"row": row, "printed": out.getvalue().splitlines(),
            "launches": _launches()["masked_min_sweep"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


DP_JOBS = {f.__name__: f for f in (dp_step_card_vs_cpu, dp_training, dp_scene_training,
                                    dp_bench)}


def dp_rank(rank: int, world: int, port: int, jobs_path: str, queue) -> None:
    """One rank of a gloo group on the card (started with ``spawn``): the
    jobs saved at ``jobs_path`` (``[(key, job, kwargs)]``) in order;
    ``(rank, {key: result})`` on ``queue``, or ``(rank, traceback)``."""
    import traceback

    import torch.distributed as dist

    from gcanet_tpu_torch.parallel.dist import init_dist

    try:
        init_dist(f"127.0.0.1:{port}", world, rank, backend="gloo")
        out = {}
        for key, name, kw in torch.load(jobs_path, weights_only=False):
            t0 = time.perf_counter()
            out[key] = DP_JOBS[name](rank, world, **kw)
            out[key + ":s"] = time.perf_counter() - t0
        queue.put((rank, out))
    except BaseException:               # noqa: BLE001 -- the parent raises it
        queue.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(jobs: list, root: str, timeout: float = 600.0) -> list[dict]:
    """``jobs`` on ``DP_WORLD`` spawned ranks; their results in rank order.
    A rank that fails, or does not answer in ``timeout`` seconds, fails the
    run; every rank is ended before this returns."""
    import multiprocessing
    import queue as queue_mod

    path = os.path.join(root, "dp_jobs.pt")
    torch.save(jobs, path)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=dp_rank, args=(r, DP_WORLD, port, path, results))
             for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.perf_counter() + timeout
        while len(got) < DP_WORLD:
            try:
                rank, res = results.get(timeout=max(1.0, deadline - time.perf_counter()))
            except queue_mod.Empty:
                raise RuntimeError(f"ranks {sorted(set(range(DP_WORLD)) - set(got))} did "
                                   f"not answer in {timeout:.0f} s") from None
            check(isinstance(res, dict), f"rank {rank} failed:\n{res}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    return [got[r] for r in range(DP_WORLD)]


def _dp_serving(smi: str) -> dict:
    """``Predictor`` (default ``Config``, B=4) and ``ScenePredictor``
    (N=8192, B=8, grid 64) on ``["cuda:0", "cuda:0"]``, the launch counts
    from 0 just before each data-parallel call, against one device's
    ``predict_batch`` on the same weights: on the chunks' own shapes (the
    batch's proposals checked to stay under the cap, so the chunks group as
    the whole batch would), held as phase 5 and 13 hold a stream against
    its batches; on the whole batch the first differing key is printed
    (another batch shape takes other cuBLAS kernels, whose last bits may
    move a hard threshold; the CPU tests hold that case exactly)."""
    out = {}
    devices = ["cuda:0"] * DP_WORLD
    for family, b in (("abc", 4), ("scene", 8)):
        if family == "abc":
            cfg = Config(batch_size=b)
            one = Predictor(cfg)
            push_weights(one.model)
            two = Predictor(cfg.replace(mesh_shape=str(DP_WORLD)), one.model.state_dict(),
                            device=devices)
            xyz, aux = synth_clouds(cfg, b, seed=7)
        else:
            cfg = scene_config(8192).replace(batch_size=b)
            one = ScenePredictor(cfg)
            push_scene_weights(one.model)
            two = ScenePredictor(cfg.replace(mesh_shape=str(DP_WORLD)), one.model.state_dict(),
                                 device=devices)
            raw = synth_scene_batch(cfg, b, seed=7)
            xyz, aux = raw["xyz"], raw["feats"]
        with torch.inference_mode():
            num = int(one.model(torch.as_tensor(xyz, device="cuda"),
                                torch.as_tensor(aux, device="cuda")).proposals.num)
        check(num < cfg.instance_head.max_proposals, f"the {family} batch's {num} proposals "
              f"reach the cap {cfg.instance_head.max_proposals}")
        k = b // DP_WORLD
        want = [r for i in range(DP_WORLD)
                for r in one.predict_batch(xyz[i * k:(i + 1) * k], aux[i * k:(i + 1) * k])]
        whole = one.predict_batch(xyz, aux)
        two.predict_batch(xyz, aux)                     # warm-up
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        got = two.predict_batch(xyz, aux)
        wall = time.perf_counter() - t0
        launches = _launches()["masked_min_sweep"]
        check(launches > 0, f"data-parallel {family} serving launched no CC sweep")
        if family == "abc":
            check(same_dicts(got, want), "data-parallel predict_batch differs from one device's")
            verdict = "equal (integers exact, floats 1e-3)"
        else:
            verdict = _scene_stream_check(got, [want])
        kept = sum(len(r["instances"]) for r in got)
        check(kept > 0, f"data-parallel {family} serving kept no instance")
        differ = {i: dict_difference(g, w) for i, (g, w) in enumerate(zip(got, whole))}
        print(f"[dp-serve] {family}: B={b} over {devices} ({num} proposals, cap "
              f"{cfg.instance_head.max_proposals}): {b / wall:.2f} items/s (host clock, both "
              f"chunks on one card), {launches} CC launches, {kept} instances; against one "
              f"device's predict_batch on the chunks' shapes: {verdict}; on the whole batch, "
              f"items differing (first key): {({i: d for i, d in differ.items() if d})} ({smi})")
        out[f"dp {family} serve"] = launches
    return out


def phase_data_parallel(card_name: str, smi: str) -> tuple[dict, dict]:
    """Phase 23: the data-parallel paths on the card: two ranks of a gloo
    group share ``cuda:0`` (the four-card machine is not this run's), so
    every time here is two ranks on one card, not a scaling figure.  The
    ranks take a step card against CPU (N=2048, global B=4), flagship
    training through ``Trainer`` (default ``Config``, global B=4) with its
    rank-strided evaluation merged, scene training (N=8192, global B=8,
    grid 64) and a ``GCA_BENCH_MESH=2`` bench line; the merged evaluation
    is held against one process's on the checkpoint it evaluated, the
    ranks' weights bit for bit against each other, the sweep against its
    plain version on a data-parallel step's mask; then both predictors
    serve over ``["cuda:0", "cuda:0"]``.  Returns the CC launches by path
    and the mask's sweep times."""
    print("[dp] two gloo ranks share one card: the times below are not a scaling figure")
    cfg = Config(num_points=2048, batch_size=2 * DP_WORLD, mesh_shape=str(DP_WORLD),
                 grouping=GroupingConfig(class_numpoint_mean=(-1.0,) * 7,
                                         similarity_threshold_inst=0.9),
                 instance_head=InstanceHeadConfig(max_proposals=24))
    model = PrimitiveNet(cfg)
    push_weights(model)
    r1 = torch.rand((2, 3), generator=torch.Generator().manual_seed(4))
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as root:
        jobs = [("step", "dp_step_card_vs_cpu",
                 dict(cfg=cfg, state=model.state_dict(),
                      batch={k: v for k, v in synth_batch(cfg, cfg.batch_size, seed=3).items()
                             if k != "index"}, r1=r1)),
                ("train", "dp_training", dict(log_dir=os.path.join(root, "train"),
                                              card_name=card_name)),
                ("scene", "dp_scene_training", dict(log_dir=os.path.join(root, "scene"))),
                ("bench", "dp_bench", {})]
        ranks = run_ranks(jobs, root)
        step = [r["step"] for r in ranks]
        print(f"[dp-vs-cpu] N={cfg.num_points} global B={cfg.batch_size}, head fp32, per rank: "
              + "; ".join(", ".join(f"{k} {v:.3g}" if isinstance(v, float) else f"{k} {v}"
                                    for k, v in r.items() if k != "digest") for r in step))
        check(step[0]["digest"] == step[1]["digest"], "the ranks' weights differ after the step")
        train = [r["train"] for r in ranks]
        scene = [r["scene"] for r in ranks]
        for label, runs, per in (("train", train, 2), ("scene-train", scene, 4)):
            for rank, r in enumerate(runs):
                steps = len(r["per_step_launches"])
                print(f"[dp-{label}] rank {rank}: {r['ms']:.1f} ms/step ({per} items per rank, "
                      f"{per * DP_WORLD} per step), peak memory {r['peak_gib']:.2f} GiB, "
                      f"CC launches per rank-step {r['per_step_launches']} ({r['launches']} in "
                      f"{steps} steps), {r['digest'][:12]} ({smi})")
                for i, m in enumerate(r["losses"]):
                    check(all(np.isfinite(v) for v in m.values()),
                          f"dp {label} rank {rank} step {i}: {m}")
                check(r["launches"] > 0, f"dp {label} rank {rank} launched no CC sweep")
            print(f"[dp-{label}] last step's losses (the group's means, equal on both ranks): "
                  + ", ".join(f"{k} {v:.4g}" for k, v in runs[0]["losses"][-1].items()))
            check(runs[0]["losses"] == runs[1]["losses"], f"dp {label}: the ranks' losses differ")
            check(runs[0]["digest"] == runs[1]["digest"], f"dp {label}: the ranks' weights differ")

        # the merged rank-strided evaluation against one process's
        record = train[0]["record"]
        one_dir = os.path.join(root, "one")
        single = Trainer(Config(log_dir=one_dir, data_path=one_dir))
        try:
            single.model.load_state_dict(torch.load(train[0]["checkpoint"], map_location="cuda",
                                                    weights_only=True)["model_state_dict"])
            single.test_one_epoch(1)
        finally:
            single.close()
        want = _scene_records(one_dir)[-1]
        check(set(record) == set(want), f"merged eval keys {sorted(record)}")
        for k, w in want.items():
            if k in ("step", "time"):
                continue
            tol = dict(rtol=EVAL_REPEAT_LOSS_RTOL, atol=1e-7) if "loss" in k or k == "num_pos" \
                else dict(rtol=1e-9, atol=1e-12)
            check(np.isclose(record[k], w, **tol), f"merged eval {k}: {record[k]} vs {w}")
        print(f"[dp-eval] 8 clouds, 4 per rank, merged: equal to one process's on the same "
              f"checkpoint (losses rtol {EVAL_REPEAT_LOSS_RTOL}, metrics 1e-9): miou "
              f"{record['miou']:.4f} type_miou {record['type_miou']:.4f}; "
              f"{train[0]['eval_s'] / 4 * 1e3:.1f} ms per cloud per rank (host clock)")

        bench_rows = [r["bench"] for r in ranks]
        check(bench_rows[0]["printed"] == [json.dumps(bench_rows[0]["row"])]
              and bench_rows[1]["printed"] == [], "the dp bench's rank 0 prints one line")
        row = bench_rows[0]["row"]
        check(row["devices"] == DP_WORLD and row["value"] > 0, f"dp bench {row}")
        print(f"[dp-bench] GCA_BENCH_MESH={DP_WORLD}: {json.dumps(row)}; peak memory per rank "
              f"{[round(r['peak_gib'], 2) for r in bench_rows]} GiB, CC launches per rank "
              f"{[r['launches'] for r in bench_rows]} (6 steps) ({smi})")
    mask = train[0]["mask"]
    check(mask["max_abs_err"] == 0, "masked_min_sweep differs from its plain version on the "
                                    "data-parallel mask")
    print(f"[kernel] masked_min_sweep on a data-parallel training mask (rank 0, N={mask['n']}, "
          f"{mask['edges']} edges): max_abs_err 0, {mask['ms'] * 1e3:.2f} us/sweep, plain "
          f"{mask['plain_ms'] * 1e3:.2f} us, bound {mask['bound_ms'] * 1e3:.2f} us ({smi})")
    launches = {"dp step (2 ranks)": sum(r["launches"] for r in step),
                "dp train (2 ranks)": sum(r["launches"] for r in train),
                "dp scene train (2 ranks)": sum(r["launches"] for r in scene),
                "dp bench (2 ranks)": sum(r["launches"] for r in bench_rows)}
    launches.update(_dp_serving(smi))
    print(f"[dp] rank seconds: " + ", ".join(f"{k} {ranks[0][k]:.1f}" for k in ranks[0]
                                            if k.endswith(":s")))
    return launches, {k: mask[k] for k in ("n", "ms", "plain_ms", "bound_ms")}


# ---------------------------------------------------------------- phase 24

SEQ_N = 16384           # the checks' cloud: 2.3x the compiled 7000 points
SEQ_BIG_N = 131072      # the full-width cloud: 18.7x
SEQ_K = 48              # the default Config's nn_nb
# ring kNN against the unsharded kNN: the sorted float64 distances of the
# picks (ties may reorder indices; tests/test_sharded_knn.py's atol)
SEQ_DIST_ATOL = 1e-4
# the sharded trunk against the unsharded model on the card, on the same
# neighbours (the sharded run's picks replayed): the one-pass sharded
# GroupNorm and the tile order round differently
# (tests/test_sharded_encoder.py's tolerance)
SEQ_FLOAT = dict(rtol=2e-4, atol=2e-4)
# the share of points whose neighbour set, in any of the three kNN layers,
# the unsharded program picks otherwise (near-ties under another tile's
# rounding) must stay below this
SEQ_FLIP_SHARE = 1e-3
SEQ_OUTPUTS = ("type_per_point", "param_per_point", "embedding")


@contextlib.contextmanager
def no_host_sync():
    """Any operation that synchronises the card with the host raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def fp32_matmuls():
    """TF32 off for matmuls and cuDNN inside, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _seq_cloud(n: int, seed: int) -> torch.Tensor:
    """One synthetic cloud of ``n`` points as ``[n, 6]`` (xyz ++ normal)."""
    xyz, nrm = synth_clouds(Config(num_points=n), 1, seed=seed)
    return torch.from_numpy(np.concatenate([xyz[0], nrm[0]], -1))


def _pick_distances(x: torch.Tensor, idx: torch.Tensor, posnormal: bool) -> torch.Tensor:
    """The float64 distances of each point to its picks, sorted per row."""
    x = x.double()
    nb, ctr = x[idx], x[:, None]
    if posnormal:
        d = ((nb[..., :3] - ctr[..., :3]) ** 2).sum(-1) * (
            3.0 - 2.0 * (nb[..., 3:] * ctr[..., 3:]).sum(-1))
    else:
        d = ((nb - ctr) ** 2).sum(-1)
    return torch.sort(d, dim=1).values


def _ring_knn_checks() -> None:
    """Phase 24 (a): ring kNN over ``["cuda:0"] * d`` against the unsharded
    kNN on the card (N=16384, k=48, plain ``[N, 3]`` and position-normal
    ``[N, 6]``), enqueued with no host sync (the sync debug mode is first
    shown to catch a host read); then card against CPU at N=2048, d=2.
    Both by sorted distance sets."""
    probe = torch.ones(1, device="cuda")
    try:
        with no_host_sync():
            probe.item()
        caught = False
    except RuntimeError:
        caught = True
    check(caught, "the sync debug mode let a host read pass")
    x6 = _seq_cloud(SEQ_N, 11).cuda()
    small = _seq_cloud(2048, 12)
    for posnormal in (False, True):
        x = x6 if posnormal else x6[:, :3].contiguous()
        metric = sharded_encoder.posnormal_metric if posnormal else None
        one = (knn_ops.knn_points_normals_indices if posnormal
               else knn_ops.knn_indices)(x[None], SEQ_K)[0]
        want = _pick_distances(x, one, posnormal)
        label = "position-normal [N, 6]" if posnormal else "euclidean [N, 3]"
        for d in (2, 4):
            shards = shard_rows(x, ["cuda:0"] * d)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            with no_host_sync():
                idx = ring_knn(shards, SEQ_K, metric)
            end.record()
            end.synchronize()
            err = float((_pick_distances(x, torch.cat(idx), posnormal) - want).abs().max())
            print(f"[seq-knn] {label} N={SEQ_N} k={SEQ_K} d={d} over cuda:0 (no host sync): "
                  f"{start.elapsed_time(end):.2f} ms (first call), sorted pick distances "
                  f"against the unsharded kNN max_abs_err {err:.3g} (atol {SEQ_DIST_ATOL})")
            check(err <= SEQ_DIST_ATOL, f"ring kNN ({label}, d={d}) differs from the unsharded kNN")
        xs = small if posnormal else small[:, :3].contiguous()
        card = sharded_knn(xs.cuda(), SEQ_K, ["cuda:0"] * 2, metric).cpu()
        cpu = sharded_knn(xs, SEQ_K, ["cpu"] * 2, metric)
        err = float((_pick_distances(xs, card, posnormal)
                     - _pick_distances(xs, cpu, posnormal)).abs().max())
        print(f"[seq-knn] {label} N=2048 d=2, card against CPU: sorted pick distances "
              f"max_abs_err {err:.3g}, index rows equal {float((card == cpu).all(1).float().mean()):.4%}")
        check(err <= SEQ_DIST_ATOL, f"ring kNN ({label}) differs between card and CPU")


def sharded_card_vs_cpu(cfg: Config, state: dict, x6: torch.Tensor, d: int) -> tuple:
    """The sharded trunk over ``["cuda:0"] * d`` (no host sync) and over
    ``["cpu"] * d`` from the same weights and cloud, TF32 off, the card's
    ring-kNN picks replayed on the CPU: ``({output: (max_abs_err, within
    CARD_VS_CPU_FLOAT)}, [the CPU's own picks equal, per ring kNN])``."""
    card = PrimitiveNet(cfg).cuda().eval()
    card.load_state_dict(state)
    cpu = PrimitiveNet(cfg).eval()
    cpu.load_state_dict(state)
    card_shards = shard_rows(x6.cuda(), ["cuda:0"] * d)
    with fp32_matmuls(), CallReplay("ring_knn", sharded_encoder) as replay:
        with no_host_sync():
            got = sharded_encoder.sharded_type_forward([card] * d, card_shards)
        replay.replaying = True
        want = sharded_encoder.sharded_type_forward([cpu] * d, shard_rows(x6, ["cpu"] * d))
    errs = {}
    for name, g, w in zip(SEQ_OUTPUTS, got, want):
        g, w = torch.cat(g).cpu(), torch.cat(w)
        check(bool(torch.isfinite(g).all()), f"sharded {name} not finite")
        errs[name] = (float((g - w).abs().max()), torch.allclose(g, w, **CARD_VS_CPU_FLOAT))
    return errs, replay.own_equal


class _ReplayKnn:
    """Stands in for ``ops/knn.py::_topk_neighbors`` while the unsharded
    model runs: its first calls (the forward's three kNN layers) return the
    sharded run's picks, after recording which rows the unsharded program
    would pick as another set; later calls (none of the trunk's) pass."""

    def __init__(self, picks: list):
        self.picks, self.real, self.differ = picks, knn_ops._topk_neighbors, []

    def __enter__(self):
        knn_ops._topk_neighbors = self
        return self

    def __exit__(self, *exc):
        knn_ops._topk_neighbors = self.real

    def __call__(self, neg_dist: torch.Tensor, k: int) -> torch.Tensor:
        own = self.real(neg_dist, k)
        if len(self.differ) == len(self.picks):
            return own
        pick = self.picks[len(self.differ)].to(own.device)[None]
        self.differ.append((torch.sort(own, -1).values != torch.sort(pick, -1).values).any(-1))
        return pick


def _sharded_trunk_checks() -> None:
    """Phase 24 (b): the sharded trunk (default ``Config`` widths, pushed
    weights) over ``["cuda:0"] * d``, d = 2 and 4, against the unsharded
    ``PrimitiveNet`` forward on the card at N=16384, TF32 off, on the sharded
    run's neighbours; the share of points whose neighbours the unsharded
    program picks otherwise; then card against CPU at N=2048, d=2."""
    model = PrimitiveNet(Config()).cuda().eval()
    push_weights(model)
    x6 = _seq_cloud(SEQ_N, 13).cuda()
    for d in (2, 4):
        with fp32_matmuls(), torch.no_grad():
            with CallReplay("ring_knn", sharded_encoder) as rec:
                got = sharded_encoder.sharded_type_forward([model] * d,
                                                           shard_rows(x6, ["cuda:0"] * d))
            picks = [torch.cat(p) for p in rec.recorded]
            with _ReplayKnn(picks) as replay:
                out = model(x6[None, :, :3].contiguous(), x6[None, :, 3:].contiguous())
        check(len(picks) == 3 and len(replay.differ) == 3, "three kNN layers replayed")
        moved = (replay.differ[0] | replay.differ[1] | replay.differ[2])[0]
        share = float(moved.float().mean())
        errs = []
        for name, g in zip(SEQ_OUTPUTS, got):
            g, w = torch.cat(g), getattr(out, name)[0]
            check(bool(torch.isfinite(g).all()), f"sharded {name} not finite")
            errs.append(f"{name} {float((g - w).abs().max()):.3g}")
            check(torch.allclose(g, w, **SEQ_FLOAT),
                  f"sharded {name} (d={d}) differs from the unsharded model")
        print(f"[seq-trunk] N={SEQ_N} d={d} over cuda:0 against the unsharded model on the card "
              f"(the sharded picks replayed; rtol {SEQ_FLOAT['rtol']}, atol "
              f"{SEQ_FLOAT['atol']}): max_abs_err {', '.join(errs)}; points whose neighbours "
              f"the unsharded program picks otherwise (per layer "
              f"{[int(r.sum()) for r in replay.differ]}): {int(moved.sum())} = {share:.4%}")
        check(share < SEQ_FLIP_SHARE, f"{share:.4%} of the points pick other neighbours")
    cfg = Config(num_points=2048)
    errs, own = sharded_card_vs_cpu(cfg, model.state_dict(), _seq_cloud(2048, 14), 2)
    print(f"[seq-trunk] N=2048 d=2, card against CPU (the card's ring-kNN picks replayed; "
          f"rtol {CARD_VS_CPU_FLOAT['rtol']}, atol {CARD_VS_CPU_FLOAT['atol']}): "
          + ", ".join(f"{k} {e:.3g} {'ok' if ok else 'FAIL'}" for k, (e, ok) in errs.items())
          + f"; the CPU's own picks equal per ring kNN: {own}")
    check(all(ok for _, ok in errs.values()), "the sharded trunk differs between card and CPU")


def _seq_full_width(smi: str) -> int:
    """Phase 24 (c): ``Predictor`` at the default ``Config`` over
    ``["cuda:0"] * 4``, ``predict_type_sharded`` on one cloud of N=131072:
    a warm-up and 3 timed calls, the launch counts from 0 just before.
    Returns the CC kernel's launches (the path groups nothing: 0)."""
    d = 4
    pred = Predictor(Config(mesh_shape=str(d)), device=["cuda:0"] * d)
    push_weights(pred.model)
    xyz, nrm = synth_clouds(Config(num_points=SEQ_BIG_N), 1, seed=15)
    first = pred.predict_type_sharded(xyz[0], nrm[0])                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    ms, wall = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = pred.predict_type_sharded(xyz[0], nrm[0])
        end.record()
        end.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        ms.append(start.elapsed_time(end))
    launches = _launches()["masked_min_sweep"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg = pred.cfg
    for key, width in (("type_per_point", cfg.num_primitives), ("param_per_point", 22),
                       ("embedding", cfg.out_dim)):
        check(res[key].shape == (SEQ_BIG_N, width) and np.isfinite(res[key]).all(),
              f"predict_type_sharded {key} {res[key].shape}")
    check(np.array_equal(res["types"], first["types"]), "a repeat changed the types")
    _profile(f"predict_type_sharded N={SEQ_BIG_N} d={d}",
             lambda: pred.predict_type_sharded(xyz[0], nrm[0]))
    print(f"[seq-serve] predict_type_sharded N={SEQ_BIG_N} ({SEQ_BIG_N / cfg.num_points:.1f}x "
          f"num_points) d={d} over cuda:0, default Config: "
          f"{', '.join(f'{t:.1f}' for t in ms)} ms (CUDA events), "
          f"{', '.join(f'{t:.1f}' for t in wall)} ms (host clock), peak memory {peak:.2f} GiB, "
          f"types {np.bincount(res['types'], minlength=cfg.num_primitives).tolist()}; "
          f"masked_min_sweep launches {launches} ({smi})")
    return launches


def _seq_http(smi: str) -> None:
    """Phase 24 (c): one POST of an N=16384 cloud to ``serve_http`` over
    ``["cuda:0"] * 2``, as ``.npz`` and as JSON, against the direct call."""
    srv = PredictionServer(Config(mesh_shape="2"), family="abc", device=["cuda:0"] * 2)
    push_weights(srv.predictor.model)
    xyz, nrm = synth_clouds(Config(num_points=SEQ_N), 1, seed=16)
    want = srv.predictor.predict_type_sharded(xyz[0], nrm[0])
    ready = threading.Event()
    thread = threading.Thread(target=srv.serve, kwargs=dict(host="127.0.0.1", port=0,
                                                            ready_event=ready), daemon=True)
    thread.start()
    try:
        check(ready.wait(60), "the HTTP server did not start")
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/predict_type_sharded"
        buf = io.BytesIO()
        np.savez(buf, xyz=xyz[0], normals=nrm[0])
        req = urllib.request.Request(url, data=buf.getvalue(), method="POST", headers={
            "Content-Type": "application/x-npz", "Accept": "application/x-npz"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            status, payload = r.status, r.read()
        wall = time.perf_counter() - t0
        status_json, body, _ = _post_json(url, json.dumps(
            {"xyz": xyz[0].tolist(), "normals": nrm[0].tolist()}).encode())
    finally:
        srv.shutdown()
        thread.join(60)
    check(not thread.is_alive(), "the HTTP server did not stop")
    check(status == 200 and status_json == 200, f"HTTP status {status}, {status_json}")
    with np.load(io.BytesIO(payload)) as z:
        got = {k: z[k] for k in z.files}
    check(sorted(got) == sorted(want), f"npz arrays {sorted(got)}")
    check(np.array_equal(got["types"], want["types"])
          and body == {"types": want["types"].tolist()}, "HTTP types differ")
    errs = {k: float(np.abs(got[k] - want[k]).max()) for k in SEQ_OUTPUTS}
    check(all(np.allclose(got[k], want[k], **HTTP_FLOAT) for k in SEQ_OUTPUTS),
          f"HTTP floats differ: {errs}")
    print(f"[seq-serve] serve_http /v1/predict_type_sharded N={SEQ_N} over 2 x cuda:0: npz "
          f"in {wall * 1e3:.1f} ms (host clock), types exact, floats max_abs_err "
          f"{max(errs.values()):.3g} (rtol/atol {HTTP_FLOAT['atol']}); JSON types exact ({smi})")


def _writer_check(model: torch.nn.Module) -> None:
    """Phase 24 (d): the reference-checkpoint writer on the card's model:
    its file equals the one written from a CPU copy key for key and value
    for value, and loads into a fresh card model bit for bit."""
    cpu = PrimitiveNet(model.cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as root:
        paths = {side: os.path.join(root, f"{side}.tar") for side in ("card", "cpu")}
        report = reference_ckpt.save_reference_checkpoint(paths["card"], model, epoch=1)
        reference_ckpt.save_reference_checkpoint(paths["cpu"], cpu, epoch=1)
        card_file, cpu_file = (torch.load(paths[s], weights_only=True) for s in ("card", "cpu"))
        a, b = card_file["model_state_dict"], cpu_file["model_state_dict"]
        check(list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
              and card_file["epoch"] == cpu_file["epoch"],
              "the card model's reference file differs from its CPU copy's")
        fresh = PrimitiveNet(model.cfg).cuda()
        loaded = from_jax.load_reference_checkpoint(fresh, paths["card"])
        want = model.state_dict()
        check(not loaded.missing and all(torch.equal(t, want[k])
                                         for k, t in fresh.state_dict().items()),
              "the reference file does not load back bit for bit")
    print(f"[seq-writer] reference checkpoint of the trained card model: {len(report.mapped)} "
          f"tensors, {len(report.defaulted)} at neutral defaults; equal to the CPU copy's file "
          f"key for key; loads into a fresh card model bit for bit")


def _tensorboard_check() -> None:
    """Phase 24 (e): whether ``ScalarLogger`` writes event files here."""
    import importlib.util

    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as root:
        logger = trainer_mod.ScalarLogger(root, "train")
        logger.log_scalars({"loss": 1.0}, 0)
        logger.close()
        events = glob.glob(os.path.join(root, "tb", "train", "events.*"))
        lines = open(os.path.join(root, "scalars_train.jsonl")).read().splitlines()
    print(f"[seq-tb] tensorboardX importable: "
          f"{importlib.util.find_spec('tensorboardX') is not None}; event files written: "
          f"{len(events)}; JSONL records: {len(lines)}")
    check(len(lines) == 1, "the JSONL record was not written")


def phase_sequence_parallel(smi: str, trained: torch.nn.Module | None = None) -> dict:
    """Phase 24: sequence parallelism, every shard on ``cuda:0`` (a ring of
    d shards on one card: the arithmetic of the ring, no peer copy): ring
    kNN (a), the sharded trunk against the unsharded model and against the
    CPU (b), ``predict_type_sharded`` at full width and its HTTP route (c);
    then the reference-checkpoint writer on ``trained`` (phase 8's model; a
    pushed random one when the phase runs alone) (d) and the TensorBoard
    events (e).  Returns the CC kernel's launches on the path: 0."""
    with fp32_matmuls():
        _ring_knn_checks()
        _sharded_trunk_checks()
    launches = _seq_full_width(smi)
    _seq_http(smi)
    if trained is None:
        trained = PrimitiveNet(Config()).cuda()
        push_weights(trained)
    _writer_check(trained)
    _tensorboard_check()
    return {"sequence parallel": launches}


# phase 25: the serving bench's metric lines, as tools/serve_bench.py names
# them (B = bench_config().batch_size), and the voxelize parity ops' input
SERVE_BENCH_METRICS = {
    "abc": ("serve_forward_clouds_per_sec_b1", "serve_forward_decomp_b1",
            "serve_forward_clouds_per_sec_b{b}", "serve_forward_decomp_b{b}",
            "serve_predict_clouds_per_sec_b1", "serve_predict_batch_clouds_per_sec_b{b}",
            "serve_predict_stream_clouds_per_sec_b{b}"),
    "scene": ("scene_serve_predict_clouds_per_sec_b1",
              "scene_serve_predict_batch_clouds_per_sec_b{b}",
              "scene_serve_predict_stream_clouds_per_sec_b{b}"),
}
VOXELIZE_M = 65536


def _serve_bench_run(family: str, argv: list[str], smi: str) -> int:
    """One in-process ``serve_bench.main`` run: every expected metric line
    once with a finite positive value, the sweeps' line before them; the
    CC kernel's launches, counted from 0, are returned."""
    b = bench_config().batch_size
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        lines = serve_bench.main(argv)
    seconds = time.perf_counter() - t0
    launches = _launches()["masked_min_sweep"]
    printed = [json.loads(line) for line in out.getvalue().splitlines()]
    check(printed == lines, f"serve_bench {family}: printed {printed}, returned {lines}")
    check(set(lines[0]) == {"sweeps_per_cloud"},
          f"serve_bench {family}: the first line is {lines[0]}")
    rows = lines[1:]
    want = sorted(m.format(b=b) for m in SERVE_BENCH_METRICS[family])
    check(sorted(r["metric"] for r in rows) == want,
          f"serve_bench {family}: metrics {[r['metric'] for r in rows]}, want {want}")
    for r in rows:
        value = r.get("value", r.get("device_ms_per_cloud"))
        check(np.isfinite(value) and value > 0, f"serve_bench {family}: {r}")
        if "fetch_ms_per_cloud" in r:
            check(np.isfinite(r["fetch_ms_per_cloud"]), f"serve_bench {family}: {r}")
    check(launches > 0, f"masked_min_sweep was not launched by serve_bench {family}")
    for line in lines:
        print(f"[serve_bench] {family}: {json.dumps(line)}")
    print(f"[serve_bench] {family}: {seconds:.1f} s, masked_min_sweep {launches} launches, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    return launches


def _voxelize_card_vs_cpu(smi: str) -> None:
    """The voxelize parity ops on M=65536 coordinates (4 batch ids on a
    48-grid, drawn from numpy seed 0), card against CPU exactly: the
    features are integers, so the voxel sums are exact in any order (the
    card's ``index_add_`` adds with atomics) and the means equal."""
    rng = np.random.default_rng(0)
    coords = np.concatenate([rng.integers(0, 4, (VOXELIZE_M, 1)),
                             rng.integers(0, 48, (VOXELIZE_M, 3))], 1).astype(np.int32)
    feats = rng.integers(-8, 9, (VOXELIZE_M, 6)).astype(np.float32)
    want = vox_ops.voxelization_idx(torch.from_numpy(coords), VOXELIZE_M)
    got = vox_ops.voxelization_idx(torch.from_numpy(coords).cuda(), VOXELIZE_M)
    for name, g, w in zip(("out_coords", "p2v", "num_voxels"), got, want):
        check(torch.equal(g.cpu(), w), f"voxelization_idx {name}: card differs from CPU")
    v = int(want[2])
    native_out, native_p2v, native_v = native.voxelize_idx(coords)
    check(native_v == v and np.array_equal(native_out, want[0][:v].numpy())
          and np.array_equal(native_p2v, want[1].numpy()),
          "data/native.py voxelize_idx differs from voxelization_idx")
    mean_cpu = vox_ops.voxelize_mean(torch.from_numpy(feats), want[1], VOXELIZE_M)
    feats_card = torch.from_numpy(feats).cuda()
    mean_card = vox_ops.voxelize_mean(feats_card, got[1], VOXELIZE_M)
    check(torch.equal(mean_card.cpu(), mean_cpu), "voxelize_mean: card differs from CPU")
    coords_card = torch.from_numpy(coords).cuda()
    idx_ms = time_graph(lambda: vox_ops.voxelization_idx(coords_card, VOXELIZE_M), 10)
    mean_ms = time_graph(lambda: vox_ops.voxelize_mean(feats_card, got[1], VOXELIZE_M), 10)
    print(f"[voxelize] M={VOXELIZE_M}, {v} voxels: card = CPU exactly "
          f"(voxelization_idx, voxelize_mean, and data/native.py voxelize_idx); "
          f"voxelization_idx {idx_ms:.3f} ms, voxelize_mean {mean_ms:.3f} ms ({smi})")


def _serve_bench_mask(card_name: str, smi: str) -> dict:
    """The sweep on the serving bench's own input: cloud 0's gated mask
    (N=8192) under the bench ``Predictor``'s seeded weights, which group
    far less than the pushed weights of the other phases; card against the
    plain version, both timed."""
    cfg = bench_config().replace(using_set_aggr=True)
    pred = Predictor(cfg, device="cuda")
    batch = synth_batch(cfg, cfg.batch_size, seed=0)
    xyz, nrm = (torch.as_tensor(np.asarray(batch[k][:1], np.float32), device="cuda")
                for k in ("gt_pc", "gt_normal"))
    with torch.inference_mode():
        out = pred.model(xyz, nrm)
    n = cfg.num_points
    shifted = (xyz[0] + out.pt_offsets).float()
    nbr, _ = grouping_ops.gated_neighbor_mask(
        shifted, out.semantic_scores.argmax(-1).to(torch.int32), out.embedding[0].float(),
        out.param_per_point[0].float(), cfg.num_primitives, cfg.grouping)
    labels = torch.arange(n, dtype=torch.int32, device="cuda")
    check(torch.equal(cc.masked_min_sweep(nbr, labels), cc.masked_min_sweep_plain(nbr, labels)),
          "sweep on the serving bench's mask")
    ms = time_graph(lambda: cc.masked_min_sweep(nbr, labels), 100)
    plain_ms = time_graph(lambda: cc.masked_min_sweep_plain(nbr, labels), 10)
    bound_ms = (n * n + 8 * n) / hbm_rate(card_name) * 1e3
    print(f"[kernel] masked_min_sweep on the serving bench's N={n} mask ({int(nbr.sum())} "
          f"edges): {ms * 1e3:.2f} us/sweep, plain {plain_ms * 1e3:.2f} us, bound "
          f"{bound_ms * 1e3:.2f} us, {bound_ms / ms:.1%} of the bound ({smi})")
    return {"n": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def phase_serve_bench(card_name: str, smi: str) -> tuple[dict, dict]:
    """Phase 25: ``gcanet_tpu_torch.serve_bench.main`` in-process at full
    width, torch's default TF32 settings: the flagship (B=10, N=8192) on
    all four paths and the scene family (B=10, grid 48) on ``predict``,
    ``batch`` and ``stream``, 5 timed calls each, the CC kernel's launches
    counted from 0 for each family's whole run; the sweep on the bench's
    own mask; then the voxelize parity ops card against CPU.  Returns the
    launches by path and the mask's times."""
    torch.backends.cuda.matmul.allow_tf32 = False          # torch's defaults
    torch.backends.cudnn.allow_tf32 = True
    launches = {
        "serve_bench abc": _serve_bench_run("abc", ["--iters", "5"], smi),
        "serve_bench scene": _serve_bench_run(
            "scene", ["--family", "scene", "--iters", "5", "--paths", "predict,batch,stream"],
            smi)}
    mask = _serve_bench_mask(card_name, smi)
    _voxelize_card_vs_cpu(smi)
    return launches, mask


# phase 26: the short convergence runs' row keys
CONVERGENCE_ROWS = {"abc": ("step", "miou", "type_miou", "t_min"),
                    "scene": ("step", "loss", "sem_miou", "acc", "ap50", "t_min")}
# each convergence cell's JAX log, seed 0: its step-0 row evaluates the
# JAX tool's start, which the port now draws with JAX's own stream, so the
# port's step-0 row must equal it within STEP0_ATOL.  The scene cells' are
# the JAX TPU logs.  The flagship's TPU log (production_convergence_v3.log)
# predates later changes of the JAX model and ran approximate kNN, and the
# current JAX tool's own step-0 row differs from it (a CPU run of the JAX
# package), so the flagship is held to that row
JAX_CONVERGENCE_LOGS = {"abc": "docs/torch_conv/conv_jax_cpu_step0.jsonl",
                        "scene": "docs/conv_r5/scene_conv_soft_s0.jsonl",
                        "scene grid 48": "docs/conv_r5/scene_conv_g48.jsonl"}
STEP0_ATOL = 0.01


def _micro_bench_run(smi: str) -> int:
    """``micro_bench.main`` in-process at ``bench_config()``, every default
    stage and ``edgebwd``: the device line, then each line once, as
    returned, finite and positive (the CPU test holds the names against the
    JAX tool's); the CC kernel's launches, counted from 0, are returned."""
    cfg = bench_config()
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        lines = micro_bench.main([",".join(micro_bench.STAGES + micro_bench.OPT_IN)])
    seconds = time.perf_counter() - t0
    launches = _launches()["masked_min_sweep"]
    printed = out.getvalue().splitlines()
    check(printed[0] == f"device: {smi}", f"micro_bench's device line is {printed[0]!r}")
    check(printed[1:] == [f"{name:28s} {ms:9.2f} ms" for name, ms in lines],
          f"micro_bench printed {printed[1:]}, returned {lines}")
    names = [name for name, _ in lines]
    check(len(set(names)) == len(names) == len(printed) - 1, f"micro_bench lines {names}")
    check(all(np.isfinite(ms) and ms > 0 for _, ms in lines), f"micro_bench: {lines}")
    check(launches > 0, "masked_min_sweep was not launched by micro_bench")
    for line in printed[1:]:
        print(f"[micro_bench] {line}")
    print(f"[micro_bench] B={cfg.batch_size}, N={cfg.num_points}: {seconds:.1f} s, "
          f"masked_min_sweep {launches} launches, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    return launches


def _convergence_run(family: str, module, root: str, smi: str) -> int:
    """A short convergence run in-process at the tool's default widths, 20
    steps, an eval every 10: the header names the card, three rows with the
    JAX tool's keys, every metric finite and inside [0, 1] (the scene loss
    NaN at step 0 only, as in JAX), then ``done``; the CC kernel's
    launches, counted from 0, are returned."""
    path = os.path.join(root, f"{family}.jsonl")
    _reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        module.main(["--steps", "20", "--eval-every", "10", "--out", path])
    seconds = time.perf_counter() - t0
    launches = _launches()["masked_min_sweep"]
    with open(path) as f:
        head, *body = f.read().splitlines()
    rows = [json.loads(line) for line in body]
    check(head.startswith(f"# {smi}; python -m {module.__name__} "),
          f"convergence {family}: header {head!r}")
    _check_step0(family, rows[0])
    check(out.getvalue().splitlines() == body + ["done"],
          f"convergence {family}: stdout {out.getvalue()!r}")
    check([r["step"] for r in rows] == [0, 10, 20] and all(
        tuple(r) == CONVERGENCE_ROWS[family] for r in rows), f"convergence {family}: {rows}")
    for r in rows:
        for k, v in r.items():
            if k == "loss" and r["step"] == 0:
                check(np.isnan(v), f"convergence {family}: loss {v} at step 0")
            elif k == "loss":
                check(np.isfinite(v) and v > 0, f"convergence {family}: {r}")
            elif k not in ("step", "t_min"):
                check(np.isfinite(v) and 0.0 <= v <= 1.0, f"convergence {family}: {r}")
        print(f"[convergence] {family}: {json.dumps(r)}")
    check(launches > 0, f"masked_min_sweep was not launched by the {family} convergence run")
    print(f"[convergence] {family}: 20 steps and 3 evals in {seconds:.1f} s, "
          f"masked_min_sweep {launches} launches ({smi})")
    return launches


def _check_step0(cell: str, row: dict) -> None:
    """The port's step-0 row of a convergence cell beside the JAX log's,
    both printed; fails when a metric differs by more than STEP0_ATOL."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), JAX_CONVERGENCE_LOGS[cell])
    with open(path) as f:
        want = next(json.loads(line) for line in f if line.startswith("{"))
    keys = [k for k in want if k not in ("step", "loss", "t_min")]
    got = {k: row[k] for k in keys}
    print(f"[step 0] {cell}: port {json.dumps(got)}, JAX log "
          f"{json.dumps({k: want[k] for k in keys})} ({JAX_CONVERGENCE_LOGS[cell]})")
    check(row["step"] == 0 and all(abs(got[k] - want[k]) <= STEP0_ATOL for k in keys),
          f"convergence {cell}: step 0 {got} against the JAX log's {want}")


def _scene_grid48_step0(root: str) -> None:
    """The grid-48 scene cell's step-0 eval alone (``--steps 0``) against
    its JAX log's."""
    path = os.path.join(root, "scene_grid48.jsonl")
    with contextlib.redirect_stdout(io.StringIO()):
        scene_convergence_run.main(["--steps", "0", "--grid", "48", "--out", path])
    with open(path) as f:
        _check_step0("scene grid 48", json.loads(f.read().splitlines()[1]))


def _micro_bench_mask(card_name: str, smi: str) -> dict:
    """The sweep on the micro-bench's ``graph`` stage's item-0 mask (N=8192,
    the bench workload's seeded weights), card against the plain version
    exactly, both timed."""
    cfg = bench_config()
    x = micro_bench.inputs(cfg, torch.device("cuda"))
    nbr = micro_bench.graph_mask(cfg, x, 0)
    n = nbr.shape[0]
    labels = torch.arange(n, dtype=torch.int32, device="cuda")
    check(torch.equal(cc.masked_min_sweep(nbr, labels), cc.masked_min_sweep_plain(nbr, labels)),
          "sweep on the micro-bench's graph mask")
    ms = time_graph(lambda: cc.masked_min_sweep(nbr, labels), 100)
    plain_ms = time_graph(lambda: cc.masked_min_sweep_plain(nbr, labels), 10)
    bound_ms = (n * n + 8 * n) / hbm_rate(card_name) * 1e3
    print(f"[kernel] masked_min_sweep on the micro-bench's graph-stage N={n} mask "
          f"({int(nbr.sum())} edges): {ms * 1e3:.2f} us/sweep, plain {plain_ms * 1e3:.2f} us, "
          f"bound {bound_ms * 1e3:.2f} us, {bound_ms / ms:.1%} of the bound ({smi})")
    return {"n": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def _largest_drawn_weight(model: torch.nn.Module) -> float:
    """The largest ``|w| * sqrt(fan_in)`` over the linear and conv weights
    of ``model`` (flax's fan-in of a ``k... x in x out`` kernel)."""
    def fan_in(m):              # a transposed conv's weight is [in, out, k...]
        w = m.weight
        return w.shape[0] * w[0, 0].numel() if isinstance(m, torch.nn.ConvTranspose3d) \
            else w[0].numel()

    return max(float(m.weight.detach().abs().max()) * fan_in(m) ** 0.5
               for m in model.modules()
               if isinstance(m, (torch.nn.Linear, torch.nn.Conv3d, torch.nn.ConvTranspose3d)))


def _check_draws() -> None:
    """Each convergence run's random start as the tool draws it (its
    default flags, seed 0: flax's init from ``PRNGKey(0)``): the largest
    ``|w| * sqrt(fan_in)`` of each family, at most flax's truncated
    lecun-normal cut, 2 / TRUNC_STD."""
    flagship = PrimitiveNet(convergence_run.make_config(convergence_run.parser().parse_args([])),
                            seed=0)
    args = scene_convergence_run.parser().parse_args([])
    scene = SoftGroupNet(scene_convergence_run.make_config(args), scene_grid=args.grid, seed=0)
    bound = 2 / TRUNC_STD
    largest = {"flagship": _largest_drawn_weight(flagship), "scene": _largest_drawn_weight(scene)}
    print(f"[draw] largest |w|*sqrt(fan_in): flagship {largest['flagship']:.6f}, "
          f"scene {largest['scene']:.6f}; flax's cut {bound:.6f}")
    for family, value in largest.items():
        check(value <= bound + 1e-6, f"{family} draws |w|*sqrt(fan_in) = {value} > {bound}")


def phase_micro_and_convergence(card_name: str, smi: str) -> tuple[dict, dict]:
    """Phase 26: each family's random start held to flax's truncated
    lecun-normal cut; the per-stage timer (``gcanet_tpu_torch.micro_bench``)
    at ``bench_config()`` with every stage and ``edgebwd``, then 20 steps of
    each convergence run at its default widths, each with the CC kernel's
    launches counted from 0, and the grid-48 scene cell's step-0 eval: each
    cell's step-0 row against its JAX log's; the sweep on the ``graph``
    stage's mask.
    Returns the launches by path and the mask's times."""
    torch.backends.cuda.matmul.allow_tf32 = False          # torch's defaults
    torch.backends.cudnn.allow_tf32 = True
    _check_draws()
    launches = {"micro_bench": _micro_bench_run(smi)}
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as root:
        launches["convergence abc"] = _convergence_run("abc", convergence_run, root, smi)
        launches["convergence scene"] = _convergence_run("scene", scene_convergence_run,
                                                         root, smi)
        _scene_grid48_step0(root)
    return launches, _micro_bench_mask(card_name, smi)


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
        train_launches, trained = run_phase(8, phase_training, log_dir)
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
    run_phase(18, phase_knobs_card_vs_cpu, card_name)
    bench_res = run_phase(19, phase_bench, card_name, smi)
    extras = run_phase(20, phase_serving_extras, smi)
    variants = run_phase(21, phase_variants, card_name, smi)
    geometry, simple_mask = run_phase(22, phase_geometry, card_name, smi)
    dp_launches, dp_mask = run_phase(23, phase_data_parallel, card_name, smi)
    seq_launches = run_phase(24, phase_sequence_parallel, smi, trained)
    serve_bench_launches, serve_bench_mask = run_phase(25, phase_serve_bench, card_name, smi)
    micro_launches, micro_mask = run_phase(26, phase_micro_and_convergence, card_name, smi)
    row = kernel_rows[0]
    scene_train_mask = scene_train.pop("mask")
    row["launches_by_path"] = {"serve": row["launches"], "train": train_launches,
                               **cli_launches, "scene_serve": scene["launches"], **scene_train,
                               **{f"bench {k}": v for k, v in bench_res["launches"].items()},
                               **extras, **variants, **geometry, **dp_launches,
                               **seq_launches, **serve_bench_launches, **micro_launches}
    row["launches"] = sum(row["launches_by_path"].values())
    row["scene_mask"] = {k: scene[k] for k in ("n", "ms", "plain_ms", "bound_ms")}
    row["scene_train_mask"] = scene_train_mask
    row["bench_mask"] = bench_res["mask"]
    row["simple_clusters_mask"] = simple_mask
    row["data_parallel_mask"] = dp_mask
    row["serve_bench_mask"] = serve_bench_mask
    row["micro_bench_mask"] = micro_mask
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
