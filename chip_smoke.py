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
     ``Trainer.train_one_epoch``: 2 warm-up steps, then 5 timed steps with
     the launch counts set to 0 just before and read just after: ms/step,
     examples/s, peak memory, every step's losses (all finite), the CC
     kernel's launches per step and sweeps per cloud;
  9. ``torch.profiler`` over two full-width train steps, forward and
     backward together.
Weights are random from a seed, with three pushes so that the path after
grouping does real work (see ``push_weights``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gcanet_tpu_torch.config import Config, GroupingConfig, InstanceHeadConfig
from gcanet_tpu_torch.data.synthetic import synth_batch, synth_clouds
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.ops import cc
from gcanet_tpu_torch.ops import grouping as grouping_ops
from gcanet_tpu_torch.ops import voxelize as vox_ops
from gcanet_tpu_torch.serve import Predictor
from gcanet_tpu_torch.train import instances as inst_utils
from gcanet_tpu_torch.train import step as step_lib
from gcanet_tpu_torch.train.trainer import Trainer
from gcanet_tpu_torch.utils import kernels

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


# ---------------------------------------------------------------- phases

def phase_card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[card] nvidia-smi: {smi}")
    name = torch.cuda.get_device_name(0)
    print(f"[card] torch: {name}, {torch.cuda.device_count()} device(s), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return name


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
    """Stands in for ``build_proposals`` while the card and then the CPU
    run the same train step.  Grouping is a hard threshold on floats that
    differ in the last bits between the devices, so the card's proposals
    are recorded and handed to the CPU, which records whether its own
    were equal; grouping itself is checked on identical inputs apart."""

    def __init__(self):
        self.real = grouping_ops.build_proposals
        self.recorded, self.own_equal = [], []
        self.replaying = False

    def __enter__(self):
        grouping_ops.build_proposals = self
        return self

    def __exit__(self, *exc):
        grouping_ops.build_proposals = self.real

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


def phase_serving(card_name: str, max_err: float) -> list[dict]:
    cfg = Config()
    n, b, reps = cfg.num_points, 4, 3
    pred = Predictor(cfg, device="cuda")
    push_weights(pred.model)
    xyz, nrm = synth_clouds(cfg, b, seed=2)
    pred.predict(xyz[0], nrm[0])                         # warm-up
    pred.predict_batch(xyz, nrm)
    torch.cuda.synchronize()

    for wrapper, _, _ in KERNELS:
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    singles = [pred.predict(xyz[i], nrm[i]) for i in range(reps)]
    t_single = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        batch = pred.predict_batch(xyz, nrm)
    t_batch = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w, _, _ in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    clouds = reps + reps * b

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
        scale = max(float(w.abs().max()) for w in want.values())
        if tag == "inst" and head_bf16:
            g = torch.cat([got[k].flatten() for k in want])
            w = torch.cat([want[k].flatten() for k in want])
            cos = float(g @ w / (g.norm() * w.norm()))
            res["inst_grad_cosine"] = cos
            check(cos >= TRAIN_BF16_MIN_COSINE, f"inst_loss gradient cosine {cos}")
            continue
        rows = []
        for name, w in want.items():
            g = got[name]
            check(bool(torch.isfinite(g).all()), f"{tag} gradient of {name} not finite")
            excess = float(((g - w).abs() - TRAIN_GRAD_RTOL * w.abs()).max()) / scale
            rel_l2 = float((g - w).norm() / w.norm().clamp(min=1e-30))
            rows.append((excess, rel_l2, float((g - w).abs().max()), name))
        rows.sort(reverse=True)
        print(f"[train-vs-cpu]   {tag} gradients, worst 4 (excess over rtol as a share of "
              f"the largest entry {scale:.3g}, relative L2 error, max_abs_err): "
              + "; ".join(f"{n} {e:.3g} {r:.3g} {a:.3g}" for e, r, a, n in rows[:4]))
        res[f"{tag}_grad_atol_share_needed"] = rows[0][0]
        res[f"{tag}_grad_max_rel_l2"] = max(r[1] for r in rows)
        check(rows[0][0] <= TRAIN_GRAD_ATOL_SHARE[tag],
              f"{tag} gradient of {rows[0][3]} out of tolerance")

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


def _time_steps(trainer: Trainer, epoch: int, steps: int):
    """``steps`` steps of ``trainer.train_one_epoch``, each bracketed by CUDA
    events and a read of the CC kernel's launch count."""
    marks = []
    real = step_lib.train_step

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = cc.masked_min_sweep.launches
        start.record()
        out = real(*args, **kw)
        end.record()
        marks.append((start, end, cc.masked_min_sweep.launches - before))
        return out

    step_lib.train_step = timed
    try:
        history = trainer.train_one_epoch(epoch, num_batches=steps)
    finally:
        step_lib.train_step = real
    torch.cuda.synchronize()
    return history, [(s.elapsed_time(e), n) for s, e, n in marks]


def phase_training(log_dir: str) -> int:
    """Phase 8: full width through ``Trainer.train_one_epoch``.  Returns the
    CC kernel's launches in the timed steps."""
    cfg = Config(log_dir=log_dir, data_path=log_dir)
    steps, b = 5, cfg.batch_size
    trainer = Trainer(cfg)
    try:
        push_weights(trainer.model)
        trainer.train_one_epoch(0, num_batches=2)              # warm-up
        torch.cuda.synchronize()
        for wrapper, _, _ in KERNELS:
            wrapper.launches = 0
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        history, per_step = _time_steps(trainer, 1, steps)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w, _, _ in KERNELS}
        peak = torch.cuda.max_memory_allocated()
    finally:
        trainer.close()
    ms = start.elapsed_time(end) / steps
    totals = [float(m["total_loss"]) for m in history]
    print(f"[train] N={cfg.num_points} B={b} K={cfg.nn_nb} P={cfg.instance_head.max_proposals} "
          f"grid={cfg.instance_head.grid_size}, {steps} steps after 2 warm-up steps: "
          f"{ms:.1f} ms/step (CUDA events; host clock {wall / steps * 1e3:.1f}), "
          f"{b * 1e3 / ms:.2f} examples/s, peak memory {peak / 2**30:.2f} GiB")
    print(f"[train] per step ms: {[round(t, 1) for t, _ in per_step]}; CC launches per "
          f"step: {[n for _, n in per_step]}")
    for i, m in enumerate(history):
        print(f"[train] step {i}: " + ", ".join(f"{k} {float(v):.4g}" for k, v in m.items()))
    check(all(np.isfinite(totals)), f"non-finite total_loss {totals}")
    check(all(n > 0 for _, n in per_step), "a train step launched no CC sweep")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the training path")
    print(f"[train] launches on the training path ({steps} steps, {steps * b} clouds): "
          f"{launches}; masked_min_sweep per step {launches['masked_min_sweep'] / steps:.1f}, "
          f"sweeps per cloud {launches['masked_min_sweep'] / (steps * b):.1f}")
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
                  f"{e.key[:60]} (hand-written)")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card_name = phase_card()
    phase_build()
    max_err = phase_kernel_check()
    phase_card_vs_cpu()
    kernel_rows = phase_serving(card_name, max_err)
    phase_profile()
    phase_train_card_vs_cpu()
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR.parent) as log_dir:
        train_launches = phase_training(log_dir)
        phase_train_profile(log_dir)
    row = kernel_rows[0]
    row["launches_by_path"] = {"serve": row["launches"], "train": train_launches}
    row["launches"] += train_launches
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
