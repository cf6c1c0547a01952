"""Per-stage timing of the flagship pipeline at the bench workload (port of
``tools/micro_bench.py``).

    python -m gcanet_tpu_torch.micro_bench [stage,stage,...] [--device cpu]

Stages: knn, encoder, model_fwd, graph, cc, grouping, voxelize, head,
losses, step (the default: all ten, in this order); ``edgebwd`` is opt-in
(the neighbour gather's backward, ``scatter`` against ``revgather:{48,64,
96}`` at C=64 and 128, and the argsort that builds the reverse index).  The
workload is the JAX tool's: ``config.py::bench_config`` (the
``GCA_BENCH_*`` knobs; flagship B=10, N=8192), one synthetic batch (seed
0), the JAX tool's weights and grid shifts (its one key ``PRNGKey(0)``:
flax's init of the model, the encoder and the instance head, each the
root of its own tree; the forward's shift ``uniform(key, (2, 3))``, the
step's with the key folded with step 0), and the stage inputs
(``points``, ``emb``, ``param``, ``cls_argmax``, ``shifted``, ``pid``)
taken from one training-mode forward.  The random stage inputs (the
feature-64 kNN's points, the edge gathers' inputs and cotangents) are
``torch.randn`` draws: up to half a billion values, which the host's copy
of JAX's stream would take minutes to make.

Each stage times the port's counterpart of what the JAX stage times, with
``utils/timing.py::time_fn`` (CUDA events on a card, the host clock on the
CPU) at the JAX tool's counts: 10 calls after 2, the full train step 5
after 1.  ``cc`` and ``grouping`` include the connected-components loop's
host read after every sweep (``ops/cc.py``), which is the port's cost as it
stands.  The JAX ``knn_impl="approx"`` is an exact top-k here
(``ops/knn.py``).  The JAX stages that take no gradient (``encoder fwd``,
``model fwd``) run under ``torch.no_grad()``: a jitted forward keeps no
residuals either.

Prints one line naming the device (on a card, ``nvidia-smi``'s name and
power limit), then one line per timing, ``f"{name:28s} {ms:9.2f} ms"``
under the JAX tool's names, and nothing else.  It runs on the card;
``--device cpu`` runs it on the CPU.  The sweep's launch counter
(``ops/cc.py``) is read by no one here and never reset.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import torch

from gcanet_tpu_torch.config import Config, bench_config
from gcanet_tpu_torch.data.synthetic import synth_batch
from gcanet_tpu_torch.models.dgcnn import DGCNNEncoderGn
from gcanet_tpu_torch.models.instance_head import InstanceHead
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.ops import grouping as grouping_ops
from gcanet_tpu_torch.ops import knn as knn_ops
from gcanet_tpu_torch.ops import voxelize as vox_ops
from gcanet_tpu_torch.parallel.dist import pick_device
from gcanet_tpu_torch.train import step as step_lib
from gcanet_tpu_torch.utils import threefry
from gcanet_tpu_torch.utils.flax_init import init_from_seed
from gcanet_tpu_torch.utils.from_jax import build_encoder_rules, build_instance_head_rules
from gcanet_tpu_torch.utils.timing import device_line, time_fn

STAGES = ("knn", "encoder", "model_fwd", "graph", "cc", "grouping", "voxelize", "head",
          "losses", "step")
OPT_IN = ("edgebwd",)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("stages", nargs="?", default=",".join(STAGES),
                    help="comma list of " + ",".join(STAGES + OPT_IN))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def _seeded(module: torch.nn.Module, rules, device: torch.device) -> torch.nn.Module:
    init_from_seed(module, rules, 0)
    return module.to(device)


def inputs(cfg: Config, dev: torch.device) -> SimpleNamespace:
    """The workload on ``dev``: the seeded model and Adam, the batch (seed
    0), the forward's and the step's grid shifts, the draw generator, and
    the stage inputs from one training-mode forward
    (tools/micro_bench.py:43-69)."""
    model = PrimitiveNet(cfg, seed=0).to(dev)
    batch = step_lib.batch_to_device(
        {k: v for k, v in synth_batch(cfg, cfg.batch_size, seed=0).items() if k != "index"},
        dev)
    shift = torch.from_numpy(threefry.uniform(threefry.key(0), (2, 3))).to(dev)
    with torch.no_grad():
        out = step_lib.train_forward(model, batch, r1=shift)
    b, n = batch["T_gt"].shape
    gt_pc = batch["gt_pc"]
    return SimpleNamespace(
        model=model, optimizer=step_lib.make_optimizer(cfg, model.parameters()),
        batch=batch, shift=shift, step_shift=step_lib.grid_shift(threefry.key(0), 0, dev),
        draws=torch.Generator(device=dev).manual_seed(0),   # random stage inputs
        out=out, b=b, n=n,
        points=torch.cat([gt_pc, batch["gt_normal"]], dim=-1),
        emb=out.embedding.float(), param=out.param_per_point.float(),
        cls_argmax=out.semantic_scores.reshape(b, n, -1).argmax(-1).to(torch.int32),
        shifted=(gt_pc + out.pt_offsets.reshape(b, n, 3)).float(),
        pid=out.proposals.point_pid)


def graph_mask(cfg: Config, x: SimpleNamespace, i: int) -> torch.Tensor:
    """Item ``i``'s gated neighbour mask, the ``graph`` stage's work."""
    return grouping_ops.gated_neighbor_mask(x.shifted[i], x.cls_argmax[i], x.emb[i],
                                            x.param[i], cfg.num_primitives, cfg.grouping)[0]


def main(argv: list[str] | None = None) -> list[tuple[str, float]]:
    """Time the stages and print their lines; returns ``(name, ms)`` in
    printed order."""
    args = _parser().parse_args(argv)
    stages = args.stages.split(",")
    unknown = set(stages) - set(STAGES + OPT_IN)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}; known: {STAGES + OPT_IN}")
    dev = pick_device(args.device, 1, "the micro-bench")
    print(f"device: {device_line(dev)}", flush=True)

    cfg = bench_config()
    x = inputs(cfg, dev)
    model, batch, out = x.model, x.batch, x.out
    b, n, points, emb, pid = x.b, x.n, x.points, x.emb, x.pid
    gt_pc = batch["gt_pc"]
    k = cfg.nn_nb
    ih = cfg.instance_head
    lines: list[tuple[str, float]] = []

    def report(name: str, secs: float) -> None:
        lines.append((name, secs * 1e3))
        print(f"{name:28s} {secs * 1e3:9.2f} ms", flush=True)

    def randn(*shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=x.draws, device=dev)

    if "knn" in stages:
        report("knn points+normals (x1)", time_fn(
            lambda p: knn_ops.knn_points_normals_indices(p, k, cfg.knn_impl), points))
        report("knn feature-64 (x2/step)", time_fn(
            lambda p: knn_ops.knn_indices(p, k, cfg.knn_impl), randn(b, n, 64)))

    if "encoder" in stages:
        enc = _seeded(DGCNNEncoderGn(nn_nb=k, knn_impl=cfg.knn_impl, mode=cfg.mode),
                      build_encoder_rules(), dev)
        enc_params = list(enc.parameters())

        def enc_grad(p):
            return torch.autograd.grad(enc(p).pow(2).sum(), enc_params)

        with torch.no_grad():
            report("encoder fwd", time_fn(enc, points))
        report("encoder fwd+bwd", time_fn(enc_grad, points))

    if "model_fwd" in stages:
        with torch.no_grad():
            report("model fwd (full)", time_fn(
                lambda: step_lib.train_forward(model, batch, r1=x.shift)))

    def graph_fn():
        return [graph_mask(cfg, x, i) for i in range(b)]

    if "graph" in stages:
        report("grouping: gated graph", time_fn(graph_fn))

    if "cc" in stages:
        nbr_all = graph_fn()
        report(f"grouping: CC ({cfg.grouping.cc_impl})", time_fn(
            lambda: [grouping_ops.connected_components(m, cfg.grouping.cc_max_iters)
                     for m in nbr_all]))
        del nbr_all

    if "grouping" in stages:
        report("grouping: total", time_fn(
            lambda: grouping_ops.build_proposals(x.shifted, x.cls_argmax, emb, x.param,
                                                 cfg.num_primitives, cfg.grouping,
                                                 max_proposals=ih.max_proposals)))

    def voxelize():
        return vox_ops.clusters_voxelization(gt_pc.reshape(b * n, 3), emb.reshape(b * n, -1),
                                             pid, num_proposals=ih.max_proposals,
                                             grid_size=ih.grid_size)

    if "voxelize" in stages:
        report("cluster voxelization", time_fn(voxelize))

    if "head" in stages:
        vx = voxelize()
        head = _seeded(InstanceHead(cfg.num_primitives, ih.channels, ih.grid_size),
                       build_instance_head_rules(), dev).train()

        def head_grad(feats):
            feats = feats.detach().requires_grad_(True)
            o = head(feats, vx.active, vx.entry_voxel, pid)
            loss = (o.cls_scores.pow(2).sum() + o.mask_scores.pow(2).sum()
                    + o.iou_scores.pow(2).sum())
            return torch.autograd.grad(loss, feats)[0]

        report("instance head fwd+bwd", time_fn(head_grad, vx.feats))
        del vx

    if "edgebwd" in stages:
        # the two real backward scatters are [B,N,K]-edge cotangents into
        # [B*N, 64] and [B*N, 128] (edge convs 2 and 3 at the bench shapes)
        idx = knn_ops.knn_indices(randn(b, n, 64), k, cfg.knn_impl)
        for c_out in (64, 128):
            gcot = randn(b, n, k, c_out)
            xin = randn(b, n, c_out)

            def bwd(kind):
                def f(x, g):
                    x = x.detach().requires_grad_(True)
                    return torch.autograd.grad(knn_ops.gather_neighbors_impl(x, idx, kind),
                                               x, g)[0]
                return f

            report(f"edge bwd scatter C={c_out}", time_fn(bwd("scatter"), xin, gcot))
            for m in (48, 64, 96):
                report(f"edge bwd revgather:{m} C={c_out}",
                       time_fn(bwd(f"revgather:{m}"), xin, gcot))
            del gcot
        report("argsort edges (rev index)", time_fn(
            lambda i: torch.argsort(i.reshape(b, n * k), dim=1), idx))

    if "losses" in stages:
        with torch.no_grad():
            report("losses fwd", time_fn(lambda: step_lib.compute_losses(cfg, out, batch)[0]))

    if "step" in stages:
        report("full train step", time_fn(
            lambda: step_lib.train_step(model, x.optimizer, batch, r1=x.step_shift),
            iters=5, warmup=1))
    return lines


if __name__ == "__main__":
    main()
