"""The rank side of ``tests/test_torch_parallel.py``: a process of a 2-rank
gloo group on the CPU runs every data-parallel check of the port and hands
its results to the test through a queue.

The test starts the ranks with ``spawn``, so each imports this module and
not the test module: a rank imports no JAX (``main`` reports the modules it
holds).  Every job returns numpy arrays and Python values.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from gcanet_tpu_torch.parallel import dist as pdist
from gcanet_tpu_torch.train import step as tstep

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gcanet_tpu", "sklearn")


def main(rank: int, world: int, port: int, jobs_path: str, queue) -> None:
    """Join the group, run the jobs saved at ``jobs_path`` (``[(key, job
    name, kwargs)]``) in order, put ``(rank, {key: result, "modules":
    [...]})`` on ``queue`` (or ``(rank, traceback)`` on a failure)."""
    torch.set_num_threads(1)
    pdist.init_dist(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        jobs = torch.load(jobs_path, weights_only=False)
        out = {key: JOBS[name](rank, world, **kw) for key, name, kw in jobs}
        out["modules"] = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
        queue.put((rank, out))
    except BaseException:                    # noqa: BLE001 -- reported to the test
        queue.put((rank, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def _numpy(d):
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


def _digest(model: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _own_gradient(make_model, chunk, r1, forward, losses, head_bf16=True):
    """The gradient this rank's chunk gives on one device, outside the
    group, with the instance head in bf16 or fp32."""
    model = make_model()
    model.instance_head.compute_bf16 = head_bf16
    total, _ = losses(model.cfg, forward(model, chunk, r1=r1), chunk)
    total.backward()
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def _step(make_model, step, forward, losses, batch, r1, rank, world, fp32_head_too=False):
    """The data-parallel ``step`` on this rank's chunk of ``batch``: metrics,
    the group's gradient, this rank's own one-device gradient (and with
    ``fp32_head_too`` the one of the instance head in fp32), the new state
    and its digest."""
    model = make_model()
    opt = tstep.make_optimizer(model.cfg, model.parameters())
    chunk = tstep.batch_to_device(pdist.local_shard(batch, rank, world), "cpu")
    r1 = torch.from_numpy(r1)
    head_bf16 = model.instance_head.compute_bf16
    metrics = step(model, opt, chunk, r1=r1)
    out = {"metrics": _numpy(metrics),
           "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
           "own_grads": _own_gradient(make_model, chunk, r1, forward, losses, head_bf16),
           "state": _numpy(model.state_dict()), "digest": _digest(model)}
    if fp32_head_too:
        out["own_grads_fp32_head"] = _own_gradient(make_model, chunk, r1, forward, losses,
                                                   head_bf16=False)
    return out


def flagship_step(rank, world, cfg, state, batch, r1, head_bf16):
    """One data-parallel train step of ``PrimitiveNet`` (``_step``)."""
    from gcanet_tpu_torch.models.primitive_net import PrimitiveNet

    def make():
        model = PrimitiveNet(cfg)
        model.load_state_dict(state)
        model.instance_head.compute_bf16 = head_bf16
        return model

    return _step(make, tstep.train_step, tstep.train_forward, tstep.compute_losses, batch, r1,
                 rank, world)


def scene_step(rank, world, cfg, state, batch, r1, grid, channels):
    """As ``flagship_step`` for ``SoftGroupNet`` (``scene_train_step``)."""
    from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet
    from gcanet_tpu_torch.train import scene_step as tscene

    def make():
        model = SoftGroupNet(cfg, scene_grid=grid, channels=channels)
        model.load_state_dict(state)
        return model

    def forward(model, chunk, r1):
        model.train()
        return model(chunk["xyz"], chunk["feats"], r1=r1)

    return _step(make, tscene.scene_train_step, forward, tscene.compute_scene_losses, batch,
                 r1, rank, world, fp32_head_too=True)


def _tiny_scene(grid, channels):
    import gcanet_tpu_torch.models.softgroup_scene as tsg

    tsg.SoftGroupNet = functools.partial(tsg.SoftGroupNet, scene_grid=grid, channels=channels)


def trainer(rank, world, cfg, state, scene=False, grid=8, channels=8, batches=2):
    """A data-parallel ``Trainer`` (``SceneTrainer`` with ``scene``): this
    rank's first ``batches`` batches of epoch 1, one epoch of ``batches``
    steps (their total losses and the digest of the state after them), and
    the merged evaluation: what ``test_one_epoch`` returns, and on rank 0
    the scalars and CSV it wrote."""
    if scene:
        _tiny_scene(grid, channels)
        from gcanet_tpu_torch.train.scene_trainer import SceneTrainer as cls
    else:
        from gcanet_tpu_torch.train.trainer import Trainer as cls
    tr = cls(cfg, device="cpu")
    try:
        stream = [{k: np.asarray(v) for k, v in b.items() if k != "index"}
                  for b in tr._train_batches(1, batches)]
        tr.model.load_state_dict(state)
        seen = len(list(tr._test_batches()))
        returned = tr.test_one_epoch(0)
        written = {}
        if rank == 0:
            with open(tr.test_viz.path) as f:
                written["scalars"] = json.loads(f.readlines()[-1])
            with open(os.path.join(cfg.log_dir, "output_results.csv")) as f:
                written["csv"] = f.read()
        history = tr.train_one_epoch(1, num_batches=batches)
        return {"stream": stream, "eval_objects": seen, "returned": returned,
                "written": written, "rows": tr._results_rows,
                "losses": [float(m["total_loss"]) for m in history],
                "digest": _digest(tr.model), "main": tr.main, "world": tr.world}
    finally:
        tr.close()


def gathers(rank, world, parts, meter_values):
    """``collect_results`` of ``parts[rank]``; ``AverageMeter`` over
    ``meter_values[rank]`` (``(value, n)`` pairs), reduced and not."""
    meters = {}
    for reduce in (True, False):
        m = pdist.AverageMeter(apply_dist_reduce=reduce)
        for v, n in meter_values[rank]:
            m.update(v, n)
        meters[reduce] = (m.get_val(), m.get_avg())
    return {"collected": pdist.collect_results(parts[rank]), "meters": meters,
            "info": pdist.get_dist_info(), "main": pdist.is_main_process()}


def cli(rank, world, argv):
    """``train_new.main`` in the group: train one epoch (evaluating after
    it), then ``--eval`` of the latest checkpoint; rank 0's checkpoint files
    and test records."""
    from gcanet_tpu_torch import train_new

    os.environ["GCA_SYNTH_BATCHES"] = "1"
    codes = [train_new.main(argv + ["--not_load_model"], device="cpu"),
             train_new.main(argv + ["--eval"], device="cpu")]
    log_dir = argv[argv.index("--log_dir") + 1]
    out = {"codes": codes}
    if rank == 0:
        out["checkpoints"] = sorted(os.listdir(os.path.join(log_dir, "checkpoint")))
        with open(os.path.join(log_dir, "scalars_test.jsonl")) as f:
            out["records"] = [json.loads(line) for line in f]
    return out


def bench(rank, world, env):
    """``bench.main`` under ``GCA_BENCH_MESH``: the line it returns (rank 0
    prints it)."""
    from gcanet_tpu_torch import bench as tbench

    os.environ.update(env)
    return tbench.main([], device="cpu")


JOBS = {f.__name__: f for f in (flagship_step, scene_step, trainer, gathers, cli, bench)}
