"""Production-size convergence run of the flagship on the card (port of
``tools/convergence_run.py``).

    python -m gcanet_tpu_torch.convergence_run [--steps 1000] [--out PATH]
        [--device cpu] [the JAX tool's other flags]

Trains the full pipeline on synthetic ABC-like objects and logs Hungarian
mIoU / type-mIoU on held-out objects every ``--eval-every`` steps: JSONL
rows ``{"step", "miou", "type_miou", "t_min"}`` in the format of
``docs/production_convergence*.log``, then ``done`` on stdout.  The flags,
defaults, ``Config``, data seeds and eval protocol are the JAX tool's:

* ``Config`` as there; ``--recall`` maps to ``knn_impl`` the same way
  (``approx:R`` or ``xla`` for ``exact``), and every ``knn_impl`` is an
  exact top-k in the port (``ops/knn.py``).
* One fresh batch per step, ``synth_batch`` seeds ``seed * 100_000 + 1000 +
  step`` (``--hard``: 8-16 instances per object), loaded and copied on the
  trainer's prefetch thread (``train/trainer.py::prefetch_to_device``).
* The held-out objects are ``synth_batch(cfg, 1, seed=90000 + i)``, fixed
  whatever ``--seed`` says, so runs share them; each goes through
  ``train/step.py::eval_step`` on the device and ``metrics.compute_miou`` /
  ``compute_type_miou_abc`` on the host.
* The weights are the JAX tool's for ``--seed`` (flax's init from
  ``PRNGKey(seed)``, ``utils/flax_init.py``), Adam at
  ``Config.learning_rate`` with no decay.  Step i's voxel grid shift is
  the JAX step's, ``uniform(fold_in(PRNGKey(seed + 1), i), (2, 3))``
  (``train/step.py::grid_shift``).

The file starts with a ``#`` line naming the device (on a card,
``nvidia-smi``'s name and power limit) and the command, which
``tools/gate_report.py`` reads as the run's header.  It runs on the card;
``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from gcanet_tpu_torch.config import Config, InstanceHeadConfig
from gcanet_tpu_torch.data.synthetic import synth_batch
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.parallel.dist import pick_device
from gcanet_tpu_torch.train import metrics as M
from gcanet_tpu_torch.train import step as step_lib
from gcanet_tpu_torch.train.trainer import prefetch_to_device
from gcanet_tpu_torch.utils import threefry
from gcanet_tpu_torch.utils.timing import device_line
from gcanet_tpu_torch.utils.transfer import fetch


def harder_mix(cfg: Config, seed: int) -> dict:
    """Objects with 8-16 instances (the default mix has 3-8): smaller
    primitives, denser proposal occupancy."""
    return synth_batch(cfg, cfg.batch_size, seed=seed, inst_range=(8, 17))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--max-proposals", type=int, default=200)
    ap.add_argument("--max-instances", type=int, default=48)
    ap.add_argument("--recall", default="0.8",
                    help="approx-kNN recall target, or 'exact' (both exact top-k here)")
    ap.add_argument("--hard", action="store_true",
                    help="harder mix: 8-16 instances per object")
    ap.add_argument("--encoder-bf16", action="store_true",
                    help="bf16 edge-tensor compute in the DGCNN encoder")
    ap.add_argument("--nn-nb", type=int, default=0,
                    help="edge-conv/embedding graph degree K (0 = Config default)")
    ap.add_argument("--shared-graph", action="store_true",
                    help="reuse the first edge-conv kNN graph for all three edge convs")
    ap.add_argument("--nn-nb-inner", type=int, default=0,
                    help="graph degree for edge convs 2-3 (0 = nn_nb-uniform)")
    ap.add_argument("--seed", type=int, default=0,
                    help="init/data seed family for repeat runs (eval objects stay fixed)")
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--eval-objects", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "convergence.jsonl"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def make_config(args: argparse.Namespace) -> Config:
    """The JAX tool's ``Config`` (tools/convergence_run.py:79-87)."""
    knn_impl = "xla" if args.recall == "exact" else f"approx:{args.recall}"
    return Config(num_points=args.points, batch_size=args.batch,
                  max_instances=args.max_instances, knn_impl=knn_impl,
                  encoder_bf16=args.encoder_bf16,
                  shared_graph=args.shared_graph,
                  nn_nb_inner=args.nn_nb_inner,
                  instance_head=InstanceHeadConfig(max_proposals=args.max_proposals),
                  **({"nn_nb": args.nn_nb} if args.nn_nb else {}))


def eval_objects(cfg: Config, args: argparse.Namespace) -> list[dict]:
    """The fixed held-out objects (seeds ``90000 + i``), host arrays."""
    ecfg = cfg.replace(batch_size=1)
    eval_range = (8, 17) if args.hard else (3, 9)
    return [{k: v for k, v in synth_batch(ecfg, 1, seed=90000 + i,
                                          inst_range=eval_range).items() if k != "index"}
            for i in range(args.eval_objects)]


def train_batches(cfg: Config, args: argparse.Namespace):
    """The host batch of every step, fresh each step."""
    for step in range(args.steps):
        b = (harder_mix(cfg, args.seed * 100_000 + 1000 + step) if args.hard
             else synth_batch(cfg, args.batch, seed=args.seed * 100_000 + 1000 + step))
        yield {k: v for k, v in b.items() if k != "index"}


def object_metrics(results: list[tuple[np.ndarray, np.ndarray]],
                   objects: list[dict]) -> tuple[float, float]:
    """Mean mIoU and type-mIoU over the held-out objects, from each one's
    host ``(merged [N] labels, type_per_point [1, N, C])``
    (tools/convergence_run.py:107-116)."""
    mious, tmious = [], []
    for (merged, tpp), eb in zip(results, objects):
        i_gt = np.asarray(eb["I_gt"])[0]
        t_gt = np.asarray(eb["T_gt"])[0]
        pred_t = np.argmax(tpp[0], -1)
        merged = np.asarray(merged).reshape(-1)
        mious.append(M.compute_miou(merged, i_gt))
        tmious.append(M.compute_type_miou_abc(pred_t, t_gt, merged, i_gt))
    return float(np.mean(mious)), float(np.mean(tmious))


def write_row(log, row: dict) -> None:
    print(json.dumps(row), flush=True)
    log.write(json.dumps(row) + "\n")
    log.flush()


def header(device: torch.device, module: str, argv: list[str]) -> str:
    """The log's first line: the device and the command."""
    return f"# {device_line(device)}; python -m {module} {' '.join(argv)}".rstrip() + "\n"


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    dev = pick_device(args.device, 1, "the convergence run")
    cfg = make_config(args)
    model = PrimitiveNet(cfg, seed=args.seed).to(dev)
    optimizer = step_lib.make_optimizer(cfg, model.parameters())
    objects = eval_objects(cfg, args)
    objects_dev = [step_lib.batch_to_device(eb, dev) for eb in objects]

    def evaluate() -> tuple[float, float]:
        results = []
        for eb in objects_dev:
            out, merged, _, _ = step_lib.eval_step(model, eb)
            results.append(fetch([merged, out.type_per_point]))
        return object_metrics(results, objects)

    shift_key = threefry.key(args.seed + 1)       # tools/convergence_run.py:118
    t0 = time.time()
    with open(args.out, "w") as log:
        log.write(header(dev, "gcanet_tpu_torch.convergence_run", argv))
        # fresh batch every step, loaded and copied while a step runs
        batches = prefetch_to_device(train_batches(cfg, args), dev)
        for step in range(args.steps + 1):
            if step % args.eval_every == 0:
                miou, tmiou = evaluate()
                write_row(log, {"step": step, "miou": round(miou, 4),
                                "type_miou": round(tmiou, 4),
                                "t_min": round((time.time() - t0) / 60, 1)})
            if step < args.steps:
                step_lib.train_step(model, optimizer, next(batches),
                                    r1=step_lib.grid_shift(shift_key, step, dev))
    print("done")


if __name__ == "__main__":
    main()
