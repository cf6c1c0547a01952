"""Trainer (port of ``gcanet_tpu/train/trainer.py``, one device).

Mirrors ``trainer_new.py``: workspace and log file (:64-83), Adam/SGD with
piecewise learning-rate decay (:98-117, :144-155), checkpoint save and
resume (:120-142), per-epoch training with throughput every 50 batches
(:226-247), evaluation with Hungarian-matched mIoU and type mIoU, periodic
and best-metric checkpoints with pruning (:396-478).  Scalars go to a JSONL
stream.  The data is the ABC dataset when ``<data_path>/<train_dataset>``
exists, else synthetic batches (``data/synthetic.py``) with the JAX
trainer's seeds.
"""

from __future__ import annotations

import csv
import itertools
import json
import logging
import os
import queue
import re
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from gcanet_tpu_torch.config import Config, check_supported, check_trainable
from gcanet_tpu_torch.data.abc_dataset import ABCDataset, shard_bounds
from gcanet_tpu_torch.data.synthetic import synth_batch
from gcanet_tpu_torch.models.registry import build_model
from gcanet_tpu_torch.train import metrics as metric_utils
from gcanet_tpu_torch.train import step as step_lib
from gcanet_tpu_torch.utils.transfer import fetch

LOG_EVERY = 50


class ScalarLogger:
    """Appends ``{"step", "time", **scalars}`` records to
    ``<log_dir>/scalars_<name>.jsonl``."""

    def __init__(self, log_dir: str, name: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"scalars_{name}.jsonl")

    def _append(self, rec: Dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._append(rec)

    def log_histogram(self, name: str, values, step: int, bins: int = 16) -> None:
        """A histogram record: min, max, mean, std and bin counts."""
        v = np.asarray(values).ravel()
        counts, edges = np.histogram(v, bins=bins)
        self._append({"step": int(step), "time": time.time(), "histogram": name,
                      "min": float(v.min()), "max": float(v.max()),
                      "mean": float(v.mean()), "std": float(v.std()),
                      "counts": counts.tolist(), "edges": np.round(edges, 6).tolist()})


def prefetch_to_device(batch_iter: Iterable[Dict], device: torch.device | str,
                       depth: int = 2) -> Iterator[Dict]:
    """Load and copy batches to ``device`` (``step.batch_to_device``) on a
    background thread, ``depth`` ahead of the consumer.  An exception in
    the producer is raised in the consumer; a consumer that stops early
    stops the producer at its next batch."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def producer() -> None:
        try:
            for item in batch_iter:
                if stop.is_set():
                    return
                put(step_lib.batch_to_device(item, device))
            put(end)
        except BaseException as e:          # noqa: BLE001 -- raised in the consumer
            put(e)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _is_device_error(e: Exception) -> bool:
    """A CUDA error (after which the context may be lost) or device OOM."""
    kinds = tuple(k for k in (getattr(torch, "AcceleratorError", None),
                              torch.cuda.CudaError, torch.cuda.OutOfMemoryError) if k)
    return isinstance(e, kinds) or (isinstance(e, RuntimeError) and "cuda" in str(e).lower())


class Trainer:
    """Trains and evaluates the flagship model on one device: ``cuda``
    unless ``device="cpu"`` is asked for; raises when no card is present.
    With ``cfg.eval`` only the model options are checked (the eval step
    honours no training knob).

    A model family's trainer (``scene_trainer.SceneTrainer``) sets ``scene``
    and ``synth`` (its synthetic batch maker) and overrides ``_train_step``,
    ``build_dataloaders`` and ``test_one_epoch``."""

    scene = False
    synth = staticmethod(synth_batch)

    def __init__(self, cfg: Config, device: str | torch.device | None = None):
        (check_supported if cfg.eval else check_trainable)(cfg, scene=self.scene)
        self.cfg = cfg
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer runs on cuda by default and no CUDA device "
                               "is available; pass device='cpu' to run on the CPU")
        if cfg.debug:
            # the reference's set_detect_anomaly(True) (trainer_new.py:212)
            torch.autograd.set_detect_anomaly(True)
        self.eval_errors = 0                # eval objects skipped on an error
        self.build_workspace()
        self.build_dataloaders()
        self.train_viz = ScalarLogger(cfg.log_dir, "train")
        self.test_viz = ScalarLogger(cfg.log_dir, "test")
        self.logger = logging.getLogger("Train")
        self.logger.setLevel(logging.INFO)
        self._log_file = logging.FileHandler(os.path.join(cfg.log_dir, "trainlog.log"))
        self._log_file.setFormatter(logging.Formatter("%(asctime)s---%(message)s"))
        self.logger.addHandler(self._log_file)
        self.build_model_optimizer()

    def close(self) -> None:
        """Detach the log file from the shared ``Train`` logger."""
        self.logger.removeHandler(self._log_file)
        self._log_file.close()

    # ------------------------------------------------------------------ setup
    def build_workspace(self) -> None:
        os.makedirs(self.cfg.log_dir, exist_ok=True)
        self.ckpt_dir = os.path.abspath(
            self.cfg.checkpoint_path or os.path.join(self.cfg.log_dir, "checkpoint"))

    def build_model_optimizer(self) -> None:
        cfg = self.cfg
        self.model = build_model(cfg).to(self.device)
        self.optimizer = step_lib.make_optimizer(cfg, self.model.parameters())
        # draws the voxel grid shifts; on the model's device
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        n_params = sum(p.numel() for p in self.model.parameters())
        print(f"parameters number: {n_params / 1e6:.2f} M")
        self.start_epoch = 0
        if not cfg.not_load_model:
            self.load_checkpoint()

    def build_dataloaders(self) -> None:
        cfg = self.cfg
        train_list = os.path.join(cfg.data_path, cfg.train_dataset)
        if os.path.exists(train_list):
            self.train_data = ABCDataset(cfg.data_path, cfg.train_dataset, cfg,
                                         skip=cfg.train_skip, fold=cfg.train_fold,
                                         training=True)
            self.test_data = ABCDataset(cfg.data_path, cfg.test_dataset, cfg,
                                        skip=cfg.val_skip, training=False)
        else:
            print(f"dataset list {train_list} not found -> synthetic data")
            self.train_data = self.test_data = None

    # ------------------------------------------------------------ checkpoints
    def _ckpt_path(self, tag: str) -> str:
        return os.path.join(self.ckpt_dir, f"{tag}.tar")

    def save_checkpoint(self, epoch: int, tag: str = "latest",
                        metrics: Optional[Dict[str, float]] = None) -> str:
        """``torch.save`` of epoch, metrics, model and optimizer state.  Each
        tag keeps its own epoch.  The model state sits under
        ``model_state_dict``, as in the reference's checkpoints, so
        ``Predictor(cfg, checkpoint=path)`` loads it."""
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = self._ckpt_path(tag)
        torch.save({"epoch": epoch, "metrics": dict(metrics or {}),
                    "model_state_dict": self.model.state_dict(),
                    "optimizer_state_dict": self.optimizer.state_dict()}, path)
        return path

    def load_checkpoint(self, tag: str = "latest") -> None:
        path = self._ckpt_path(tag)
        if not os.path.exists(path):
            return
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model_state_dict"])
        self.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
        self.start_epoch = int(ckpt["epoch"])
        print(f"Successfully Load Model with {self.start_epoch} epoch...")

    def _prune_checkpoints(self, epoch: int) -> None:
        """Keep the ``eval{N}`` checkpoints of epochs ``2**k - 1`` and the two
        most recent saves (softgroup/util/utils.py:88-104)."""
        keep = {epoch, epoch - self.cfg.save_interval}
        e = 1
        while e <= epoch:
            keep.add(e - 1)
            e *= 2
        if not os.path.isdir(self.ckpt_dir):
            return
        for name in os.listdir(self.ckpt_dir):
            m = re.fullmatch(r"eval(\d+)\.tar", name)
            if m and int(m.group(1)) not in keep:
                os.remove(os.path.join(self.ckpt_dir, name))

    # ------------------------------------------------------------------- data
    def _train_batches(self, epoch: int, num_batches: int | None = None):
        """Host batches of one epoch: the dataset shuffled with seed
        ``cfg.seed + epoch`` (its first ``num_batches`` when given), or
        synthetic batches with the JAX trainer's seeds ``(epoch * 1000 + i)
        * world + rank``, ``num_batches`` of them, else ``GCA_SYNTH_BATCHES``
        (32)."""
        cfg = self.cfg
        world, rank = 1, 0
        if self.train_data is not None:
            yield from itertools.islice(
                self.train_data.batches(cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
                                        shard=(rank, world)), num_batches)
            return
        lo, hi = shard_bounds(cfg.batch_size, rank, world)
        if num_batches is None:
            num_batches = int(os.environ.get("GCA_SYNTH_BATCHES", "32"))
        for i in range(num_batches):
            yield self.synth(cfg, hi - lo, seed=(epoch * 1000 + i) * world + rank)

    def _test_batches(self):
        """Batch-1 eval stream: the test list in order, or the 8 synthetic
        clouds of seeds ``90000 + i``."""
        world, rank = 1, 0
        if self.test_data is not None:
            yield from self.test_data.batches(1, shuffle=False, stride=(rank, world))
            return
        for i in range(8):
            if i % world == rank:
                yield self.synth(self.cfg, 1, seed=90000 + i)

    # ------------------------------------------------------------------ loops
    def _set_lr(self, epoch: int) -> float:
        lr = step_lib.lr_for_epoch(self.cfg, epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.train_viz.log_scalars({"lr": lr}, epoch)
        return lr

    def train_one_epoch(self, epoch: int, num_batches: int | None = None
                        ) -> List[Dict[str, torch.Tensor]]:
        """One epoch (``_train_batches``), the next batches loaded and copied
        while a step runs.  Returns every step's metrics as device tensors;
        they are copied to the host only every ``LOG_EVERY`` batches, to log
        them."""
        cfg = self.cfg
        self._set_lr(epoch)
        history: List[Dict[str, torch.Tensor]] = []
        step_t0 = time.time()
        batches = prefetch_to_device(self._train_batches(epoch, num_batches), self.device)
        for batch_idx, batch in enumerate(batches):
            history.append(self._train_step(batch))
            if (batch_idx + 1) % LOG_EVERY == 0:
                window = history[-LOG_EVERY:]
                stat = {k: sum(float(m[k]) for m in window) / LOG_EVERY for k in window[0]}
                stat["example/sec"] = cfg.batch_size * LOG_EVERY / (time.time() - step_t0)
                self.train_viz.log_scalars(stat, (epoch * 10_000 + batch_idx) * cfg.batch_size)
                msg = " ".join(f"{k}: {v:.3f}" for k, v in sorted(stat.items())
                               if k != "example/sec")
                self.logger.info(f"batch {batch_idx + 1}: {msg} "
                                 f"({stat['example/sec']:.2f} ex/s)")
                step_t0 = time.time()
        return history

    def _train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return step_lib.train_step(self.model, self.optimizer, batch, self.generator)

    def test_one_epoch(self, epoch: int):
        """Evaluate every test object: ``eval_step`` on the device, one copy
        of merged labels, types and losses to the host, mIoU and type mIoU
        there.  Writes ``scalars_test.jsonl``, the log line and
        ``output_results.csv`` (and the ``.xyz`` dumps with
        ``resultsSave``).  An object whose evaluation raises is logged,
        counted in ``eval_errors`` and skipped, except on a CUDA error,
        which is raised.  Returns ``(miou, type_miou)`` averaged."""
        cfg = self.cfg
        stat: Dict[str, float] = {}
        cnt = 0
        self._results_rows = []
        for batch in self._test_batches():
            try:
                out, merged_dev, _, ld = step_lib.eval_step(
                    self.model, step_lib.batch_to_device(batch, self.device))
                merged, tpp, *losses = fetch([merged_dev, out.type_per_point[0],
                                              *ld.values()])
            except Exception as e:          # noqa: BLE001 -- trainer_new.py:333-335
                if _is_device_error(e):
                    raise
                self.eval_errors += 1
                self.logger.error(f"error: {batch.get('index', ['?'])[0]}: {e}")
                continue
            i_gt, t_gt = batch["I_gt"][0], batch["T_gt"][0]
            miou = metric_utils.compute_miou(merged, i_gt)
            type_miou = metric_utils.compute_type_miou_abc(tpp, t_gt, merged, i_gt)
            for k, v in dict(zip(ld, losses), miou=miou, type_miou=type_miou).items():
                stat[k] = stat.get(k, 0.0) + float(v)
            if cfg.resultsSave:
                self._save_xyz_dumps(batch, tpp, merged, miou, type_miou)
            self._results_rows.append({
                "ID": batch["index"][0] if "index" in batch else cnt,
                "miou": round(miou, 3), "type_miou": round(type_miou, 3),
            })
            cnt += 1
        avg = {k: v / max(cnt, 1) for k, v in stat.items()}
        self._write_results_csv(epoch, avg)
        self.test_viz.log_scalars(avg, epoch)
        self.logger.info("eval " + " ".join(f"{k}: {v:.4f}" for k, v in sorted(avg.items())))
        return avg.get("miou", 0.0), avg.get("type_miou", 0.0)

    def _save_xyz_dumps(self, batch, type_per_point, merged, miou, type_miou) -> None:
        """Per-object ``.xyz`` dumps: points with predicted and true instance
        and type labels (train_new.py:189-220)."""
        d = os.path.join(self.cfg.log_dir, "results")
        os.makedirs(d, exist_ok=True)
        obj = batch["index"][0] if "index" in batch else "obj"
        xyz = np.asarray(batch["gt_pc"])[0]

        def dump(name, labels):
            np.savetxt(os.path.join(d, f"{obj}_{name}.xyz"),
                       np.column_stack([xyz, labels]), fmt="%.8f")
        dump(f"miou_{miou:.3f}_inc", merged)
        dump(f"typemiou_{type_miou:.3f}_seg", type_per_point.argmax(-1))
        dump("inc_gt", np.asarray(batch["I_gt"])[0])
        dump("seg_gt", np.asarray(batch["T_gt"])[0])

    def _write_results_csv(self, epoch: int, avg: Dict[str, float]) -> None:
        """Per-object rows and the epoch's average (the reference's
        ``.to_excel`` dumps, trainer_new.py:364-377, 447-455)."""
        path = os.path.join(self.cfg.log_dir, "output_results.csv")
        rows = self._results_rows + [dict({"ID": f"Epoch{epoch}"},
                                          **{k: round(v, 4) for k, v in avg.items()})]
        keys = sorted({k for r in rows for k in r})
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)

    def train(self) -> None:
        """Train from ``start_epoch`` to ``max_epoch``: an ``eval{epoch}``
        checkpoint every ``save_interval`` epochs (pruned), and every
        ``eval_interval`` epochs an evaluation, ``latest`` and the
        best-metric checkpoints.  With ``cfg.eval``, evaluate the loaded
        checkpoint once instead."""
        cfg = self.cfg
        if cfg.eval:
            print(f"**** EVAL (epoch {self.start_epoch:03d}) ****")
            self.test_one_epoch(self.start_epoch)
            return
        max_miou, max_type_miou = 0.0, 0.0
        for epoch in range(self.start_epoch, cfg.max_epoch):
            print(f"**** EPOCH {epoch:03d} **** lr {step_lib.lr_for_epoch(cfg, epoch):f}")
            self.train_one_epoch(epoch)
            if epoch % cfg.save_interval == cfg.save_interval - 1:
                self.save_checkpoint(epoch + 1, tag=f"eval{epoch}")
                self._prune_checkpoints(epoch)
            if epoch % cfg.eval_interval == cfg.eval_interval - 1:
                miou, type_miou = self.test_one_epoch(epoch)
                metrics = {"miou": miou, "type_miou": type_miou}
                self.save_checkpoint(epoch + 1, tag="latest", metrics=metrics)
                # the reference's rule, elif included (trainer_new.py)
                if miou >= max_miou:
                    max_miou = miou
                    self.save_checkpoint(epoch + 1, tag="max_miou", metrics=metrics)
                elif type_miou >= max_type_miou:
                    max_type_miou = type_miou
                    self.save_checkpoint(epoch + 1, tag="max_type_miou", metrics=metrics)
