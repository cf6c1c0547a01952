"""Trainer, training half (port of ``gcanet_tpu/train/trainer.py``, one
device).

Mirrors ``trainer_new.py``: workspace and log file (:64-83), Adam/SGD with
piecewise learning-rate decay (:98-117, :144-155), checkpoint save and
resume (:120-142), per-epoch training with throughput every 50 batches
(:226-247).  Scalars go to a JSONL stream.  Without the ABC dataset list
the batches are synthetic (``data/synthetic.py::synth_batch``) with the JAX
trainer's seeds.  ``train()`` and ``test_one_epoch`` come with the eval
path; until then they raise.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List

import torch

from gcanet_tpu_torch.config import Config, check_trainable
from gcanet_tpu_torch.data.synthetic import synth_batch
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.train import step as step_lib

LOG_EVERY = 50


class ScalarLogger:
    """Appends ``{"step", "time", **scalars}`` records to
    ``<log_dir>/scalars_<name>.jsonl``."""

    def __init__(self, log_dir: str, name: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"scalars_{name}.jsonl")

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class Trainer:
    """Trains the flagship model on one device: ``cuda`` unless
    ``device="cpu"`` is asked for; raises when no card is present."""

    def __init__(self, cfg: Config, device: str | torch.device | None = None):
        check_trainable(cfg)
        self.cfg = cfg
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer runs on cuda by default and no CUDA device "
                               "is available; pass device='cpu' to run on the CPU")
        self.build_workspace()
        self.build_dataloaders()
        self.train_viz = ScalarLogger(cfg.log_dir, "train")
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
        self.model = PrimitiveNet(cfg).to(self.device)
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
            raise NotImplementedError(
                f"dataset list {train_list} found, but the ABC loader is not ported "
                f"yet (see ROADMAP.md); move it away to train on synthetic data")
        print(f"dataset list {train_list} not found -> synthetic data")

    # ------------------------------------------------------------ checkpoints
    def _ckpt_path(self, tag: str) -> str:
        return os.path.join(self.ckpt_dir, f"{tag}.tar")

    def save_checkpoint(self, epoch: int, tag: str = "latest") -> str:
        """``torch.save`` of epoch, model and optimizer state.  The model
        state sits under ``model_state_dict``, as in the reference's
        checkpoints, so ``Predictor(cfg, checkpoint=path)`` loads it."""
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = self._ckpt_path(tag)
        torch.save({"epoch": epoch,
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

    # ------------------------------------------------------------------- data
    def _train_batches(self, epoch: int, num_batches: int):
        """Synthetic batches with the JAX trainer's seeds,
        ``(epoch * 1000 + i) * world + rank`` with one process."""
        world, rank = 1, 0
        for i in range(num_batches):
            batch = synth_batch(self.cfg, self.cfg.batch_size,
                                seed=(epoch * 1000 + i) * world + rank)
            yield step_lib.batch_to_device(batch, self.device)

    # ------------------------------------------------------------------ loops
    def _set_lr(self, epoch: int) -> float:
        lr = step_lib.lr_for_epoch(self.cfg, epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.train_viz.log_scalars({"lr": lr}, epoch)
        return lr

    def train_one_epoch(self, epoch: int, num_batches: int = 32
                        ) -> List[Dict[str, torch.Tensor]]:
        """``num_batches`` steps (32, the JAX trainer's synthetic epoch).
        Returns every step's metrics as device tensors; they are copied to
        the host only every ``LOG_EVERY`` batches, to log them."""
        cfg = self.cfg
        self._set_lr(epoch)
        history: List[Dict[str, torch.Tensor]] = []
        step_t0 = time.time()
        for batch_idx, batch in enumerate(self._train_batches(epoch, num_batches)):
            history.append(step_lib.train_step(self.model, self.optimizer, batch,
                                               self.generator))
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

    def test_one_epoch(self, epoch: int):
        raise NotImplementedError("the eval path is not ported yet (see ROADMAP.md)")

    def train(self):
        raise NotImplementedError("Trainer.train needs the eval path, which is not "
                                  "ported yet (see ROADMAP.md); call train_one_epoch")
