"""Train or evaluate a model with the PyTorch port: the flagship, or the
SoftGroup scene family when ``--model_dict`` names it
(``softgroup.model.softgroup``).

    python -m gcanet_tpu_torch.train_new [flags]          # train
    python -m gcanet_tpu_torch.train_new --eval [flags]   # evaluate the latest checkpoint

The flags are the JAX package's (``config.py::build_option``; reference
option_new.py).  It runs on the card; ``main(argv, device="cpu")`` runs it on
the CPU.  Without ``<data_path>/<train_dataset>`` the data is synthetic.
Data-parallel over N cards, one process each:

    torchrun --nproc_per_node N -m gcanet_tpu_torch.train_new --mesh_shape N [flags]

(the group comes from the launcher's environment, ``parallel/dist.py::
maybe_init_from_env``; rank r runs on ``cuda:r``).
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist

from gcanet_tpu_torch.config import build_option
from gcanet_tpu_torch.models.registry import is_scene_model
from gcanet_tpu_torch.parallel.dist import maybe_init_from_env
from gcanet_tpu_torch.train.scene_trainer import SceneTrainer
from gcanet_tpu_torch.train.trainer import Trainer


def main(argv: list[str] | None = None, device: str | torch.device | None = None) -> int:
    cfg = build_option(argv)
    joined = maybe_init_from_env()
    try:
        trainer = (SceneTrainer if is_scene_model(cfg.model_dict) else Trainer)(
            cfg, device=device)
        try:
            trainer.train()
        finally:
            trainer.close()
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
