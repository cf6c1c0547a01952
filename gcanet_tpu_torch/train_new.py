"""Train or evaluate the flagship model with the PyTorch port.

    python -m gcanet_tpu_torch.train_new [flags]          # train
    python -m gcanet_tpu_torch.train_new --eval [flags]   # evaluate the latest checkpoint

The flags are the JAX package's (``config.py::build_option``; reference
option_new.py).  It runs on the card; ``main(argv, device="cpu")`` runs it on
the CPU.  Without ``<data_path>/<train_dataset>`` the data is synthetic.
"""

from __future__ import annotations

import sys

import torch

from gcanet_tpu_torch.config import build_option
from gcanet_tpu_torch.models.registry import is_scene_model
from gcanet_tpu_torch.train.trainer import Trainer


def main(argv: list[str] | None = None, device: str | torch.device | None = None) -> int:
    cfg = build_option(argv)
    if is_scene_model(cfg.model_dict):
        raise NotImplementedError(f"model_dict={cfg.model_dict!r}: scene training is not "
                                  f"ported yet; the scene family serves through "
                                  f"serve.py::ScenePredictor (see ROADMAP.md)")
    trainer = Trainer(cfg, device=device)
    try:
        trainer.train()
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
