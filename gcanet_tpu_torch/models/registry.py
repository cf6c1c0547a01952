"""Model registry (port of ``gcanet_tpu/models/registry.py``): ``--model_dict``
names to model constructors, with the JAX package's name table, so
``is_scene_model`` answers as there.

Every name builds: the flagship ``PrimitiveNet`` (``-4``), its dual-attention
variant (``-2``: ``offset_variant="dual"``), the SPP-Net baseline
``PrimitiveNetSPP`` and the SoftGroup scene family.  An unknown name raises
``KeyError``.  SPP-Net is a head-only model (no grouping, no instance head),
so the predictors and trainers refuse it (``check_instance_model``); it
trains through its own head-loss step.
"""

from __future__ import annotations

from typing import Callable, Dict

from gcanet_tpu_torch.config import Config


def _flagship(cfg: Config):
    from gcanet_tpu_torch.models.primitive_net import PrimitiveNet

    return PrimitiveNet(cfg)


def _variant2(cfg: Config):
    from gcanet_tpu_torch.models.primitive_net import PrimitiveNet

    return PrimitiveNet(cfg.replace(offset_variant="dual"))


def _sppnet(cfg: Config):
    from gcanet_tpu_torch.models.sppnet import PrimitiveNetSPP

    return PrimitiveNetSPP(cfg)


def _softgroup_scene(cfg: Config):
    from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet

    return SoftGroupNet(cfg, compute_bf16=bool(cfg.scene_bf16),
                        semantic_only=bool(cfg.semantic_only))


def is_scene_model(model_dict: str) -> bool:
    """True when the dotted model name resolves to the scene family."""
    return _REGISTRY.get(model_dict) is _softgroup_scene


_REGISTRY: Dict[str, Callable] = {
    "gcanet_tpu.models.softgroup_scene": _softgroup_scene,
    "softgroup.model.softgroup": _softgroup_scene,
    "gcanet_tpu.models.primitive_net": _flagship,
    "models.dgcnn-hais-concat-direct-4": _flagship,
    "gcanet_tpu.models.primitive_net_dual": _variant2,
    "models.dgcnn-hais-concat-direct-2": _variant2,
    "gcanet_tpu.models.sppnet": _sppnet,
    "models.sppnet": _sppnet,
}


def check_instance_model(cfg: Config, what: str) -> None:
    """Raise before any work when ``cfg.model_dict`` names SPP-Net, which
    ``what`` (a predictor or trainer) cannot run: it has no grouping or
    instance head and takes no voxel-shift draw.  (The JAX package's
    predictor and trainer fail on it with a ``TypeError`` at
    initialisation.)"""
    if _REGISTRY.get(cfg.model_dict) is _sppnet:
        raise ValueError(f"{what} runs the instance models; model_dict={cfg.model_dict!r} "
                         "is the head-only SPP-Net baseline (embedding, type, normal and "
                         "parameter heads, no grouping or instance head): build it with "
                         "build_model and train it with its head losses")


def build_model(cfg: Config):
    key = cfg.model_dict
    if key not in _REGISTRY:
        raise KeyError(f"unknown model_dict {key!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key](cfg)
