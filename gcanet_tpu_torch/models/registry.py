"""Model registry (port of ``gcanet_tpu/models/registry.py``): ``--model_dict``
names to model constructors, with the JAX package's name table, so
``is_scene_model`` answers as there.

The flagship and the SoftGroup scene family are ported; every other known
name raises ``NotImplementedError``, and an unknown name raises ``KeyError``.
"""

from __future__ import annotations

from typing import Callable, Dict

from gcanet_tpu_torch.config import Config


def _flagship(cfg: Config):
    from gcanet_tpu_torch.models.primitive_net import PrimitiveNet

    return PrimitiveNet(cfg)


def _unported(what: str) -> Callable:
    def build(cfg: Config):
        raise NotImplementedError(f"model_dict={cfg.model_dict!r} ({what}) is not "
                                  f"ported yet (see ROADMAP.md)")
    return build


_variant2 = _unported("PrimitiveNet with the dual-attention offset module")
_sppnet = _unported("the SPP-Net baseline")


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


def build_model(cfg: Config):
    key = cfg.model_dict
    if key not in _REGISTRY:
        raise KeyError(f"unknown model_dict {key!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key](cfg)
