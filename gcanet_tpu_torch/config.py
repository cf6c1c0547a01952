"""Configuration dataclasses of the PyTorch port.

A copy of ``GroupingConfig``, ``InstanceHeadConfig``, ``Config`` and the CLI
(``build_option``, ``config_from_namespace``) from the JAX package's
``config.py``: same field names, same defaults, same flags, so one argv gives
the same config in both packages.  ``check_supported`` and
``check_trainable`` refuse the values whose code paths are not ported yet
(each with ``scene=True`` for the SoftGroup scene family);
the CLI parses them and leaves the refusal to the entry points.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple


@dataclasses.dataclass
class GroupingConfig:
    """Instance-grouping constants (reference: dgcnn-hais-concat-direct-4.py:1138-1163)."""

    radius: float = 0.03
    similarity_threshold_inst: float = 0.989
    similarity_threshold_para: float = 0.0
    mean_active: int = 300
    npoint_thr: float = 0.15
    score_thr: float = 0.45
    min_npoint: int = 50              # per-class minimum point count to attempt grouping
    # per-class mean instance sizes of the HAIS fragment/primary split
    # (hierarchical_aggregation.cpp:7-8)
    class_numpoint_mean: Tuple[float, ...] = (
        -1.0, -1.0, 3917.0, 12056.0, 2303.0, 8331.0, 3948.0, 3166.0, 5629.0, 11719.0)
    ignore_classes: Tuple[int, ...] = ()
    low_frac: float = 0.05            # kept-fragment lower bound
    high_frac: float = 0.3            # primary threshold
    set_aggr_r_coeff: float = 0.01    # r_set = coeff * sqrt(primary_npoint)
    # strict-parity caps of the reference's CUDA buffers (0 = uncapped)
    neighbor_cap: int = 0
    absorb_fragment_cap: int = 0
    absorb_point_cap: int = 0
    cc_max_iters: int = 64            # label-propagation budget for connected components
    # accepted for config compatibility; the port has one CC implementation
    # (ops/cc.py) and one per-item loop
    cc_impl: str = "auto"
    item_batch_mode: str = "map"


def scene_grouping_defaults(base: GroupingConfig | None = None,
                            class_numpoint_mean: Tuple[float, ...] | None = None
                            ) -> GroupingConfig:
    """Scene-family grouping constants (the SoftGroup scannetv2 recipe):
    ``score_thr`` 0.2, ``npoint_thr`` 0.05, classes 0/1 not grouped.

    The keep rule is ``size >= npoint_thr * mean`` per class, so the mean
    table must match the data's instance scale: ``class_numpoint_mean``
    replaces ``base``'s (the synthetic scenes pass ``num_points / 5``).  A
    ``-1`` mean degrades the rule to the raw 0.05, which keeps every
    singleton cluster and fills ``max_proposals`` with them.
    """
    kw = {}
    if class_numpoint_mean is not None:
        kw["class_numpoint_mean"] = tuple(class_numpoint_mean)
    return dataclasses.replace(base if base is not None else GroupingConfig(),
                               score_thr=0.2, npoint_thr=0.05, ignore_classes=(0, 1), **kw)


@dataclasses.dataclass
class InstanceHeadConfig:
    """Dense masked 3-D U-Net instance head (reference: dgcnn-4.py:611-615, 1300-1392)."""

    grid_size: int = 16
    channels: int = 64
    max_proposals: int = 100
    bn_eps: float = 1e-4
    bn_momentum: float = 0.1


@dataclasses.dataclass
class Config:
    """Full framework config; field names follow option_new.py where they overlap."""

    # --- data parameters ---
    num_primitives: int = 7
    mode: int = 5                     # 5: xyz+normal input (the port's only mode)
    ablation: bool = False
    using_set_aggr: bool = False
    model_dict: str = "models.dgcnn-hais-concat-direct-4"
    checkpoint_path: str | None = None
    log_dir: str = "log/gcanet"
    resultsSave: bool = False
    val_skip: int = 5
    train_skip: int = 1
    data_path: str = "/opt/data/common/ABC/"   # the reference's option_new.py default
    dataset: str = "ABC"
    train_dataset: str = "train_data.txt"
    test_dataset: str = "test_data.txt"
    batch_size: int = 3
    eval: bool = False
    debug: bool = False
    MEAN_SHIFT_STEP: int = 5

    # --- training parameters ---
    max_epoch: int = 200
    learning_rate: float = 1e-3
    optimizer: str = "adam"
    weight_decay: float = 0.0
    momentum: float = 0.9
    lr_decay_steps: str = "20,30,40"
    lr_decay_rates: str = "0.1,0.1,0.1"
    lr_decay_rate: float = 0.1
    loss_class: str = "frpn"          # f: embedding, r: type+offset+instance, p: param, n: normal
    train_fold: int = 1
    eval_interval: int = 1
    save_interval: int = 2
    augment: int = 0
    if_normal_noise: int = 0

    # --- model parameters ---
    not_load_model: bool = False
    sigma: float = 0.8
    normal_sigma: float = 0.1
    out_dim: int = 64
    type_weight: float = 2.0
    param_weight: float = 0.1
    normal_weight: float = 1.0
    edge_knn: int = 50
    feat_ent_weight: float = 1.70
    dis_ent_weight: float = 1.10
    edge_ent_weight: float = 1.23
    topK: int = 10
    edge_topK: int = 12
    bandwidth: float = 0.85
    backbone: str = "DGCNN"

    # --- static-shape / implementation knobs ---
    num_points: int = 7000
    nn_nb: int = 48                   # encoder graph degree K
    offset_knn: int = 30
    offset_keypoints: int = 120
    offset_variant: str = "kpam"
    max_instances: int = 80
    precision: str = "fp32"
    # "approx[:R]" (the JAX default, a TPU-only primitive) maps to exact
    # top-k in the port, the same as "xla" (ops/knn.py)
    knn_impl: str = "approx"
    encoder_bf16: bool = False
    # backward knobs: serving ignores them; training refuses all but the
    # defaults (check_trainable)
    remat: bool = False
    edge_backward: str = "scatter"
    shared_graph: bool = False
    nn_nb_inner: int = 32             # graph degree of edge convs 2-3 (0 = nn_nb)
    mesh_shape: str = "1"
    seed: int = 0
    eval_min_npoint: int = 0
    scene_bf16: bool = True
    semantic_only: bool = False
    fixed_modules: str = ""
    x4_split: bool = False
    scene_soft_grouping: bool = True

    grouping: GroupingConfig = dataclasses.field(default_factory=GroupingConfig)
    instance_head: InstanceHeadConfig = dataclasses.field(default_factory=InstanceHeadConfig)

    @property
    def lr_decay_step_list(self) -> Tuple[int, ...]:
        return tuple(int(x) for x in str(self.lr_decay_steps).split(","))

    @property
    def lr_decay_rate_list(self) -> Tuple[float, ...]:
        return tuple(float(x) for x in str(self.lr_decay_rates).split(","))

    @property
    def input_channels(self) -> int:
        return 6 if self.mode == 5 else 3

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _refuse(unported: dict[str, bool], what: str) -> None:
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"{what} not ported yet: {', '.join(bad)} "
                                  f"(see ROADMAP.md)")


def check_supported(cfg: Config, scene: bool = False) -> None:
    """Raise on config values whose model code paths are not ported yet: the
    flagship's knobs for ``PrimitiveNet``; for ``SoftGroupNet``
    (``scene=True``) the scene knobs must each be 0 or 1."""
    if scene:
        for name in ("scene_bf16", "semantic_only", "x4_split", "scene_soft_grouping"):
            if getattr(cfg, name) not in (0, 1):
                raise ValueError(f"{name} must be 0 or 1, got {getattr(cfg, name)!r}")
        return
    _refuse({
        "mode": cfg.mode != 5,
        "ablation": cfg.ablation,
        "offset_variant": cfg.offset_variant != "kpam",
        "encoder_bf16": cfg.encoder_bf16,
        "shared_graph": cfg.shared_graph,
    }, "model option")


def check_trainable(cfg: Config, scene: bool = False) -> None:
    """Raise on config values the training path does not honour yet: the
    recomputing backward (``remat``), the reverse-gather backward
    (``edge_backward="revgather:M"``), the bf16 step cast
    (``precision="bf16"``) and data parallelism (``mesh_shape`` > 1).  The
    scene step (``scene=True``) reads none of the first three, as in the
    JAX package, and refuses only ``mesh_shape`` > 1."""
    check_supported(cfg, scene=scene)
    if scene:
        _refuse({"mesh_shape": str(cfg.mesh_shape) not in ("1", "")}, "training option")
        return
    _refuse({
        "remat": cfg.remat,
        "edge_backward": cfg.edge_backward != "scatter",
        "precision": cfg.precision != "fp32",
        "mesh_shape": str(cfg.mesh_shape) not in ("1", ""),
    }, "training option")


def _add_args(parser: argparse.ArgumentParser) -> None:
    """Register every option_new.py flag plus the JAX package's extras, with
    the same names, types and defaults.  ``--vis``, ``--vis_dir``,
    ``--optimize``, ``--gpu`` and ``--bn_decay_*`` are parsed and ignored,
    as there."""
    c = Config()
    p = parser.add_argument
    p("--num_primitives", type=int, default=c.num_primitives)
    p("--mode", type=int, default=c.mode)
    p("--ablation", type=bool, default=c.ablation)
    p("--using_set_aggr", type=bool, default=c.using_set_aggr)
    p("--model_dict", type=str, default=c.model_dict)
    p("--checkpoint_path", default=c.checkpoint_path)
    p("--log_dir", default=c.log_dir)
    p("--resultsSave", type=bool, default=c.resultsSave)
    p("--val_skip", type=int, default=c.val_skip)
    p("--train_skip", type=int, default=c.train_skip)
    p("--data_path", type=str, default=c.data_path)
    p("--dataset", type=str, default=c.dataset)
    p("--train_dataset", type=str, default=c.train_dataset)
    p("--test_dataset", type=str, default=c.test_dataset)
    p("--batch_size", type=int, default=c.batch_size)
    p("--vis", action="store_true")
    p("--vis_dir", type=str, default=None)
    p("--eval", action="store_true")
    p("--debug", action="store_true")
    p("--MEAN_SHIFT_STEP", type=int, default=c.MEAN_SHIFT_STEP)
    p("--max_epoch", type=int, default=c.max_epoch)
    p("--learning_rate", type=float, default=c.learning_rate)
    p("--optimizer", type=str, default=c.optimizer)
    p("--weight_decay", type=float, default=c.weight_decay)
    p("--momentum", type=float, default=c.momentum)
    p("--bn_decay_step", type=int, default=20)
    p("--bn_decay_rate", type=float, default=0.5)
    p("--lr_decay_steps", default=c.lr_decay_steps)
    p("--lr_decay_rates", default=c.lr_decay_rates)
    p("--lr_decay_rate", type=float, default=c.lr_decay_rate)
    p("--loss_class", type=str, default=c.loss_class)
    p("--train_fold", type=int, default=c.train_fold)
    p("--eval_interval", type=int, default=c.eval_interval)
    p("--save_interval", type=int, default=c.save_interval)
    p("--augment", type=int, default=c.augment)
    p("--if_normal_noise", type=int, default=c.if_normal_noise)
    p("--optimize", type=int, default=0)
    p("--gpu", type=str, default="0")
    p("--not_load_model", action="store_true")
    p("--sigma", type=float, default=c.sigma)
    p("--normal_sigma", type=float, default=c.normal_sigma)
    p("--out_dim", type=int, default=c.out_dim)
    p("--type_weight", type=float, default=c.type_weight)
    p("--param_weight", type=float, default=c.param_weight)
    p("--normal_weight", type=float, default=c.normal_weight)
    p("--edge_knn", type=int, default=c.edge_knn)
    p("--feat_ent_weight", type=float, default=c.feat_ent_weight)
    p("--dis_ent_weight", type=float, default=c.dis_ent_weight)
    p("--edge_ent_weight", type=float, default=c.edge_ent_weight)
    p("--topK", type=int, default=c.topK)
    p("--edge_topK", type=int, default=c.edge_topK)
    p("--bandwidth", type=float, default=c.bandwidth)
    p("--backbone", type=str, default=c.backbone)
    # static-shape and implementation extras of the JAX package
    p("--num_points", type=int, default=c.num_points)
    p("--nn_nb", type=int, default=c.nn_nb)
    p("--max_instances", type=int, default=c.max_instances)
    p("--precision", type=str, default=c.precision)
    p("--knn_impl", type=str, default=c.knn_impl)
    p("--encoder_bf16", type=int, default=int(c.encoder_bf16))
    p("--edge_backward", type=str, default=c.edge_backward)
    p("--shared_graph", type=int, default=int(c.shared_graph))
    p("--nn_nb_inner", type=int, default=c.nn_nb_inner)
    p("--mesh_shape", type=str, default=c.mesh_shape)
    p("--seed", type=int, default=c.seed)
    p("--eval_min_npoint", type=int, default=c.eval_min_npoint)
    p("--scene_bf16", type=int, default=int(c.scene_bf16))
    p("--semantic_only", type=int, default=int(c.semantic_only))
    p("--fixed_modules", type=str, default=c.fixed_modules)
    p("--x4_split", type=int, default=int(c.x4_split))
    p("--scene_soft_grouping", type=int, default=int(c.scene_soft_grouping),
      help="scene family: 1 = soft per-class subsets; 0 = argmax partition")
    p("--ignore_classes", type=str, default="",
      help="scene family: comma-separated class ids excluded from grouping")
    p("--max_proposals", type=int, default=c.instance_head.max_proposals,
      help="train-time proposal cap (reference: 200)")
    p("--strict_caps", type=int, default=0,
      help="the reference's CUDA grouping buffer caps (3000 neighbours; "
           "1000 fragments / 3000 absorbed points per primary)")


def config_from_namespace(ns: argparse.Namespace) -> Config:
    c = Config()
    fields = {f.name for f in dataclasses.fields(Config)}
    c = c.replace(**{k: v for k, v in vars(ns).items() if k in fields and v is not None})
    mp = getattr(ns, "max_proposals", None)
    if mp is not None and mp != c.instance_head.max_proposals:
        c = c.replace(instance_head=dataclasses.replace(c.instance_head, max_proposals=mp))
    if getattr(ns, "strict_caps", 0):
        c = c.replace(grouping=dataclasses.replace(
            c.grouping, neighbor_cap=3000, absorb_fragment_cap=1000, absorb_point_cap=3000))
    from gcanet_tpu_torch.models.registry import is_scene_model

    if is_scene_model(c.model_dict):
        c = c.replace(grouping=scene_grouping_defaults(c.grouping))
    ig = getattr(ns, "ignore_classes", "") or ""
    if ig.strip():
        c = c.replace(grouping=dataclasses.replace(
            c.grouping, ignore_classes=tuple(int(x) for x in ig.split(",") if x.strip())))
    return c.replace(scene_soft_grouping=bool(c.scene_soft_grouping))


def build_option(argv: list[str] | None = None) -> Config:
    """Parse ``argv`` (default ``sys.argv[1:]``) into a ``Config``, as
    option_new.py's ``build_option``."""
    parser = argparse.ArgumentParser()
    _add_args(parser)
    return config_from_namespace(parser.parse_args(argv))
