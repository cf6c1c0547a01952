"""Configuration dataclasses of the PyTorch port.

A copy of ``GroupingConfig``, ``InstanceHeadConfig`` and ``Config`` from the
JAX package's ``config.py``: same field names, same defaults (but for the
dataset's location), so a config built for one package describes the same
model in the other.  The CLI
entry points (``build_option``, ``config_from_namespace``) come with the
trainer's CLI.  ``check_supported`` and ``check_trainable`` refuse the
values whose code paths are not ported yet.
"""

from __future__ import annotations

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
    data_path: str = "data/ABC/"      # relative to the working directory
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


def check_supported(cfg: Config) -> None:
    """Raise on config values whose model code paths are not ported yet."""
    _refuse({
        "mode": cfg.mode != 5,
        "ablation": cfg.ablation,
        "offset_variant": cfg.offset_variant != "kpam",
        "encoder_bf16": cfg.encoder_bf16,
        "shared_graph": cfg.shared_graph,
    }, "model option")


def check_trainable(cfg: Config) -> None:
    """Raise on config values the training path does not honour yet: the
    recomputing backward (``remat``), the reverse-gather backward
    (``edge_backward="revgather:M"``), the bf16 step cast
    (``precision="bf16"``) and data parallelism (``mesh_shape`` > 1)."""
    check_supported(cfg)
    _refuse({
        "remat": cfg.remat,
        "edge_backward": cfg.edge_backward != "scatter",
        "precision": cfg.precision != "fp32",
        "mesh_shape": str(cfg.mesh_shape) not in ("1", ""),
    }, "training option")
