"""The port's CUDA kernels against their plain PyTorch versions, and a tiny
train step, eval step, scene forward and scene train step against the CPU,
on the card.

Needs an NVIDIA GPU; skips without one.  Imports no JAX, so on a machine
without it run it past the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from gcanet_tpu_torch.config import Config, GroupingConfig, InstanceHeadConfig
from gcanet_tpu_torch.data.synthetic import synth_batch, synth_scene_batch
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet
from gcanet_tpu_torch.ops import cc
from gcanet_tpu_torch.serve import ScenePredictor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _graph(n, p, gen):
    a = torch.rand(n, n, generator=gen, device="cuda") < p
    a = torch.triu(a, 1)
    return a | a.t()


@pytest.mark.parametrize("n", [7000, 1001, 17, 1])
def test_sweep_matches_plain(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    for p in (0.0, 1e-3, 0.05):
        a = _graph(n, p, gen)
        labels = torch.randperm(n, generator=gen, device=cuda).to(torch.int32)
        before = cc.masked_min_sweep.launches
        got = cc.masked_min_sweep(a, labels)
        assert cc.masked_min_sweep.launches == before + 1
        torch.testing.assert_close(got, cc.masked_min_sweep_plain(a, labels), rtol=0, atol=0)


def test_sweep_strided_rows_and_uint8(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    base = torch.zeros(1000, 1005, dtype=torch.bool, device=cuda)
    base[:, :1000] = _graph(1000, 0.01, gen)
    nbr = base[:, :1000]
    labels = torch.arange(1000, dtype=torch.int32, device=cuda).flip(0)
    want = cc.masked_min_sweep_plain(nbr, labels)
    torch.testing.assert_close(cc.masked_min_sweep(nbr, labels), want, rtol=0, atol=0)
    torch.testing.assert_close(cc.masked_min_sweep(nbr.to(torch.uint8), labels), want,
                               rtol=0, atol=0)


def test_connected_components_card_equals_cpu(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = _graph(3000, 4e-4, gen)
    i = torch.arange(299, device=cuda)
    a[i, i + 1] = True                       # a 300-chain
    a[i + 1, i] = True
    torch.testing.assert_close(cc.connected_components(a).cpu(),
                               cc.connected_components(a.cpu()), rtol=0, atol=0)


def test_sweep_rejects_cpu_labels_with_cuda_mask(cuda):
    with pytest.raises(ValueError):
        cc.masked_min_sweep(torch.zeros(4, 4, dtype=torch.bool, device=cuda),
                            torch.arange(4, dtype=torch.int32))


@pytest.mark.parametrize("head_bf16", [False, True])
def test_train_step_card_equals_cpu(cuda, head_bf16):
    """One tiny train step on the card and on the CPU from the same weights,
    batch and grid shift, with the card's top-k selections and proposals
    replayed on the CPU (``chip_smoke.train_step_card_vs_cpu``, which
    raises on any loss, gradient or batch statistic out of tolerance)."""
    import chip_smoke

    cfg = Config(num_points=256, batch_size=2, nn_nb=12, nn_nb_inner=8, offset_knn=6,
                 offset_keypoints=24, max_instances=16,
                 grouping=GroupingConfig(radius=0.1, min_npoint=5,
                                         class_numpoint_mean=(-1.0,) * 7,
                                         similarity_threshold_inst=0.9),
                 instance_head=InstanceHeadConfig(grid_size=8, max_proposals=24))
    model = PrimitiveNet(cfg)
    chip_smoke.push_weights(model)
    r1 = torch.rand((2, 3), generator=torch.Generator().manual_seed(0))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        res = chip_smoke.train_step_card_vs_cpu(cfg, model.state_dict(),
                                                synth_batch(cfg, 2, seed=0), r1, head_bf16)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert res["proposals"] > 0


def test_eval_step_card_equals_cpu(cuda):
    """One tiny eval step on the card and on the CPU from the same weights
    and cloud, top-k selections and proposals replayed on the CPU
    (``chip_smoke.eval_step_card_vs_cpu``: losses to phase 7's tolerances,
    merged labels exactly)."""
    import chip_smoke

    cfg = Config(num_points=1024, nn_nb=12, nn_nb_inner=8, offset_knn=6, offset_keypoints=24,
                 max_instances=16,
                 grouping=GroupingConfig(radius=0.05, min_npoint=20,
                                         class_numpoint_mean=(-1.0,) * 7,
                                         similarity_threshold_inst=0.9),
                 instance_head=InstanceHeadConfig(grid_size=8, max_proposals=24))
    model = PrimitiveNet(cfg)
    chip_smoke.push_weights(model)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        res = chip_smoke.eval_step_card_vs_cpu(cfg, model.state_dict(),
                                               synth_batch(cfg, 1, seed=90003))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert res["proposals"] > 0


@pytest.mark.parametrize("bf16", [False, True])
def test_scene_card_equals_cpu(cuda, bf16):
    """A tiny ``ScenePredictor`` model on the card and on the CPU from the
    same pushed weights, proposals replayed on the CPU
    (``chip_smoke.scene_card_vs_cpu``: phase 12's tolerances)."""
    import chip_smoke

    cfg = chip_smoke.scene_config(1024).replace(
        scene_bf16=bf16, instance_head=InstanceHeadConfig(grid_size=8, max_proposals=24))
    model = ScenePredictor(cfg, device="cpu", scene_grid=16).model
    chip_smoke.push_scene_weights(model)
    batch = synth_scene_batch(cfg, 2, seed=0)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        res = chip_smoke.scene_card_vs_cpu(cfg, model.state_dict(), batch["xyz"], batch["feats"],
                                           scene_grid=16)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert res["proposals"] > 0 and res["kept"] > 0


@pytest.mark.parametrize("bf16", [False, True])
def test_scene_train_step_card_equals_cpu(cuda, bf16):
    """A tiny scene train step on the card and on the CPU from the same
    pushed weights, batch and grid shift, proposals replayed on the CPU
    (``chip_smoke.scene_train_card_vs_cpu``: phase 15's tolerances)."""
    import chip_smoke

    cfg = chip_smoke.scene_config(1024).replace(
        batch_size=2, scene_bf16=bf16,
        instance_head=InstanceHeadConfig(grid_size=8, max_proposals=24))
    model = SoftGroupNet(cfg, scene_grid=16)
    chip_smoke.push_scene_weights(model)
    r1 = torch.rand((2, 3), generator=torch.Generator().manual_seed(0))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        res = chip_smoke.scene_train_card_vs_cpu(cfg, model.state_dict(),
                                                 synth_scene_batch(cfg, 2, seed=0), r1, 16)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert res["proposals"] > 0
