"""The port's CUDA kernels against their plain PyTorch versions, and a tiny
train step (also at ``precision="bf16"`` and of the dual-attention
variant), eval step, scene forward and scene train step against the CPU,
the reverse-gather backward against the scatter backward, the mean
shift and ``simple_clusters`` against the CPU, a data-parallel step of
two gloo ranks sharing the card against the same two ranks on the CPU, and
the sequence-parallel trunk over shards on the card against the CPU.

Needs an NVIDIA GPU; skips without one.  Imports no JAX, so on a machine
without it run it past the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from gcanet_tpu_torch.config import Config, GroupingConfig, InstanceHeadConfig
from gcanet_tpu_torch.data.synthetic import synth_batch, synth_scene_batch
from gcanet_tpu_torch.geometry.affinity import mean_shift
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet
from gcanet_tpu_torch.ops import cc
from gcanet_tpu_torch.ops import grouping
from gcanet_tpu_torch.ops import knn as knn_ops
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


def test_bf16_step_card_equals_cpu(cuda):
    """``precision="bf16"``: one tiny train step on the card and on the CPU
    (``chip_smoke.train_step_card_vs_cpu``: losses at the bf16 tolerance,
    gradients by cosine)."""
    import chip_smoke

    cfg = Config(num_points=256, batch_size=2, nn_nb=12, nn_nb_inner=8, offset_knn=6,
                 offset_keypoints=24, max_instances=16, precision="bf16",
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
                                                synth_batch(cfg, 2, seed=0), r1, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert res["proposals"] > 0 and res["rest_grad_cosine"] >= 0.9


def test_dual_step_card_equals_cpu(cuda):
    """The dual-attention (``-2``) model: one tiny train step with the
    instance head in fp32 on the card and on the CPU, the card's top-k
    selections (the encoder's and the key-point kNN's) and proposals
    replayed (``chip_smoke.train_step_card_vs_cpu``)."""
    import chip_smoke

    cfg = Config(num_points=256, batch_size=2, nn_nb=12, nn_nb_inner=8, offset_knn=6,
                 offset_keypoints=24, max_instances=16, offset_variant="dual",
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
                                                synth_batch(cfg, 2, seed=0), r1, False)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert res["proposals"] > 0


def test_revgather_matches_scatter_on_card(cuda):
    """The reverse-gather backward with M = the graph's largest in-degree
    against autograd's scatter backward, on a kNN graph: one sum in another
    order (rtol 1e-5, atol 1e-5 of the largest entry)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    b, n, k, c = 2, 2048, 16, 32
    idx = knn_ops.knn_indices(torch.rand(b, n, 3, device=cuda, generator=gen), k)
    m = int(max(torch.bincount(idx[i].flatten(), minlength=n).max() for i in range(b)))
    x = torch.randn(b, n, c, device=cuda, generator=gen, requires_grad=True)
    g = torch.randn(b, n, k, c, device=cuda, generator=gen)
    want = torch.autograd.grad(knn_ops.gather_neighbors(x, idx), x, g)[0]
    got = torch.autograd.grad(knn_ops.gather_neighbors_rev(x, idx, m), x, g)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


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


def test_mean_shift_card_equals_cpu(cuda):
    # blobs of several sizes in the embedding's 64 dimensions, two items
    gen = torch.Generator().manual_seed(0)
    sizes = torch.tensor([700, 500, 300, 200, 100, 60, 40])
    centres = torch.randn(2, len(sizes), 64, generator=gen) * 2.0
    x = centres.repeat_interleave(sizes, dim=1) + 0.04 * torch.randn(2, 1900, 64, generator=gen)
    want = mean_shift(x, 0.85)
    assert [len(torch.unique(w)) for w in want] == [len(sizes)] * 2
    torch.testing.assert_close(mean_shift(x.to(cuda), 0.85).cpu(), want, rtol=0, atol=0)


def test_simple_clusters_card_equals_cpu(cuda):
    # coordinates on a 2**-10 grid: squared distances exact in float32
    gen = torch.Generator().manual_seed(1)
    centres = torch.rand(16, 3, generator=gen) * 0.8 + 0.1
    pts = centres.repeat_interleave(150, 0) + 0.01 * torch.randn(2400, 3, generator=gen)
    pts = torch.round(pts * 1024) / 1024
    sem = torch.arange(16).repeat_interleave(150) % 5
    args = (0.03, 0.3, (200.0, 100.0, 600.0, -1.0))
    before = cc.masked_min_sweep.launches
    got = grouping.simple_clusters(pts.to(cuda), sem.to(cuda), *args)
    assert cc.masked_min_sweep.launches > before
    want = grouping.simple_clusters(pts, sem, *args)
    assert 0 < int(want[1].sum()) < 2400
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)


def test_data_parallel_step_card_equals_cpu(cuda, tmp_path):
    """Two gloo ranks share the card (spawned; NCCL refuses two ranks on one
    card): one tiny data-parallel train step (global B=4, 2 per rank, head
    in fp32) on the card and then on the CPU, the card's top-k and proposals
    replayed, held by ``chip_smoke.dp_step_card_vs_cpu`` at phase 7's
    tolerances; the ranks' weights bit for bit equal."""
    import chip_smoke

    cfg = Config(num_points=256, batch_size=4, mesh_shape="2", nn_nb=12, nn_nb_inner=8,
                 offset_knn=6, offset_keypoints=24, max_instances=16,
                 grouping=GroupingConfig(radius=0.1, min_npoint=5,
                                         class_numpoint_mean=(-1.0,) * 7,
                                         similarity_threshold_inst=0.9),
                 instance_head=InstanceHeadConfig(grid_size=8, max_proposals=24))
    model = PrimitiveNet(cfg)
    chip_smoke.push_weights(model)
    batch = {k: v for k, v in synth_batch(cfg, 4, seed=0).items() if k != "index"}
    r1 = torch.rand((2, 3), generator=torch.Generator().manual_seed(0))
    ranks = chip_smoke.run_ranks(
        [("step", "dp_step_card_vs_cpu",
          dict(cfg=cfg, state=model.state_dict(), batch=batch, r1=r1))], str(tmp_path))
    steps = [r["step"] for r in ranks]
    assert steps[0]["digest"] == steps[1]["digest"]
    assert all(s["launches"] > 0 for s in steps)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_trunk_card_equals_cpu(cuda, d):
    """The sharded trunk over ``["cuda:0"] * d`` (enqueued with no host
    sync: ``torch.cuda.set_sync_debug_mode("error")``) against the same
    shards on the CPU, the card's ring-kNN picks replayed, at
    ``chip_smoke.CARD_VS_CPU_FLOAT``; held by
    ``chip_smoke.sharded_card_vs_cpu``."""
    import chip_smoke

    cfg = Config(num_points=512, nn_nb=16, nn_nb_inner=8)
    model = PrimitiveNet(cfg)
    chip_smoke.push_weights(model)
    errs, own = chip_smoke.sharded_card_vs_cpu(cfg, model.state_dict(),
                                               chip_smoke._seq_cloud(512, 2), d)
    assert len(own) == 3
    assert all(ok for _, ok in errs.values()), errs
