"""The port's mean shift (``geometry/affinity.py::mean_shift``, torch on the
input's device) against the JAX package's, which is sklearn's
``MeanShift(bandwidth, bin_seeding=False)`` on the host; and the port's
``Predictor(cluster_mode="meanshift")`` against the JAX predictor's
meanshift mode, from the same numpy weights on the same cloud.

Rules: mean-shift labels exactly.  The predictor's floats at rtol=1e-4,
atol=1e-5 (fp32, another summation order), ``conf`` at 3e-2 (the bf16
instance head), the instance list exactly.  The two embeddings differ in
the last bits, and a kNN near-tie can move one point's embedding, so the
labels are held in two exact steps: the port's ``mean_shift`` of the JAX
embedding equals the JAX predictor's sklearn labels, and the port's labels
are the port's ``mean_shift`` of the embedding it returns.  The offset
module runs a channel attention across its sorted key-point similarities,
so two frameworks that order a tie differently give that point other
offsets; the cloud (synthetic seed 2) holds no gap below 1e-6 among them,
which the test checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from joblib import parallel_config

from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.config import GroupingConfig as JGroupingConfig
from gcanet_tpu.config import InstanceHeadConfig as JIHConfig
from gcanet_tpu.geometry.affinity import mean_shift as jmean_shift
from gcanet_tpu.models.primitive_net import PrimitiveNet as JPrimitiveNet
from gcanet_tpu.serve import Predictor as JPredictor
from gcanet_tpu_torch.config import Config, GroupingConfig, InstanceHeadConfig
from gcanet_tpu_torch.data.synthetic import synth_clouds
from gcanet_tpu_torch.geometry import affinity as taff
from gcanet_tpu_torch.models.offset import keypoint_permutation
from gcanet_tpu_torch.ops.mathutil import safe_norm
from gcanet_tpu_torch.serve import Predictor
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from tests.torch_once import once, release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture(autouse=True)
def sequential_sklearn():
    """The JAX ``mean_shift`` fits with ``n_jobs=8``: joblib's sequential
    backend gives the same labels without starting eight worker processes
    per test process."""
    with parallel_config(backend="sequential"):
        yield


def _blobs(rng, b, sizes, dim, spread, scale):
    out = []
    for _ in range(b):
        centres = rng.randn(len(sizes), dim) * scale
        out.append(np.concatenate([c + spread * rng.randn(m, dim) for c, m in zip(centres, sizes)]))
    return np.stack(out).astype(np.float32)


def _hold(x, bandwidth):
    got = taff.mean_shift(torch.from_numpy(x), bandwidth)
    want = jmean_shift(x, bandwidth)
    assert got.dtype == torch.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    return got


@pytest.mark.parametrize("dim", [64, 3])
def test_mean_shift_blobs(dim):
    # F=64 is the embedding's width (sklearn searches by brute force in
    # float64 there), F=3 goes through sklearn's KD tree
    x = _blobs(np.random.RandomState(dim), 2, [40, 30, 20, 15, 10], dim, 0.3 / np.sqrt(dim), 2.0)
    labels = _hold(x, 0.85)
    assert all(len(np.unique(item)) == 5 for item in labels.numpy())


def test_mean_shift_iterates():
    # wide blobs: the seeds move for several iterations before they stop
    x = _blobs(np.random.RandomState(1), 2, [80, 60, 40], 8, 0.45, 3.0)
    _hold(x, 1.2)
    assert taff.mean_shift.iterations > 1


def test_mean_shift_deduplicates(monkeypatch):
    # points spread evenly along a segment: the seeds stop at many nearby
    # means, which the greedy pass thins to centres a bandwidth apart
    seen = []
    greedy = taff._greedy_keep
    monkeypatch.setattr(taff, "_greedy_keep",
                        lambda c, r2: seen.append((len(c), int(greedy(c, r2).sum())))
                        or greedy(c, r2))
    rng = np.random.RandomState(2)
    t = np.sort(rng.rand(2, 150), axis=1) * 4.0
    x = np.stack([t, 0.05 * rng.randn(2, 150), 0.05 * rng.randn(2, 150)], -1).astype(np.float32)
    _hold(x, 0.5)
    assert all(1 < kept < centres for centres, kept in seen), seen


N = 256
SMALL = dict(num_points=N, nn_nb=12, nn_nb_inner=8, offset_knn=6, offset_keypoints=24,
             knn_impl="xla")
# a radius wide enough at N=256 that a proposal reaches get_instances'
# 150-point minimum
GROUP = dict(radius=0.3, similarity_threshold_inst=0.9, class_numpoint_mean=(-1.0,) * 7,
             min_npoint=5)
HEAD = dict(grid_size=8, max_proposals=24)


def _jax_init(model):
    z = jnp.zeros((1, N, 3))
    v = jax.jit(lambda r: model.init({"params": r}, z, z, train=True, rng=r))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.array, (v["params"], v["batch_stats"]))


@pytest.fixture(scope="module")
def predictors(tmp_path_factory):
    cfg = JConfig(**SMALL, grouping=JGroupingConfig(**GROUP), instance_head=JIHConfig(**HEAD))
    model = JPrimitiveNet(cfg)
    params, stats = once(tmp_path_factory, "meanshift_init", lambda: _jax_init(model))
    # the pushes of test_torch_predictor.py, so the instance path keeps instances
    params["OffsetPredModule_0"]["Dense_0"]["kernel"] *= 0.05
    params["InstanceHead_0"]["Dense_0"]["bias"][0] += 10.0
    params["InstanceHead_0"]["MLP_0"]["Dense_1"]["bias"] += 10.0

    # the JAX Predictor around these weights, without its own initialisation
    jpred = object.__new__(JPredictor)
    jpred.cfg, jpred.cluster_mode, jpred.mesh = cfg, "meanshift", None
    jpred.state = type("State", (), {"params": params, "batch_stats": stats})
    jpred._forward = jax.jit(lambda p, s, xyz, nrm: model.apply(
        {"params": p, "batch_stats": s}, xyz, nrm, train=False, rng=jax.random.PRNGKey(0)))
    port_cfg = Config(**SMALL, grouping=GroupingConfig(**GROUP),
                      instance_head=InstanceHeadConfig(**HEAD))
    pred = Predictor(port_cfg, checkpoint=state_dict_from_jax(params, stats), device="cpu",
                     cluster_mode="meanshift")
    xyz, nrm = synth_clouds(port_cfg, 1, seed=2)
    return pred, jpred, xyz[0], nrm[0]


def _keypoint_gap(pred, xyz, nrm) -> float:
    """The least gap between consecutive sorted key-point similarities (the
    k + 1 largest of each point) in the port's offset module on this cloud."""
    block = pred.model.offset_pred_block
    seen = []
    hook = block.register_forward_pre_hook(lambda m, args: seen.append(args[2]))
    with torch.inference_mode():
        pred.model(torch.from_numpy(xyz[None]), torch.from_numpy(nrm[None]))
    hook.remove()
    inst = seen[0]
    sub = torch.as_tensor(keypoint_permutation(inst.shape[1], min(block.sampling_ratio,
                                                                  inst.shape[1])))
    unit = inst / safe_norm(inst, dim=-1, keepdim=True)
    top = torch.topk(unit @ unit[:, sub].transpose(1, 2), block.nn_nb + 1, dim=-1).values
    return float((top[..., :-1] - top[..., 1:]).min())


def test_predictor_meanshift_matches_jax(predictors):
    pred, jpred, xyz, nrm = predictors
    assert _keypoint_gap(pred, xyz, nrm) > 1e-6
    got = pred.predict(xyz, nrm)
    want = JPredictor.predict(jpred, xyz, nrm)
    assert got.keys() == want.keys()
    for key in ("type_per_point", "param_per_point", "pt_offsets", "embedding"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **FP32)
    assert len(want["instances"]) > 0
    assert [(i["label_id"], i["pred_mask"]) for i in got["instances"]] == \
           [(i["label_id"], i["pred_mask"]) for i in want["instances"]]
    np.testing.assert_allclose([i["conf"] for i in got["instances"]],
                               [i["conf"] for i in want["instances"]], **BF16)

    labels = want["instance_labels"]
    assert labels.dtype == np.int64 and 1 < len(np.unique(labels)) < N
    np.testing.assert_array_equal(
        taff.mean_shift(torch.tensor(want["embedding"])[None], pred.cfg.bandwidth)[0], labels)
    assert got["instance_labels"].dtype == np.int64
    np.testing.assert_array_equal(
        taff.mean_shift(torch.tensor(got["embedding"])[None], pred.cfg.bandwidth)[0],
        got["instance_labels"])

    # the batched paths always group, as the JAX package's do
    grouping = Predictor(pred.cfg, checkpoint=pred.model.state_dict(), device="cpu")
    batch = pred.predict_batch(xyz[None], nrm[None])[0]
    np.testing.assert_array_equal(batch["instance_labels"],
                                  grouping.predict(xyz, nrm)["instance_labels"])


def test_unknown_cluster_mode_raises(predictors):
    pred = predictors[0]
    with pytest.raises(ValueError, match="cluster_mode='spectral'"):
        Predictor(pred.cfg, device="cpu", cluster_mode="spectral")
