"""The scene family in the PyTorch port against the JAX package:
``SoftGroupNet`` forward (soft grouping, the argmax branch, ``x4_split``,
``semantic_only``) and ``ScenePredictor`` (``predict``, ``predict_batch``,
``predict_stream``), from the same numpy weights carried by the scene
bridge (``state_dict_from_jax(..., family="scene")``) on the same scenes.

Random weights leave grouping idle (a near-uniform softmax never passes
``score_thr``), so the shared weights are pushed: ``semantic_linear``'s
last kernel x3 and +2.0 / +1.5 on the biases of classes 2 and 3 (soft
subsets that overlap), +10 on class 0's ``cls_linear`` bias and on the mask
MLP's last bias (instances clear cls 0.45 and mask -3.0).  The offset
head's last layer is zeroed and the coordinates lie on a 2**-10 grid, so
the shifted coordinates are the inputs and every squared distance is exact
in float32 in both frameworks; the semantic scores are checked to hold no
softmax within 1e-5 of ``score_thr``.  Offsets are compared unzeroed in the
``semantic_only`` case.

Tolerances: semantic scores and offsets rtol 1e-4, atol 1e-5 (fp32 in
another summation order; the U-Net runs in fp32, ``compute_bf16=False``);
proposals, kept instances, masks and semantic predictions exactly; the
instance head's outputs and ``conf`` at rtol = atol = 3e-2, because the JAX
scene model's instance head is always bf16 and the port's is too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.config import GroupingConfig as JGroupingConfig
from gcanet_tpu.config import InstanceHeadConfig as JIHConfig
from gcanet_tpu.config import scene_grouping_defaults as jscene_grouping_defaults
from gcanet_tpu.models.softgroup_scene import SoftGroupNet as JSoftGroupNet
from gcanet_tpu.serve import ScenePredictor as JScenePredictor
from gcanet_tpu.train import scene_step as jscene_step
from gcanet_tpu.train import step as jstep
from gcanet_tpu_torch.config import (Config, GroupingConfig, InstanceHeadConfig,
                                     check_supported, scene_grouping_defaults)
from gcanet_tpu_torch.data.synthetic import synth_scene_batch
from gcanet_tpu_torch.models import registry
from gcanet_tpu_torch.models.softgroup_scene import SoftGroupNet
from gcanet_tpu_torch.serve import ScenePredictor
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

C = 7
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _cfgs(n, b, max_proposals, **kw):
    def make(config, gcfg, ihcfg, defaults):
        return config(num_points=n, batch_size=b, max_instances=16, **kw,
                      grouping=defaults(gcfg(min_npoint=5), (n / 5.0,) * C),
                      instance_head=ihcfg(grid_size=8, max_proposals=max_proposals))

    return (make(JConfig, JGroupingConfig, JIHConfig, jscene_grouping_defaults),
            make(Config, GroupingConfig, InstanceHeadConfig, scene_grouping_defaults))


def _weights(jmodel, b, n, seed, zero_offsets=True):
    """Flax trees of ``jmodel`` (shapes by ``eval_shape``, no compile) filled
    from a numpy seed and pushed as the module docstring says."""
    z = jnp.zeros((b, n, 3))
    shapes = jax.eval_shape(lambda r: jmodel.init({"params": r}, z, z, train=False, rng=r),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        lo, hi = {"scale": (0.8, 1.2), "var": (0.5, 1.5)}.get(name, (-0.1, 0.1))
        return rng.uniform(lo, hi, s.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(fill, shapes["batch_stats"])
    sem = params["semantic_linear"]["Dense_1"]
    sem["kernel"] *= 3.0
    sem["bias"][2] += 2.0
    sem["bias"][3] += 1.5
    if zero_offsets:
        for leaf in params["offset_linear"]["Dense_1"].values():
            leaf[...] = 0.0
    if "instance_head" in params:
        params["instance_head"]["Dense_0"]["bias"][0] += 10.0
        params["instance_head"]["MLP_0"]["Dense_1"]["bias"] += 10.0
    return params, stats


def _scenes(cfg, b, seed):
    batch = synth_scene_batch(cfg, b, seed=seed)
    return np.round(batch["xyz"] * 1024) / 1024, batch["feats"]


def _check_score_margin(logits, thr):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    assert np.abs(e / e.sum(-1, keepdims=True) - thr).min() > 1e-5


def _compare(got, want, proposals=True):
    for name in ("semantic_scores", "pt_offsets"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **FP32)
    if not proposals:
        return
    for field in got.proposals._fields:
        np.testing.assert_array_equal(getattr(got.proposals, field).numpy(),
                                      np.asarray(getattr(want.proposals, field)), err_msg=field)
    for name in ("cls_scores", "iou_scores", "mask_scores"):
        np.testing.assert_allclose(getattr(got.instance, name).numpy(),
                                   np.asarray(getattr(want.instance, name)), err_msg=name, **BF16)


NET_CASES = {
    "soft": dict(b=2, kw={}, x4=False),
    "argmax": dict(b=2, kw=dict(scene_soft_grouping=False), x4=False),
    "x4_split": dict(b=1, kw={}, x4=True),
}


@pytest.mark.parametrize("case", list(NET_CASES))
def test_soft_group_net_matches_jax(case):
    c = NET_CASES[case]
    n, b = 256, c["b"]
    jcfg, cfg = _cfgs(n, b, 48, **c["kw"])
    jmodel = JSoftGroupNet(jcfg, scene_grid=8, channels=8)
    params, stats = _weights(jmodel, b, n, seed=0)
    xyz, feats = _scenes(cfg, b, seed=1)
    want = jax.jit(lambda p, s, x, f: jmodel.apply(
        {"params": p, "batch_stats": s}, x, f, train=False, rng=jax.random.PRNGKey(0),
        x4_split=c["x4"]))(params, stats, xyz, feats)
    _check_score_margin(np.asarray(want.semantic_scores), cfg.grouping.score_thr)

    model = SoftGroupNet(cfg, scene_grid=8, channels=8)
    model.load_state_dict(state_dict_from_jax(params, stats, family="scene"))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(xyz), torch.from_numpy(feats), x4_split=c["x4"])
    pid = got.proposals.point_pid.numpy()
    assert pid.shape == ((5 if case != "argmax" else 2), b * n)
    assert int(got.proposals.num) > 1 and (pid >= 0).any()
    if case == "soft":
        assert ((pid >= 0).sum(0) > 1).any(), "no point in two classes' proposals"
    _compare(got, want)


def test_semantic_only_matches_jax():
    n, b = 256, 2
    jcfg, cfg = _cfgs(n, b, 48, semantic_only=True)
    jmodel = JSoftGroupNet(jcfg, scene_grid=8, channels=8, semantic_only=True)
    params, stats = _weights(jmodel, b, n, seed=2, zero_offsets=False)
    assert "instance_head" not in params
    xyz, feats = _scenes(cfg, b, seed=3)
    want = jax.jit(lambda p, s, x, f: jmodel.apply(
        {"params": p, "batch_stats": s}, x, f, train=False))(params, stats, xyz, feats)
    model = SoftGroupNet(cfg, scene_grid=8, channels=8, semantic_only=True)
    sd = state_dict_from_jax(params, stats, family="scene")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(xyz), torch.from_numpy(feats))
    assert got.proposals is None and got.instance is None
    assert float(np.abs(got.pt_offsets.numpy()).max()) > 1e-3
    _compare(got, want, proposals=False)


def test_registry_and_scene_knobs():
    tiny = Config(num_points=64, model_dict="softgroup.model.softgroup")
    model = registry.build_model(tiny)
    assert isinstance(model, SoftGroupNet) and model.compute_bf16 and model.semantic_only is False
    assert {"input_conv", "unet", "output_layer", "semantic_linear", "offset_linear",
            "instance_head"} == {name for name, _ in model.named_children()}
    model = registry.build_model(tiny.replace(scene_bf16=False, semantic_only=True))
    assert not model.compute_bf16 and not hasattr(model, "instance_head")
    for knob in ("scene_bf16", "semantic_only", "x4_split", "scene_soft_grouping"):
        check_supported(tiny.replace(**{knob: 0}), scene=True)
        with pytest.raises(ValueError, match=knob):
            check_supported(tiny.replace(**{knob: 2}), scene=True)
    check_supported(tiny.replace(encoder_bf16=True), scene=True)      # a flagship knob
    # data-parallel serving takes one device per chunk
    with pytest.raises(ValueError, match="mesh_shape=2.*device=\\[...\\] with 2 devices"):
        ScenePredictor(tiny.replace(mesh_shape="2"), device="cpu")
    pred = ScenePredictor(tiny.replace(mesh_shape="2"), device=["cpu", "cpu"], scene_grid=8)
    assert pred.devices == [torch.device("cpu")] * 2 and pred.replicas == [pred.model] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ScenePredictor(tiny)


@pytest.fixture(scope="module")
def predictors():
    """The JAX ``ScenePredictor`` and the port's, from the same pushed
    weights (channels 32, the predictor's width; scene grid 8), fp32 U-Net."""
    n, b = 1024, 2
    jcfg, cfg = _cfgs(n, b, 16, scene_bf16=False)
    params, stats = _weights(JSoftGroupNet(jcfg, scene_grid=8), b, n, seed=4)
    real = jscene_step.init_scene_state

    def init_from_numpy(cfg_, model, tx, rng):
        return jstep.TrainState(params, stats, tx.init(params), jnp.asarray(0))

    jscene_step.init_scene_state = init_from_numpy
    try:
        jpred = JScenePredictor(jcfg, scene_grid=8)
    finally:
        jscene_step.init_scene_state = real
    pred = ScenePredictor(cfg, checkpoint=state_dict_from_jax(params, stats, family="scene"),
                          device="cpu", scene_grid=8)
    xyz, feats = _scenes(cfg, b, seed=5)
    return jpred, pred, xyz, feats


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["semantic_preds"], w["semantic_preds"])
        np.testing.assert_allclose(g["pt_offsets"], w["pt_offsets"], **FP32)
        assert [(i["label_id"], i["npoint"], i["pred_mask"]) for i in g["instances"]] == \
               [(i["label_id"], i["npoint"], i["pred_mask"]) for i in w["instances"]]
        np.testing.assert_allclose([i["conf"] for i in g["instances"]],
                                   [i["conf"] for i in w["instances"]], **BF16)
        np.testing.assert_array_equal(g["instance_labels"], w["instance_labels"])


def test_scene_predictor_matches_jax(predictors):
    jpred, pred, xyz, feats = predictors
    want = jpred.predict_batch(xyz, feats)
    got = pred.predict_batch(xyz, feats)
    assert all(len(r["instances"]) > 0 for r in got), "a scene kept no instance"
    assert all(r["semantic_preds"].shape == (xyz.shape[1],) for r in got)
    _same_results(got, want)
    _same_results([pred.predict(xyz[1], feats[1])], [jpred.predict(xyz[1], feats[1])])

    stream = list(pred.predict_stream([(xyz, feats), (xyz[::-1], feats[::-1]), (xyz, feats)],
                                      depth=2))
    assert len(stream) == 6
    _same_results(stream[:2], got)
    _same_results(stream[4:], got)
    _same_results(stream[2:4], jpred.predict_batch(xyz[::-1], feats[::-1]))
