"""The model variants of the PyTorch port against the JAX package: the
dual-attention ``-2`` model (``offset_variant="dual"``,
``models/offset_dual.py``) alone and inside ``PrimitiveNet``, forward and
train step, through the registry, ``Predictor``, ``Trainer`` and the CLI;
SPP-Net (``models/sppnet.py``) and its head-loss step; and the rule tables
of both and of SplineNet against the JAX ``import_torch`` key map.

Sizes: N=160, B=2, K=12, 20 key points, P=24, grid 8.  Weights are seeded
numpy draws into the shapes of the JAX trees (``jax.eval_shape``), pushed as
in ``tests/test_torch_knobs.py`` so the instance path works.  The dual
module orders each point's key points by distance and applies a Dense
across that order, so the inputs are checked to hold no distance gap below
1e-6 between a point's key points (the synthetic batches of seeds 3, 4 and
5 hold none; seed 0's has one of 4.5e-8).

Tolerances: fp32 floats rtol 1e-4, atol 1e-5; losses rtol 1e-5, atol 1e-6;
gradients rtol 1e-4, atol 1e-5 of the largest entry; new batch statistics
rtol 1e-5, atol 1e-6; proposals and merged labels exact.  The step is held
with the instance head in fp32 on both sides; the port's step with its bf16
head is held against it at 3e-2 (losses) and by gradient cosine >= 0.9.
SPP-Net's Adam step: parameters whose gradient exceeds 1e-6 in magnitude
rtol 1e-5, atol 1e-6, the others within 2 learning rates (Adam divides by
the gradient's own size there: a gradient that cancels to 0 in one
framework and to 1e-9 in the other moves its weight by 0 or 0.09 lr).
"""

import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gcanet_tpu.models.primitive_net as jpn
from gcanet_tpu.config import Config as JConfig
from gcanet_tpu.config import GroupingConfig as JGroupingConfig
from gcanet_tpu.config import InstanceHeadConfig as JIHConfig
from gcanet_tpu.data.synthetic import synth_batch as jsynth_batch
from gcanet_tpu.losses import losses as JL
from gcanet_tpu.models.instance_head import InstanceHead as JInstanceHead
from gcanet_tpu.models.layers import MLP as JMLP
from gcanet_tpu.models.offset import keypoint_permutation
from gcanet_tpu.models.offset_dual import OffsetPredModuleDual as JDual
from gcanet_tpu.models.sppnet import PrimitiveNetSPP as JSPP
from gcanet_tpu.models.splinenet import DGCNNControlPoints as JSpline
from gcanet_tpu.train import instances as jinst
from gcanet_tpu.train import step as jstep
from gcanet_tpu.utils import import_torch
from gcanet_tpu_torch.config import (Config, GroupingConfig, InstanceHeadConfig,
                                     check_supported, check_trainable)
from gcanet_tpu_torch.models import registry
from gcanet_tpu_torch.models.offset_dual import OffsetPredModuleDual
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.models.splinenet import DGCNNControlPoints
from gcanet_tpu_torch.models.sppnet import PrimitiveNetSPP, head_losses
from gcanet_tpu_torch.serve import Predictor
from gcanet_tpu_torch.train import instances as tinst
from gcanet_tpu_torch.train import step as tstep
from gcanet_tpu_torch.train.trainer import Trainer
from gcanet_tpu_torch.train_new import main
from gcanet_tpu_torch.utils import from_jax, threefry
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from test_torch_knobs import _jax_train_step, _port_grads
from tests import torch_init_law as law
from tests.torch_once import once, release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

N, B = 160, 2
TINY = dict(num_points=N, batch_size=B, nn_nb=12, nn_nb_inner=8, offset_knn=6,
            offset_keypoints=20, max_instances=16, knn_impl="xla")
GROUP = dict(radius=0.1, min_npoint=5, cc_max_iters=32, class_numpoint_mean=(-1.0,) * 7,
             similarity_threshold_inst=0.9)
HEAD = dict(grid_size=8, max_proposals=24)
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
LOSS = dict(rtol=1e-5, atol=1e-6)
STATS = dict(rtol=1e-5, atol=1e-6)
OUTPUTS = ("type_per_point", "param_per_point", "semantic_scores", "embedding", "pt_offsets")
DUAL = "models.dgcnn-hais-concat-direct-2"


def _jcfg(**kw):
    return JConfig(**TINY, grouping=JGroupingConfig(**GROUP), instance_head=JIHConfig(**HEAD),
                   **kw)


def _tcfg(**kw):
    return Config(**TINY, grouping=GroupingConfig(**GROUP),
                  instance_head=InstanceHeadConfig(**HEAD), **kw)


def _fill(shapes, seed):
    """Seeded numpy weights in a tree of shapes: kernels N(0, 1/fan_in),
    norm scales and BN variances U(0.5, 1.5), the rest N(0, 0.01)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            w = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            w = rng.uniform(0.5, 1.5, s.shape)
        else:
            w = 0.1 * rng.standard_normal(s.shape)
        return w.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.cache
def _dual_weights():
    """The dual model's weights, pushed: small offsets, +10 on the head's
    class-0 bias, every mask logit near 2.  Shared; not written to."""
    z = jnp.zeros((1, N, 3))
    shapes = jax.eval_shape(lambda r: jpn.PrimitiveNet(_jcfg(offset_variant="dual")).init(
        {"params": r}, z, z, train=True, rng=r), jax.random.PRNGKey(0))
    params, stats = _fill(shapes["params"], 0), _fill(shapes["batch_stats"], 1)
    params["OffsetPredModuleDual_0"]["Dense_0"]["kernel"] *= 0.05
    head = params["InstanceHead_0"]
    head["Dense_0"]["bias"][0] += 10.0
    head["MLP_0"]["Dense_1"]["bias"] += 2.0
    head["MLP_0"]["Dense_1"]["kernel"] *= 0.01
    return params, stats


def _batch(cfg, seed=3):
    batch = {k: v for k, v in jsynth_batch(cfg, B, seed=seed).items() if k != "index"}
    xyz = batch["gt_pc"]
    sub = keypoint_permutation(N, cfg.offset_keypoints)
    d = np.sort(((xyz[:, :, None].astype(np.float64) - xyz[:, None, sub]) ** 2).sum(-1), -1)
    assert np.diff(d, axis=-1).min() > 1e-6, "near-tie between key point distances"
    return batch


# ---------------------------------------------------------------- the module


def _module_rules():
    """The dual module's rows of the flagship table, relative to the module."""
    return [(p[len("offset_pred_block."):], f[1:], kind, bias)
            for p, f, kind, bias in from_jax.build_rules(5, dual=True)
            if p.startswith("offset_pred_block.")]


@pytest.mark.parametrize("nn_nb", [8, 60], ids=["k8_of_20", "k60_capped_at_20"])
def test_dual_module_matches_jax(nn_nb, monkeypatch):
    """``OffsetPredModuleDual`` alone: offsets and the gradients of every
    weight and input under a random cotangent; k=60 > 20 key points takes
    all of them, ordered."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    feat = rng.standard_normal((B, N, 128)).astype(np.float32)
    sem = rng.standard_normal((B, N, 7)).astype(np.float32)
    inst = rng.standard_normal((B, N, 16)).astype(np.float32)
    cot = rng.standard_normal((B, N, 3)).astype(np.float32)
    jmod = JDual(nn_nb, 20)
    params = _fill(jax.eval_shape(lambda r: jmod.init(r, *map(jnp.asarray, (pts, feat, sem,
                                                                            inst))),
                                  jax.random.PRNGKey(0))["params"], 3)

    @jax.jit
    def run(p, *x):
        out, vjp = jax.vjp(lambda p_, a, f, i: jmod.apply({"params": p_}, a, f, jnp.asarray(sem),
                                                          i), p, *x)
        return out, vjp(jnp.asarray(cot))

    want, (gp, *gx) = jax.tree.map(np.asarray, run(params, pts, feat, inst))
    monkeypatch.setattr(from_jax, "_rules", lambda family, params=None: _module_rules())
    tmod = OffsetPredModuleDual(nn_nb, 20)
    tmod.load_state_dict(state_dict_from_jax(params, None))
    xs = [torch.from_numpy(a).requires_grad_() for a in (pts, feat, inst)]
    got = tmod(xs[0], xs[1], torch.from_numpy(sem), xs[2])
    np.testing.assert_allclose(got.detach().numpy(), want, **FP32)
    got.backward(torch.from_numpy(cot))
    wgrads = {k: v.numpy() for k, v in state_dict_from_jax(gp, None).items()}
    wgrads.update(points=gx[0], feature=gx[1], instance_feature=gx[2])
    tgrads = dict({k: p.grad.numpy() for k, p in tmod.named_parameters()},
                  points=xs[0].grad.numpy(), feature=xs[1].grad.numpy(),
                  instance_feature=xs[2].grad.numpy())
    assert set(tgrads) == set(wgrads)
    floor = 1e-5 * max(np.abs(v).max() for v in wgrads.values())
    for k, w in wgrads.items():
        np.testing.assert_allclose(tgrads[k], w, rtol=1e-4, atol=floor, err_msg=k)


# ---------------------------------------------------------------- the model


def test_dual_forward_matches_jax(monkeypatch):
    """The dual ``PrimitiveNet`` in eval mode (set aggregation on), both
    instance heads in fp32: every output, the proposals and the merged
    instance labels of ``merged_labels_device`` (an instance of 5 points
    kept: 160-point clouds hold no instance of the default 150)."""
    params, stats = _dual_weights()
    jcfg = _jcfg(offset_variant="dual")
    batch = _batch(jcfg, seed=4)
    xyz, nrm = batch["gt_pc"], batch["gt_normal"]
    monkeypatch.setattr(jpn, "InstanceHead", functools.partial(
        JInstanceHead, compute_bf16=False, name="InstanceHead_0"))

    @jax.jit
    def run(p, s, a, n_):
        out = jpn.PrimitiveNet(jcfg).apply({"params": p, "batch_stats": s}, a, n_, train=False)
        ih = out.instance
        return out, jinst.merged_labels_device(out.proposals.point_pid, ih.cls_scores,
                                               ih.iou_scores, ih.mask_scores,
                                               out.proposals.valid, jcfg.num_primitives,
                                               min_npoint=5)

    want, jmerged = jax.tree.map(np.asarray, run(params, stats, xyz, nrm))
    model = registry.build_model(_tcfg(model_dict=DUAL))
    assert isinstance(model.offset_pred_block, OffsetPredModuleDual)
    model.load_state_dict(state_dict_from_jax(params, stats))
    model.instance_head.compute_bf16 = False
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(xyz), torch.from_numpy(nrm))
        ih = got.instance
        merged = tinst.merged_labels_device(got.proposals.point_pid, ih.cls_scores,
                                            ih.iou_scores, ih.mask_scores,
                                            got.proposals.valid, 7, min_npoint=5)
    for field in OUTPUTS:
        np.testing.assert_allclose(getattr(got, field).numpy(), getattr(want, field),
                                   err_msg=field, **FP32)
    for field, g, w in zip(got.proposals._fields, got.proposals, want.proposals):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"proposals.{field}")
    assert int(got.proposals.num) > 0
    for field in ("cls_scores", "iou_scores", "mask_scores"):
        np.testing.assert_allclose(getattr(ih, field).numpy(), getattr(want.instance, field),
                                   err_msg=field, **FP32)
    for g, w in zip(merged, jmerged):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), w, **FP32)
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    assert int(merged[1].sum()) > 0, "no instance kept"


def _dual_jax_step():
    """``make_train_step`` of the dual model (head in fp32, gradient kept by
    the optimizer, forward outputs recorded at its losses):
    ``(metrics, grads, new stats), outputs, proposals``."""
    jcfg = _jcfg(offset_variant="dual")
    params, stats = _dual_weights()
    key = jax.random.PRNGKey(3)
    outs, props = [], []
    real_losses = jstep.compute_losses

    def compute_losses(cfg, out, batch_):
        jax.debug.callback(lambda o, p: (outs.append([np.asarray(x) for x in o]),
                                         props.append(jax.tree.map(np.asarray, p))),
                           [getattr(out, f) for f in OUTPUTS], out.proposals)
        return real_losses(cfg, out, batch_)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpn, "InstanceHead", functools.partial(
            JInstanceHead, compute_bf16=False, name="InstanceHead_0"))
        mp.setattr(jstep, "compute_losses", compute_losses)
        want = _jax_train_step(jcfg, params, stats, _batch(jcfg), key)
        jax.effects_barrier()
    return want, outs[0], props[0]


@pytest.fixture(scope="module")
def dual_step(tmp_path_factory):
    """One dual train step: the JAX one (``_dual_jax_step``, once per
    session, ``tests/torch_once.py``) and, on demand, the port's
    ``train_forward`` + ``compute_losses`` backward with the head in fp32
    (``port(False)``) or in bf16 (``port(True)``)."""
    want, outs, props = once(tmp_path_factory, "variants_dual_step", _dual_jax_step)
    jcfg = _jcfg(offset_variant="dual")
    params, stats = _dual_weights()
    batch = _batch(jcfg)
    r1 = np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(3), 0), (2, 3)))

    def port(head_bf16):
        return _port_grads(_tcfg(offset_variant="dual"), params, stats, batch, r1, head_bf16)

    return params, want, outs, props, port


def test_dual_train_step_matches_jax(dual_step):
    params, (metrics, jgrads, jstats), want_out, want_props, port = dual_step
    model, out, ld, grads = port(False)
    assert metrics["num_pos"] > 0 and metrics["inst_loss"] > 0, "no positive proposal"
    for field, w in zip(OUTPUTS, want_out):
        np.testing.assert_allclose(getattr(out, field).detach().numpy(), w, err_msg=field,
                                   **FP32)
    for field, g, w in zip(out.proposals._fields, out.proposals, want_props):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"proposals.{field}")
    assert set(ld) == set(metrics)
    for k, w in metrics.items():
        np.testing.assert_allclose(ld[k].detach().numpy(), w, err_msg=k, **LOSS)
    want = {k: v.numpy() for k, v in state_dict_from_jax(jgrads, None).items()}
    assert set(grads) == set(want)
    assert np.abs(want["offset_pred_block.attention_inst.conv1.0.weight"]).max() > 0
    floor = 1e-5 * max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-4, atol=floor, err_msg=k)
    new_stats = state_dict_from_jax(params, jstats)
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), new_stats[k].numpy(), err_msg=k, **STATS)


def test_dual_train_step_bf16_head(dual_step):
    """The port's step with its instance head in bf16, as shipped, against
    the JAX fp32-head step: losses at 3e-2, the whole gradient by cosine."""
    _, (metrics, jgrads, _), _, _, port = dual_step
    _, _, ld, grads = port(True)
    for k, w in metrics.items():
        np.testing.assert_allclose(ld[k].detach().numpy(), w, err_msg=k, **BF16)
    want = state_dict_from_jax(jgrads, None)
    g = np.concatenate([grads[k].ravel() for k in want])
    w = np.concatenate([want[k].numpy().ravel() for k in want])
    assert np.isfinite(g).all()
    assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.9


# ---------------------------------------------------------------- entry points


class _OffsetModules(fnn.Module):
    """The dual-attention and ``ablation`` offset modules under the names the
    JAX ``PrimitiveNet`` gives them.  Flax keys a parameter by its scope path
    and counter alone, so this root's ``init`` gives them the values the
    whole dual and ``ablation`` models' ``init`` gives them, at a fraction of
    its compile; the models' other parameters are the mode-5 model's, held
    to its JAX ``init`` in ``test_torch_modules.py``."""

    @fnn.compact
    def __call__(self, xyz, opc, types, emb):
        return (JDual(60, TINY["offset_keypoints"], name="OffsetPredModuleDual_0")(
            xyz, opc, types, emb), JMLP(3, hidden_features=128, name="MLP_0")(opc))


def test_registry_and_config_take_the_variants(monkeypatch):
    """The registry builds each variant; its seeded weights (``cfg.seed``)
    are the JAX model's ``init`` of that seed within 4 float32 units in the
    last place: the dual-attention and ``ablation`` offset modules
    (``_OffsetModules``) and SPP-Net."""
    for name in (DUAL, "gcanet_tpu.models.primitive_net_dual"):
        model = registry.build_model(_tcfg(model_dict=name))
        assert isinstance(model, PrimitiveNet) and model.cfg.offset_variant == "dual"
        assert isinstance(model.offset_pred_block, OffsetPredModuleDual)
    for name in ("models.sppnet", "gcanet_tpu.models.sppnet"):
        assert isinstance(registry.build_model(_tcfg(model_dict=name)), PrimitiveNetSPP)
    z = jnp.zeros((1, N, 3))
    offsets, _ = law.jax_init(lambda r: _OffsetModules().init(
        r, z, jnp.zeros((1, N, 128)), jnp.zeros((1, N, 7)), jnp.zeros((1, N, 64))), 0)
    for kw, rules in ((dict(offset_variant="dual"), from_jax.build_rules(5, dual=True)),
                      (dict(ablation=True), from_jax.build_rules(5, ablation=True))):
        mine = [r for r in rules if r[1][0] in offsets]
        monkeypatch.setattr(from_jax, "_rules", lambda family, params=None, mine=mine: mine)
        law.check_values(registry.build_model(_tcfg(**kw)), offsets, None, family="flagship")
    monkeypatch.undo()
    law.check_values(registry.build_model(_tcfg(model_dict="models.sppnet")),
                     *law.jax_init(lambda r: JSPP(_jcfg()).init({"params": r}, z, z), 0),
                     family="sppnet")
    check_supported(_tcfg(offset_variant="dual"))
    check_trainable(_tcfg(offset_variant="dual", remat=True))
    with pytest.raises(ValueError, match="offset_variant"):
        check_supported(_tcfg(offset_variant="triple"))
    for cls in (Trainer, Predictor):
        with pytest.raises(ValueError, match=f"{cls.__name__} runs the instance models.*SPP"):
            cls(_tcfg(model_dict="models.sppnet"), device="cpu")


def test_dual_predictor_trainer_and_cli(tmp_path, monkeypatch):
    """The dual model through the entry points, on the CPU: ``Predictor``
    serves it (``predict_stream`` = ``predict_batch``), ``train_step`` takes
    a finite step of it at ``precision="bf16"``, ``train_new.main`` trains
    an epoch of it and ``--eval`` on ``latest.tar`` reproduces that epoch's
    record."""
    cfg = _tcfg(model_dict=DUAL)
    params, stats = _dual_weights()
    pred = Predictor(cfg, checkpoint=state_dict_from_jax(params, stats), device="cpu")
    assert isinstance(pred.model.offset_pred_block, OffsetPredModuleDual)
    batch = _batch(_jcfg(), seed=5)
    res = pred.predict_batch(batch["gt_pc"], batch["gt_normal"])
    assert len(res) == B and res[0]["instance_labels"].shape == (N,)
    stream = list(pred.predict_stream([(batch["gt_pc"], batch["gt_normal"])], depth=1))
    for got, want in zip(stream, res):
        np.testing.assert_array_equal(got["instance_labels"], want["instance_labels"])
        np.testing.assert_array_equal(got["pt_offsets"], want["pt_offsets"])

    bf16 = cfg.replace(precision="bf16")
    check_trainable(bf16)
    model = registry.build_model(bf16)
    metrics = tstep.train_step(model, tstep.make_optimizer(bf16, model.parameters()),
                               tstep.batch_to_device(batch, "cpu"),
                               r1=tstep.grid_shift(threefry.key(0), 0, "cpu"))
    assert all(np.isfinite(float(v)) for v in metrics.values())

    monkeypatch.setenv("GCA_SYNTH_BATCHES", "1")
    log = str(tmp_path / "log")
    argv = ["--model_dict", DUAL, "--log_dir", log, "--data_path", str(tmp_path / "none"),
            "--num_points", "160", "--batch_size", "2", "--max_proposals", "4",
            "--nn_nb", "12", "--max_epoch", "1", "--eval_interval", "1"]
    assert main(argv + ["--not_load_model"], device="cpu") == 0
    assert main(argv + ["--eval"], device="cpu") == 0
    with open(f"{log}/scalars_test.jsonl") as f:
        first, again = (json.loads(line) for line in f)
    assert first.keys() == again.keys() and again["step"] == first["step"] + 1
    for k, v in first.items():
        if k not in ("step", "time"):
            np.testing.assert_allclose(again[k], v, rtol=1e-5, err_msg=k)
    sd = torch.load(f"{log}/checkpoint/latest.tar", weights_only=True)["model_state_dict"]
    assert "offset_pred_block.attention_inst.conv1.0.weight" in sd


# ---------------------------------------------------------------- SPP-Net


def test_sppnet_head_loss_step_matches_jax():
    """``PrimitiveNetSPP`` and the head-loss step of
    ``tests/test_model_variants.py`` (embedding, NLL, parameter and normal
    losses, then Adam): outputs, loss, gradients and the updated weights
    against the JAX package; then three more port steps lower the loss."""
    jcfg, tcfg = _jcfg(), _tcfg()
    batch = jsynth_batch(jcfg, B, seed=1)
    xyz, nrm = batch["gt_pc"], batch["gt_normal"]
    jmodel = JSPP(jcfg, num_primitives=7)
    params = _fill(jax.eval_shape(lambda r: jmodel.init({"params": r}, xyz, nrm),
                                  jax.random.PRNGKey(0))["params"], 4)
    # the parameter head's axes are normalised: +1 on their biases, so that
    # no raw axis is short (a 0.03-long one turns a last-bit difference of
    # the 1280-wide trunk into 1e-4 of the unit vector)
    params["Dense_3"]["bias"][[4, 5, 6, 8, 9, 10, 15, 16, 17]] += 1.0
    tx = optax.adam(1e-3)

    @jax.jit
    def step(p, bt):
        def loss_fn(p_):
            out = jmodel.apply({"params": p_}, bt["gt_pc"], bt["gt_normal"], train=True)
            feat, _, _ = JL.compute_embedding_loss(out.embedding, bt["I_gt"], 16)
            total = (2.0 * feat + 2.0 * JL.compute_nnl_loss(out.type_per_point, bt["T_gt"])
                     + 0.5 * JL.compute_param_loss(out.param_per_point, bt["T_gt"],
                                                   bt["T_param"])
                     + JL.compute_normal_loss(out.normal_per_point, bt["gt_normal"]))
            return total, out

        (loss, out), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        upd, _ = tx.update(g, tx.init(p), p)
        return out, loss, g, optax.apply_updates(p, upd)

    keys = ("gt_pc", "gt_normal", "I_gt", "T_gt", "T_param")
    want, jloss, jgrads, jnew = jax.tree.map(np.asarray,
                                             step(params, {k: batch[k] for k in keys}))
    model = PrimitiveNetSPP(tcfg, num_primitives=7)
    law.check_against_jax(model, params, None, family="sppnet", values=False)
    model.load_state_dict(state_dict_from_jax(params, None, family="sppnet"))
    opt = tstep.make_optimizer(tcfg, model.parameters())
    tb = tstep.batch_to_device(batch, "cpu")
    out = model(tb["gt_pc"], tb["gt_normal"])
    for field in out._fields:
        np.testing.assert_allclose(getattr(out, field).detach().numpy(), getattr(want, field),
                                   err_msg=field, **FP32)
    ld = head_losses(out, tb, tcfg.max_instances)
    np.testing.assert_allclose(ld["total"].detach().numpy(), jloss, **LOSS)
    ld["total"].backward()
    want_g = {k: v.numpy() for k, v in state_dict_from_jax(jgrads, None, family="sppnet").items()}
    floor = 1e-5 * max(np.abs(v).max() for v in want_g.values())
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    assert set(grads) == set(want_g)
    for k, w in want_g.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-4, atol=floor, err_msg=k)
    opt.step()
    new = state_dict_from_jax(jnew, None, family="sppnet")
    for k, p in model.named_parameters():
        big = np.abs(want_g[k]) > 1e-6
        got, w = p.detach().numpy(), new[k].numpy()
        np.testing.assert_allclose(got[big], w[big], err_msg=k, **STATS)
        assert np.abs(got[~big] - w[~big]).max(initial=0) <= 2 * tcfg.learning_rate, k
    losses = [float(ld["total"].detach())]
    for _ in range(3):
        opt.zero_grad()
        loss = head_losses(model(tb["gt_pc"], tb["gt_normal"]), tb, tcfg.max_instances)["total"]
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# ---------------------------------------------------------------- rule tables


def _jax_tree(model, *args, **kw):
    shapes = jax.eval_shape(lambda r: model.init({"params": r}, *args, **kw),
                            jax.random.PRNGKey(0))
    return _fill(shapes["params"], 5), _fill(shapes.get("batch_stats", {}), 6)


def _reference_state_dict(jax_model: str, params, stats, dead: dict):
    """A reference-layout state_dict of the JAX ``import_torch`` key map of
    ``jax_model``: each rule's flax leaves written back in the reference's
    storage shapes (1x1 convs ``[out, in, 1]``), plus the ``dead`` keys."""
    flat = {tuple(p.key for p in path): np.asarray(leaf) for tree in (params, stats)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    sd = {}
    for rule in import_torch.build_rules(5, jax_model):
        if rule.kind == import_torch.NORM:
            pairs = [("weight", "scale"), ("bias", "bias")]
        elif rule.kind == import_torch.BN_STATS:
            pairs = [("running_mean", "mean"), ("running_var", "var")]
        else:
            pairs = [("weight", "kernel")] + ([("bias", "bias")] if rule.has_bias else [])
        for tname, fname in pairs:
            w = flat[rule.flax_path + (fname,)]
            if fname == "kernel" and rule.kind == import_torch.CONV1X1:
                w = w.T[..., None]
            elif fname == "kernel" and rule.kind in (import_torch.LINEAR, import_torch.SUBM1X1):
                w = w.T                     # 3-d kernels stay in spconv 1.x's layout
            sd[f"{rule.torch_prefix}.{tname}"] = np.ascontiguousarray(w)
    return dict(sd, **dead)


REFERENCE_CASES = {
    "variant2": ("flagship", {"offset_pred_block.attention_seg.conv1.0.weight":
                              np.ones((20, 20, 1, 1), np.float32),
                              "encoder.bn4.weight": np.ones(128, np.float32)}),
    "sppnet": ("sppnet", {"encoder.conv1.1.weight": np.ones(64, np.float32)}),
    "splinenet": ("splinenet", {"conv1.1.weight": np.ones(64, np.float32),
                                "bn1.num_batches_tracked": np.asarray(3)}),
}


@pytest.mark.parametrize("jax_model", sorted(REFERENCE_CASES))
def test_reference_checkpoint_tables_match_jax(jax_model):
    """A reference-layout ``-2``, ``sppnet`` or ``splinenet`` state_dict
    loads through ``load_reference_checkpoint`` to the parameters the JAX
    ``convert_state_dict`` gives, carried across by ``state_dict_from_jax``;
    the flax tree maps onto every port key and back (element counts equal);
    the dead keys are reported as skipped by both."""
    family, dead = REFERENCE_CASES[jax_model]
    z = jnp.zeros((1, 64, 3))
    if jax_model == "variant2":
        params, stats = _jax_tree(jpn.PrimitiveNet(_jcfg(offset_variant="dual")), z, z,
                                  train=True, rng=jax.random.PRNGKey(0))
        model = PrimitiveNet(_tcfg(offset_variant="dual"))
    elif jax_model == "sppnet":
        params, stats = _jax_tree(JSPP(_jcfg()), z, z)
        model = PrimitiveNetSPP(_tcfg())
    else:
        params, stats = _jax_tree(JSpline(num_control_points=4, k=6), z)
        model = DGCNNControlPoints(num_control_points=4, k=6)
    direct = state_dict_from_jax(params, stats, family=family)
    assert set(direct) == set(model.state_dict())
    leaves = jax.tree.leaves(params) + jax.tree.leaves(stats)
    assert sum(v.numel() for v in direct.values()) == sum(np.size(x) for x in leaves)

    sd = _reference_state_dict(jax_model, params, stats, dead)
    jparams, jstats, jreport = import_torch.convert_state_dict(sd, params, stats,
                                                               model=jax_model)
    assert not jreport.unmatched and not jreport.missing
    report = from_jax.load_reference_checkpoint(model, sd, family=family)
    assert report.missing == [] and report.skipped == sorted(dead) == sorted(jreport.skipped)
    want = state_dict_from_jax(jparams, jstats, family=family)
    got = model.state_dict()
    for key, w in want.items():
        torch.testing.assert_close(got[key], w, rtol=0, atol=0, msg=key)
