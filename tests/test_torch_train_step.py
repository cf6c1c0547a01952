"""The training step of the PyTorch port against the JAX package, at the
``tests/test_train_step.py::tiny_config`` size (N=192, B=2, K=12, grid 8,
P=24), from the same numpy weights on the same synthetic batch.

The whole step: the JAX side is ``jax.vjp`` of ``compute_losses`` over
``model.apply(..., train=True, mutable=["batch_stats"])``, pulled back twice,
once for ``total - inst_loss`` and once for ``inst_loss``; the port's
gradients come from ``torch.autograd.grad`` of the same two sums and are
compared tensor by tensor through the weight bridge (``from_jax``, which
carries a gradient tree as it carries the params, deconv flip included).
The voxel-grid shift ``r1`` is the JAX draw, injected.  Weights get three
pushes so that every loss works: every class mean -1 and the embedding gate
at 0.9 (so components become proposals), and the offset head's kernel
scaled by 0.05; the test asserts positive proposals before it compares.

Tolerances, by group:
  * losses: rtol 1e-5, atol 1e-6; ``inst_loss`` out of the bf16 head 3e-2;
  * gradients (fp32 path): rtol 1e-4, atol 1e-5 of the largest entry of
    that loss's whole gradient (near-zero tensors such as the embedding
    bias, whose gradient cancels, sit at the floor);
  * new batch statistics: rtol 1e-5, atol 1e-6 with an fp32 head;
  * proposals: exact.
The instance head runs in bf16 by default in both packages.  The step is
compared twice: with the head in fp32 on both sides (the JAX head's dtype
set for this process only) every gradient is held at the fp32 tolerance;
with the default bf16 head the losses and the gradient of ``total -
inst_loss`` still are, while the gradient of ``inst_loss`` through the bf16
U-Net moves by tens of percent between the frameworks, as much as bf16
moves it against fp32 inside either one, so it is held by its cosine and
by a gap to the JAX gradient no wider than 1.5 times the port's own
bf16-against-fp32 gap.
"""

import functools
import json

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
from gcanet_tpu.models.dgcnn import EdgeConv as JEdgeConv
from gcanet_tpu.models.instance_head import InstanceHead as JInstanceHead
from gcanet_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
from gcanet_tpu.ops import voxelize as jvox
from gcanet_tpu.train import step as jstep
from gcanet_tpu_torch.config import (Config, GroupingConfig, InstanceHeadConfig,
                                     check_trainable)
from gcanet_tpu_torch.data.abc_dataset import ABCDataset
from gcanet_tpu_torch.data.synthetic import synth_batch
from gcanet_tpu_torch.models.dgcnn import edge_conv
from gcanet_tpu_torch.models.layers import GroupNorm, MaskedBatchNorm
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.ops import voxelize as tvox
from gcanet_tpu_torch.parallel import dist as pdist
from gcanet_tpu_torch.serve import Predictor
from gcanet_tpu_torch.train import step as tstep
from gcanet_tpu_torch.train.trainer import Trainer
from gcanet_tpu_torch.utils import threefry
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from tests.torch_once import jit_init, once, release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

N, B = 192, 2
TINY = dict(num_points=N, batch_size=B, nn_nb=12, offset_knn=6, offset_keypoints=24,
            max_instances=16, knn_impl="xla")
GROUP = dict(radius=0.1, min_npoint=5, cc_max_iters=32)
PUSHED = dict(class_numpoint_mean=(-1.0,) * 7, similarity_threshold_inst=0.9)
HEAD = dict(grid_size=8, max_proposals=24)
LOSS = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=3e-2, atol=3e-2)
STATS = dict(rtol=1e-5, atol=1e-6)


def _jcfg(**group):
    return JConfig(**TINY, grouping=JGroupingConfig(**GROUP, **group),
                   instance_head=JIHConfig(**HEAD))


def _tcfg(**group):
    return Config(**TINY, grouping=GroupingConfig(**GROUP, **group),
                  instance_head=InstanceHeadConfig(**HEAD))


def perturb(tree, rng):
    """Seeded noise on every bias / norm scale / BN statistic of a flax tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
        elif k in ("bias", "mean"):
            out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k in ("scale", "var"):
            out[k] = (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def _init_weights(jcfg):
    z = jnp.zeros((1, N, 3))
    v = jit_init(lambda r: jpn.PrimitiveNet(jcfg).init({"params": r}, z, z, train=True,
                                                       rng=r), jax.random.PRNGKey(0))
    return jax.tree.map(np.array, (v["params"], v["batch_stats"]))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = _jcfg(**PUSHED)
    init_params, init_stats = once(tmp_path_factory, "train_step_init",
                                   lambda: _init_weights(jcfg))
    rng = np.random.default_rng(0)
    params = perturb(init_params, rng)
    stats = perturb(init_stats, rng)
    params["OffsetPredModule_0"]["Dense_0"]["kernel"] *= 0.05
    batch = {k: x for k, x in jsynth_batch(jcfg, B, seed=0).items() if k != "index"}
    key = jax.random.PRNGKey(3)
    r1 = np.array(jax.random.uniform(key, (2, 3)))     # clusters_voxelization's draw
    return jcfg, params, stats, batch, key, r1


def _jax_step(jcfg, params, stats, batch, key):
    """The JAX step traced here (the head's dtype is a module global while
    it traces), returned as a function that compiles and runs it."""
    model = jpn.PrimitiveNet(jcfg)

    def run(params, stats, batch, key):
        def f(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, batch["gt_pc"],
                                   batch["gt_normal"], train=True, rng=key,
                                   mutable=["batch_stats"])
            total, ld = jstep.compute_losses(jcfg, out, batch)
            return (jnp.stack([total - ld["inst_loss"], ld["inst_loss"]]),
                    (total, ld, mut["batch_stats"], out.proposals))
        _, vjp, aux = jax.vjp(f, params, has_aux=True)
        return aux, vjp(jnp.array([1.0, 0.0]))[0], vjp(jnp.array([0.0, 1.0]))[0]

    args = (params, stats, jax.tree.map(jnp.asarray, batch), key)
    lowered = jax.jit(run).lower(*args)
    return lambda: jax.tree.map(np.asarray, lowered.compile()(*args))


def _port_step(setup, head_bf16):
    _, params, stats, batch, _, r1 = setup
    model = PrimitiveNet(_tcfg(**PUSHED))
    model.load_state_dict(state_dict_from_jax(params, stats))
    model.instance_head.compute_bf16 = head_bf16
    model.train()
    tb = {k: torch.as_tensor(x) for k, x in batch.items()}
    out = model(tb["gt_pc"], tb["gt_normal"], r1=torch.as_tensor(r1))
    total, ld = tstep.compute_losses(model.cfg, out, tb)
    names, ps = zip(*model.named_parameters())
    g_rest = torch.autograd.grad(total - ld["inst_loss"], ps, retain_graph=True,
                                 allow_unused=True)
    g_inst = torch.autograd.grad(ld["inst_loss"], ps, allow_unused=True)

    def as_dict(gs):
        return {n: (torch.zeros_like(p) if g is None else g).numpy()
                for n, p, g in zip(names, ps, gs)}

    return model, out, total, ld, as_dict(g_rest), as_dict(g_inst)


def _jax_fp32_head_step(jcfg, params, stats, batch, key):
    """The JAX step with the instance head in fp32 (the JAX head's dtype set
    for this process only while it traces)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpn, "InstanceHead", functools.partial(
            JInstanceHead, compute_bf16=False, name="InstanceHead_0"))
        run = _jax_step(jcfg, params, stats, batch, key)
    return run()


@pytest.fixture(scope="module")
def jax_step_fp32_head(setup, tmp_path_factory):
    """The JAX step with the instance head in fp32, built once per session
    (``tests/torch_once.py``)."""
    jcfg, params, stats, batch, key, _ = setup
    return once(tmp_path_factory, "train_step_fp32_head",
                lambda: _jax_fp32_head_step(jcfg, params, stats, batch, key))


@pytest.fixture(scope="module")
def jax_step_bf16_head(setup, tmp_path_factory):
    """The JAX step as it is (the instance head in bf16), built once per
    session."""
    jcfg, params, stats, batch, key, _ = setup
    return once(tmp_path_factory, "train_step_bf16_head",
                lambda: _jax_step(jcfg, params, stats, batch, key)())


@pytest.fixture(scope="module")
def port_step_fp32_head(setup):
    return _port_step(setup, head_bf16=False)


@pytest.fixture(scope="module")
def step_fp32_head(jax_step_fp32_head, port_step_fp32_head):
    """Both packages with the instance head in fp32."""
    return jax_step_fp32_head, port_step_fp32_head


@pytest.fixture(scope="module")
def step_bf16_head(setup, jax_step_bf16_head):
    """Both packages as they are: the instance head in bf16."""
    return jax_step_bf16_head, _port_step(setup, head_bf16=True)


def _check_grads(got: dict, want_tree) -> None:
    want = {k: v.numpy() for k, v in state_dict_from_jax(want_tree, None).items()}
    assert set(got) == set(want)
    floor = 1e-5 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=floor, err_msg=name)


def _check_losses_and_proposals(want, got, inst_tol):
    (j_total, j_ld, _, j_props), _, _ = want
    _, out, total, ld, _, _ = got
    assert int(out.proposals.num) > 0 and j_ld["num_pos"] > 0, "no positive proposal"
    assert j_ld["inst_loss"] > 0
    for f, g, w in zip(out.proposals._fields, out.proposals, j_props):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"proposals.{f}")
    assert set(ld) == set(j_ld)
    for k, w in j_ld.items():
        np.testing.assert_allclose(ld[k].detach().numpy(), w, err_msg=k,
                                   **(inst_tol if k == "inst_loss" else LOSS))
    np.testing.assert_allclose(total.detach().numpy(), j_total,
                               **(inst_tol if inst_tol is BF16 else LOSS))


def test_step_fp32_head_losses_and_gradients(step_fp32_head):
    want, got = step_fp32_head
    _check_losses_and_proposals(want, got, LOSS)
    _check_grads(got[4], want[1])
    _check_grads(got[5], want[2])


def test_step_fp32_head_new_batch_stats(setup, step_fp32_head):
    _, params, _, _, _, _ = setup
    (_, _, j_stats, _), _, _ = step_fp32_head[0]
    model = step_fp32_head[1][0]
    want = state_dict_from_jax(params, j_stats)
    got = model.state_dict()
    keys = [k for k in want if "running" in k]
    assert len(keys) == 2 * 15                   # every MaskedBatchNorm of the head
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **STATS)


def test_step_bf16_head(setup, step_bf16_head, port_step_fp32_head):
    want, got = step_bf16_head
    _check_losses_and_proposals(want, got, BF16)
    _check_grads(got[4], want[1])                # nothing of total - inst_loss is bf16
    w = state_dict_from_jax(want[2], None)
    flat = lambda d: np.concatenate([np.asarray(d[k]).ravel() for k in w])  # noqa: E731
    g, wv, port_fp32 = flat(got[5]), flat(w), flat(port_step_fp32_head[5])
    cos = g @ wv / (np.linalg.norm(g) * np.linalg.norm(wv))
    assert cos > 0.9, cos
    # the frameworks differ in bf16 by no more than bf16 moves the port
    assert np.linalg.norm(g - wv) <= 1.5 * np.linalg.norm(g - port_fp32)
    (_, _, j_stats, _), _, _ = want
    stats = state_dict_from_jax(setup[1], j_stats)
    for k, v in got[0].state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), err_msg=k, **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_batch_norm_training_against_flax(dtype):
    rng = np.random.default_rng(1)
    p, g, c = 3, 4, 8
    x = (rng.standard_normal((p, g, g, g, c)) * 2 + 1).astype(np.float32)
    active = rng.random((p, g, g, g)) < 0.4
    cot = rng.standard_normal(x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean0 = rng.standard_normal(c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def f(xx, sc, bi):
        y, mut = JMaskedBatchNorm().apply(
            {"params": {"scale": sc, "bias": bi},
             "batch_stats": {"mean": mean0, "var": var0}},
            xx.astype(jdt), train=True, active=active, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y.astype(jnp.float32), mut)

    (_, (want_y, mut)), want_g = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(x, scale, bias)

    bn = MaskedBatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_()
    y = bn(xt.to(getattr(torch, dtype)), torch.from_numpy(active)[:, None], dim=1).float()
    (y * torch.from_numpy(cot).permute(0, 4, 1, 2, 3)).sum().backward()

    fp32 = dtype == "float32"
    tol = dict(rtol=1e-5, atol=1e-5) if fp32 else BF16
    np.testing.assert_allclose(y.permute(0, 2, 3, 4, 1).detach().numpy(), want_y, **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), mut["batch_stats"]["mean"], **STATS)
    np.testing.assert_allclose(bn.running_var.numpy(), mut["batch_stats"]["var"], **STATS)
    if fp32:
        np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 4, 1).numpy(), want_g[0],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(bn.weight.grad.numpy(), want_g[1], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(bn.bias.grad.numpy(), want_g[2], rtol=1e-4, atol=1e-5)


def test_rand_quantize_voxelization_with_injected_r1():
    rng = np.random.RandomState(0)
    p, g, n_total = 6, 8, 400
    centers = rng.rand(p, 3)
    pid0 = rng.randint(-1, p, n_total).astype(np.int32)
    coords = (centers[np.clip(pid0, 0, None)] * 2
              + 0.05 * rng.randn(n_total, 3)).astype(np.float32)
    pid = np.stack([pid0, np.where(rng.rand(n_total) < 0.1, rng.randint(0, p, n_total),
                                   -1)]).astype(np.int32)
    feats = rng.randn(n_total, 5).astype(np.float32)
    cot = rng.randn(p, g ** 3, 5).astype(np.float32)
    key = jax.random.PRNGKey(7)
    r1 = np.array(jax.random.uniform(key, (2, 3)))

    def f(fe):
        vx = jvox.clusters_voxelization(coords, fe, pid, p, g, rand_quantize=True, rng=key)
        return jnp.sum(vx.feats * cot), vx
    (_, want), want_grad = jax.value_and_grad(f, has_aux=True)(feats)

    ft = torch.from_numpy(feats).requires_grad_()
    got = tvox.clusters_voxelization(torch.from_numpy(coords), ft, torch.from_numpy(pid),
                                     p, g, rand_quantize=True, r1=torch.from_numpy(r1))
    (got.feats * torch.from_numpy(cot)).sum().backward()
    plain = tvox.clusters_voxelization(torch.from_numpy(coords), ft, torch.from_numpy(pid),
                                       p, g)
    assert not torch.equal(plain.entry_voxel, got.entry_voxel), "the shift did nothing"
    np.testing.assert_array_equal(got.entry_voxel.numpy(), np.asarray(want.entry_voxel))
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    np.testing.assert_allclose(got.feats.detach().numpy(), np.asarray(want.feats),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-6)
    # the shift is r1 alone: without one it raises
    with pytest.raises(ValueError, match="r1"):
        tvox.clusters_voxelization(torch.from_numpy(coords), ft, torch.from_numpy(pid),
                                   p, g, rand_quantize=True)


def test_edge_conv_max_splits_tied_gradients_as_jax():
    """Every neighbour comes twice (a point and its exact copy), so each max
    over k is a tie.  JAX's max gives each tied entry an equal share of the
    gradient; so must the port (``amax``; ``max(dim=)`` would give one
    entry all of it)."""
    rng = np.random.default_rng(2)
    m, c, co, k = 40, 6, 8, 4
    half = rng.standard_normal((1, m, c)).astype(np.float32)
    x = np.concatenate([half, half], axis=1)                    # point i + m == point i
    j = rng.integers(0, m, m)
    ii = np.arange(m)
    idx_half = np.stack([ii, ii + m, j, j + m], -1)
    # a point and its copy list the same neighbours in the same order
    idx = np.concatenate([idx_half, idx_half])[None].astype(np.int32)
    kernel = rng.standard_normal((2 * c, co)).astype(np.float32) / np.sqrt(2 * c)
    gn_scale = rng.uniform(0.5, 1.5, co).astype(np.float32)
    gn_bias = rng.standard_normal(co).astype(np.float32)
    cot = np.tile(rng.standard_normal((1, m, co)).astype(np.float32), (1, 2, 1))
    mod = JEdgeConv(co, 2, k)
    variables = {"params": {"kernel": kernel,
                            "GroupNorm_0": {"scale": gn_scale, "bias": gn_bias}}}
    want_gx, want_gk = jax.grad(lambda xx, kk: jnp.sum(mod.apply(
        {"params": {"kernel": kk, "GroupNorm_0": variables["params"]["GroupNorm_0"]}},
        xx, jnp.asarray(idx)) * cot), argnums=(0, 1))(x, kernel)

    conv = torch.nn.Linear(2 * c, co, bias=False)
    gn = GroupNorm(2, co)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.T))
        gn.weight.copy_(torch.from_numpy(gn_scale))
        gn.bias.copy_(torch.from_numpy(gn_bias))
    xt = torch.from_numpy(x).requires_grad_()
    out = edge_conv(xt, conv, gn, k, "xla", torch.from_numpy(idx).long())
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_gx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(conv.weight.grad.numpy().T, want_gk, rtol=1e-4, atol=1e-5)
    # only an even split gives a point and its copy equal gradients
    np.testing.assert_allclose(xt.grad[0, :m].numpy(), xt.grad[0, m:].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("optimizer,weight_decay", [("adam", 0.0), ("adam", 0.05),
                                                    ("sgd", 0.0)])
def test_optimizer_matches_optax(optimizer, weight_decay):
    """adam, adamw (adam with a weight decay) and Nesterov SGD over 3 steps
    on identical gradients (some tiny, to reach Adam's eps)."""
    kw = dict(optimizer=optimizer, weight_decay=weight_decay, learning_rate=1e-2)
    tx = jstep.make_optimizer(JConfig(**kw))
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    state = tx.init(params)
    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = tstep.make_optimizer(Config(**kw), tparams.values())
    for _ in range(3):
        grads = {k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-9, 1, v.shape)
                     ).astype(np.float32) for k, v in params.items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_lr_for_epoch_exact():
    for kw in ({}, dict(learning_rate=5e-4, lr_decay_steps="3,7", lr_decay_rates="0.5,0.2")):
        for epoch in range(45):
            assert tstep.lr_for_epoch(Config(**kw), epoch) == \
                jstep.lr_for_epoch(JConfig(**kw), epoch)


def test_synth_batch_matches_jax():
    want = jsynth_batch(_jcfg(), 3, seed=1001)
    got = synth_batch(_tcfg(), 3, seed=1001)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["inst_valid"].any() and (got["I_gt_global"] >= 16).any()


def test_five_steps_loss_decreases():
    """The port's own mirror of tests/test_train_step.py::test_five_steps_loss_decreases."""
    cfg = _tcfg()
    model = PrimitiveNet(cfg)
    opt = tstep.make_optimizer(cfg, model.parameters())
    batch = tstep.batch_to_device(synth_batch(cfg, B, seed=0), "cpu")
    losses = [float(tstep.train_step(model, opt, batch, r1=tstep.grid_shift(
        threefry.key(0), i, "cpu"))["total_loss"]) for i in range(5)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("field,value", [("remat", True), ("edge_backward", "revgather:4"),
                                         ("precision", "bf16"), ("mesh_shape", "2")])
def test_training_refuses_unported_options(tmp_path, field, value):
    """The knobs training refused until they were ported (``remat``,
    ``revgather``, ``precision="bf16"``) pass the check, build a
    ``Trainer`` and take a finite step (their parity with the JAX package
    is in ``tests/test_torch_knobs.py``).  Data parallelism (``mesh_shape``
    > 1) needs a group of that many processes: without one the check, the
    ``Trainer`` and the step refuse it and name torchrun; in a group of 2
    the check passes (2 real gloo ranks train in
    ``tests/test_torch_parallel.py``)."""
    cfg = _tcfg().replace(**{field: value}, log_dir=str(tmp_path), data_path=str(tmp_path))
    model = PrimitiveNet(cfg)
    opt = tstep.make_optimizer(cfg, model.parameters())
    batch = tstep.batch_to_device(synth_batch(cfg, B, seed=0), "cpu")
    if field == "mesh_shape":
        launch = "torchrun --nproc_per_node 2"
        with pytest.raises(ValueError, match=f"{field}=2.*{launch}"):
            check_trainable(cfg)
        with pytest.raises(ValueError, match=launch):
            Trainer(cfg, device="cpu")
        with pytest.raises(ValueError, match=launch):
            tstep.train_step(model, opt, batch)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pdist, "get_dist_info", lambda: (0, 2))
            check_trainable(cfg)
        return
    check_trainable(cfg)
    Trainer(cfg, device="cpu").close()
    metrics = tstep.train_step(model, opt, batch, r1=tstep.grid_shift(threefry.key(0), 0, "cpu"))
    assert np.isfinite(float(metrics["total_loss"]))
    Predictor(cfg, device="cpu")                 # serving accepts the knob too


def test_trainer_epoch_checkpoint_and_seeds(tmp_path):
    cfg = _tcfg().replace(log_dir=str(tmp_path / "log"), data_path=str(tmp_path), seed=1)
    trainer = Trainer(cfg, device="cpu")
    try:
        assert trainer.device.type == "cpu" and trainer.start_epoch == 0
        # the JAX trainer's synthetic seeds: (epoch * 1000 + i) * world + rank
        for i, b in enumerate(trainer._train_batches(2, 2)):
            want = jsynth_batch(_jcfg(), B, seed=2000 + i)
            np.testing.assert_array_equal(np.asarray(b["gt_pc"]), want["gt_pc"])
        # each step's grid shift is the JAX trainer's: the epoch's key
        # PRNGKey(seed * 7919 + epoch) folded with the global step
        shifts = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tstep, "train_step", lambda *a, r1, _f=tstep.train_step: (
                shifts.append(r1.numpy().copy()), _f(*a, r1=r1))[1])
            history = trainer.train_one_epoch(0, num_batches=2)
        for step, r1 in enumerate(shifts):
            want = jax.random.uniform(jax.random.fold_in(
                jax.random.PRNGKey(cfg.seed * 7919), step), (2, 3))
            np.testing.assert_array_equal(r1, np.asarray(want))
        assert len(shifts) == 2 and trainer.step == 2
        assert len(history) == 2
        assert all(isinstance(m["total_loss"], torch.Tensor) for m in history)
        assert all(np.isfinite(float(m["total_loss"])) for m in history)
        with open(trainer.train_viz.path) as f:
            assert json.loads(f.readline())["lr"] == cfg.learning_rate
        path = trainer.save_checkpoint(1)
    finally:
        trainer.close()
    resumed = Trainer(cfg, device="cpu")
    try:
        assert resumed.start_epoch == 1 and resumed.step == 2
        for k, v in trainer.model.state_dict().items():
            assert torch.equal(resumed.model.state_dict()[k], v), k
        assert resumed.optimizer.state_dict()["state"].keys() == \
            trainer.optimizer.state_dict()["state"].keys()
    finally:
        resumed.close()
    pred = Predictor(cfg, checkpoint=path, device="cpu")
    assert not pred.load_report.missing


def test_trainer_refuses_dataset_list_missing_card_and_eval(tmp_path):
    """Without a card the Trainer raises unless the CPU is asked for; a
    dataset list is now read (``ABCDataset``).  ``train()`` and
    ``test_one_epoch`` are held against the JAX trainer in
    ``tests/test_torch_eval.py``."""
    (tmp_path / "train_data.txt").write_text("00000001\n00000002\n")
    (tmp_path / "test_data.txt").write_text("00000003\n")
    cfg = _tcfg().replace(log_dir=str(tmp_path / "log"), data_path=str(tmp_path), val_skip=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Trainer(cfg)
    trainer = Trainer(cfg, device="cpu")
    try:
        assert isinstance(trainer.train_data, ABCDataset)
        assert trainer.train_data.data_list == ["00000001", "00000002"]
        assert trainer.test_data.data_list == ["00000003"] and not trainer.test_data.training
    finally:
        trainer.close()
