"""The flagship's model and training knobs in the PyTorch port against the
JAX package: ``mode`` 0 and 3, ``ablation``, ``encoder_bf16``,
``shared_graph``, ``remat``, ``edge_backward="revgather[:M]"`` and
``precision="bf16"``, at the dry-run size (N=160, K=12, P=24, grid 8).

Weights are seeded numpy draws into the shapes of the JAX tree
(``jax.eval_shape``; no JAX init is run), carried to the port by
``state_dict_from_jax``, and pushed so that the instance path works (class
means -1, the embedding gate at 0.9, small offsets, +10 on the head's class-0
bias) and every mask logit sits near 2: far from the 0.5 threshold of the
IoU target, where last-bit differences would flip a mask entry, and far
from the fp32 cancellation of ``1 - sigmoid`` in the mask loss at large
logits (the mask MLP's last kernel scaled by 0.01, its bias +2).  In mode 3
the normal head's output bias is zeroed and its kernel scaled by 5: else
its random normals point nearly one way, the normal-angle edge features of
a point's neighbours nearly tie under the max over k, and a 1e-6 change of
the input moves the JAX gradient itself by percents.

Tolerances:
  * fp32 forward outputs (mode 0 with ``ablation`` in eval mode, mode 3 in
    its train step) rtol 1e-4, atol 1e-5 (the same math summed in another
    order); proposals exact;
  * bf16 (``encoder_bf16``, ``precision="bf16"``) 3e-2, the bf16 tolerance
    of ``test_torch_modules.py`` and ``test_torch_train_step.py``.  bf16
    distances and similarities tie, and the two frameworks round in other
    places, so there the JAX run's top-k selections (kNN and the offset
    module's key points) are recorded (``jax.debug.callback``) and replayed
    in the port, and in the bf16 step so are its proposals; the gradient is
    held by its cosine (>= 0.9) and by a gap to the JAX gradient no wider
    than 1.5 times the port's own bf16-against-fp32 gap;
  * the mode-3 step with the instance head in fp32 on both sides (top-k
    selections replayed): losses
    rtol 1e-5, atol 1e-6, gradients rtol 1e-4, atol 1e-5 of the largest
    entry, new batch statistics rtol 1e-5, proposals exact;
  * ``gather_neighbors_rev`` against the JAX VJP, and ``remat`` against no
    remat: bit for bit; ``revgather:M`` (M >= the in-degree) against the
    scatter backward: rtol 1e-5.
"""

import functools

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
from gcanet_tpu.models.instance_head import InstanceHead as JInstanceHead
from gcanet_tpu.ops import grouping as jgrouping
from gcanet_tpu.ops import knn as jknn
from gcanet_tpu.train import step as jstep
from gcanet_tpu_torch.config import (Config, GroupingConfig, InstanceHeadConfig,
                                     check_supported, check_trainable)
from gcanet_tpu_torch.models.primitive_net import PrimitiveNet
from gcanet_tpu_torch.ops import grouping as tgrouping
from gcanet_tpu_torch.ops import knn as tknn
from gcanet_tpu_torch.parallel import dist as pdist
from gcanet_tpu_torch.train import step as tstep
from gcanet_tpu_torch.utils import precision as tprecision
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

N, B = 160, 2
TINY = dict(num_points=N, batch_size=B, nn_nb=12, nn_nb_inner=8, offset_knn=6,
            offset_keypoints=24, max_instances=16, knn_impl="xla")
GROUP = dict(radius=0.1, min_npoint=5, cc_max_iters=32, class_numpoint_mean=(-1.0,) * 7,
             similarity_threshold_inst=0.9)
HEAD = dict(grid_size=8, max_proposals=24)
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
LOSS = dict(rtol=1e-5, atol=1e-6)
MIN_COSINE = 0.9
OUTPUTS = ("type_per_point", "param_per_point", "normal_per_point", "semantic_scores",
           "embedding", "pt_offsets")


def _jcfg(**kw):
    return JConfig(**TINY, grouping=JGroupingConfig(**GROUP), instance_head=JIHConfig(**HEAD),
                   **kw)


def _tcfg(**kw):
    return Config(**TINY, grouping=GroupingConfig(**GROUP),
                  instance_head=InstanceHeadConfig(**HEAD), **kw)


@functools.cache
def _weights(mode=5, ablation=False):
    """Seeded weights in the JAX tree's shapes (``mode`` and ``ablation``
    shape the tree): kernels N(0, 1/fan_in), biases and BN means N(0, 0.01),
    norm scales and BN variances U(0.5, 1.5); then the pushes of the module
    docstring.  Shared by the tests, which do not write to them."""
    jcfg = _jcfg(mode=mode, ablation=ablation)
    model = jpn.PrimitiveNet(jcfg)
    z = jnp.zeros((1, N, 3))
    shapes = jax.eval_shape(lambda r: model.init({"params": r}, z, z, train=True, rng=r),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            w = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            w = rng.uniform(0.5, 1.5, s.shape)
        else:
            w = 0.1 * rng.standard_normal(s.shape)
        return w.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(fill, shapes["batch_stats"])
    offset = params["MLP_0"]["Dense_1"] if jcfg.ablation else params["OffsetPredModule_0"]["Dense_0"]
    offset["kernel"] *= 0.05
    if jcfg.mode == 3:
        normal_out = params["Dense_2"]
        normal_out["bias"][:] = 0.0
        normal_out["kernel"] *= 5.0
    head = params["InstanceHead_0"]
    head["Dense_0"]["bias"][0] += 10.0
    head["MLP_0"]["Dense_1"]["bias"] += 2.0
    head["MLP_0"]["Dense_1"]["kernel"] *= 0.01
    return params, stats


def _port_model(tcfg, params, stats):
    model = PrimitiveNet(tcfg)
    model.load_state_dict(state_dict_from_jax(params, stats))
    return model


def _clouds(seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    nrm = rng.standard_normal((B, N, 3)).astype(np.float32)
    return xyz, nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)


class JaxRecorder:
    """While open, records what the JAX model computes, through
    ``jax.debug.callback``: every top-k index array (the kNN searches, run
    un-jitted so the model's trace reaches ``jax.lax.top_k``, and the offset
    module's key points), in call order, and every proposal set."""

    def __init__(self, mp: pytest.MonkeyPatch):
        self._topk, self.proposals = {}, []
        real_top_k, real_build = jax.lax.top_k, jgrouping.build_proposals

        def top_k(x, k):
            values, idx = real_top_k(x, k)
            tag = len(self._topk)
            self._topk[tag] = None
            jax.debug.callback(functools.partial(self._topk.__setitem__, tag), idx)
            return values, idx

        def build_proposals(*args, **kw):
            props = real_build(*args, **kw)
            jax.debug.callback(lambda p: self.proposals.append(jax.tree.map(np.asarray, p)),
                               props)
            return props

        def knn(metric):
            return lambda x, k, impl="xla": jknn._chunked(metric, jax.lax.stop_gradient(x),
                                                          k, impl)

        mp.setattr(jax.lax, "top_k", top_k)
        mp.setattr(jknn, "knn_indices", knn(jknn.pairwise_sqdist))
        mp.setattr(jknn, "knn_points_normals_indices", knn(jknn.pairwise_dist_points_normals))
        mp.setattr(jgrouping, "build_proposals", build_proposals)

    @property
    def topk(self) -> list:
        jax.effects_barrier()
        return [np.asarray(self._topk[i]) for i in range(len(self._topk))]


def replay_in_port(mp: pytest.MonkeyPatch, topk: list, proposals=None) -> None:
    """The port's ``torch.topk`` calls take the recorded selections in order
    (their values gathered from the port's own input); with ``proposals``,
    the port's grouping returns them."""
    it = iter(topk)

    def replay(x, k, dim=-1, largest=True, sorted=True):
        idx = torch.tensor(next(it), dtype=torch.long)
        return torch.return_types.topk((torch.gather(x, dim, idx), idx))

    mp.setattr(torch, "topk", replay)
    if proposals is not None:
        props = tgrouping.Proposals(*(torch.tensor(a) for a in proposals))
        mp.setattr(tgrouping, "build_proposals", lambda *a, **kw: props)


# ---------------------------------------------------------------- gather


@pytest.mark.parametrize("case", ["cap_covers", "truncated"])
def test_gather_neighbors_rev_matches_jax_vjp(case):
    """Bit for bit against the JAX custom VJP; ``truncated`` is
    tests/test_edge_backward.py's case (M=2 below the in-degree), where each
    point keeps its first in-edges in (target, edge index) order."""
    rng = np.random.RandomState(0)
    b, n, k, c = (2, 160, 12, 8) if case == "cap_covers" else (1, 32, 6, 3)
    idx = rng.randint(0, n, (b, n, k)).astype(np.int32)
    x = rng.randn(b, n, c).astype(np.float32)
    g = rng.randn(b, n, k, c).astype(np.float32)
    deg = max(np.bincount(row.ravel(), minlength=n).max() for row in idx)
    m = int(deg) if case == "cap_covers" else 2
    assert (m >= deg) == (case == "cap_covers")
    y, want = jax.jit(lambda xx, gg: (lambda out: (out[0], out[1](gg)[0]))(
        jax.vjp(lambda x_: jknn.gather_neighbors_rev(x_, jnp.asarray(idx), m), xx)))(
        jnp.asarray(x), jnp.asarray(g))
    y, want = np.asarray(y), np.asarray(want)

    xt = torch.from_numpy(x).requires_grad_()
    out = tknn.gather_neighbors_impl(xt, torch.from_numpy(idx).long(), f"revgather:{m}")
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_edge_features_match_jax():
    """``edge_feature`` and the mode-3 ``edge_feature_normals_g``, which
    gather their own neighbours: rtol 1e-6, atol 1e-6 (XLA fuses the
    angle's 3-term dot product)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 40, 6).astype(np.float32)
    idx = rng.randint(0, 40, (2, 40, 5)).astype(np.int32)
    for jfn, tfn in ((jknn.edge_feature, tknn.edge_feature),
                     (jknn.edge_feature_normals_g, tknn.edge_feature_normals_g)):
        want = np.asarray(jax.jit(jfn)(jnp.asarray(x), jnp.asarray(idx)))
        got = tfn(torch.from_numpy(x), torch.from_numpy(idx).long()).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=jfn.__name__)


# ---------------------------------------------------------------- forward


FORWARD_CASES = {
    "mode0_ablation": dict(mode=0, ablation=True),
    "encoder_bf16_shared_graph": dict(encoder_bf16=True, shared_graph=True),
}
TREES = {"mode0_ablation": dict(mode=0, ablation=True), "mode3": dict(mode=3)}


@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_forward_matches_jax(name):
    """``PrimitiveNet`` forward (eval mode) against the JAX one on the same
    weights and clouds; bf16 with the JAX top-k selections replayed.  Mode
    3's forward outputs are held in ``test_train_step_mode3_matches_jax``."""
    kw = FORWARD_CASES[name]
    bf16 = kw.get("encoder_bf16", False)
    jcfg = _jcfg(**kw)
    params, stats = _weights(kw.get("mode", 5), kw.get("ablation", False))
    xyz, nrm = _clouds(1)
    model = jpn.PrimitiveNet(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        rec = JaxRecorder(mp) if bf16 else None
        want = jax.jit(lambda p, s, a, n_: model.apply(
            {"params": p, "batch_stats": s}, a, n_, train=False,
            rng=jax.random.PRNGKey(0)))(params, stats, jnp.asarray(xyz), jnp.asarray(nrm))
        want = jax.tree.map(np.asarray, want)
        topk = rec.topk if bf16 else None
    tmodel = _port_model(_tcfg(**kw), params, stats).eval()
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        if bf16:
            replay_in_port(mp, topk)
        got = tmodel(torch.from_numpy(xyz), torch.from_numpy(nrm))
    for field in OUTPUTS:
        np.testing.assert_allclose(getattr(got, field).numpy(), getattr(want, field),
                                   err_msg=field, **(BF16 if bf16 else FP32))
    if not bf16:
        for field, g, w in zip(got.proposals._fields, got.proposals, want.proposals):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"proposals.{field}")


@pytest.mark.parametrize("name", sorted(TREES))
def test_weight_rules_map_the_tree_both_ways(name):
    """Every port key comes from the flax tree, and every flax leaf lands
    in a port key (element counts equal); mode 0 with ``ablation`` (mode
    0's widths and the ``offset_linear`` MLP), and mode 3 (the normal head
    and the shifted auto-names after it)."""
    kw = TREES[name]
    params, stats = _weights(**kw)
    sd = state_dict_from_jax(params, stats)
    model_sd = PrimitiveNet(_tcfg(**kw)).state_dict()
    assert set(sd) == set(model_sd)
    for k, v in sd.items():
        assert v.shape == model_sd[k].shape, k
    leaves = jax.tree.leaves(params) + jax.tree.leaves(stats)
    assert sum(v.numel() for v in sd.values()) == sum(np.size(x) for x in leaves)


# ---------------------------------------------------------------- train step


def _keep_grad():
    """An optax transform that leaves the parameters and keeps the gradient
    in its state, so ``make_train_step`` returns it."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}))


def _jax_train_step(jcfg, params, stats, batch, key):
    tx = _keep_grad()
    state = jstep.TrainState(params, stats, tx.init(params), jnp.asarray(0))
    new, metrics = jstep.make_train_step(jcfg, jpn.PrimitiveNet(jcfg), tx)(
        state, jax.tree.map(jnp.asarray, batch), key)
    return (jax.tree.map(np.asarray, metrics), jax.tree.map(np.asarray, new.opt_state["g"]),
            jax.tree.map(np.asarray, new.batch_stats))


def _port_grads(tcfg, params, stats, batch, r1, head_bf16=True):
    model = _port_model(tcfg, params, stats)
    model.instance_head.compute_bf16 = head_bf16
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    out = tstep.train_forward(model, tb, r1=torch.tensor(r1))
    total, ld = tstep.compute_losses(tcfg, out, tb)
    total.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
             for k, p in model.named_parameters()}
    return model, out, dict(ld, total_loss=total), grads


def _step_inputs(jcfg):
    params, stats = _weights(jcfg.mode)
    batch = {k: v for k, v in jsynth_batch(jcfg, B, seed=0).items() if k != "index"}
    key = jax.random.PRNGKey(3)
    # the step folds its counter (0) into the key; the voxel shift draws from it
    r1 = np.asarray(jax.random.uniform(jax.random.fold_in(key, 0), (2, 3)))
    return params, stats, batch, key, r1


def _flat(grads: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(grads[k]).ravel() for k in keys])


def test_train_step_bf16_matches_jax():
    """``precision="bf16"`` against ``make_train_step``: JAX neighbours,
    key points and proposals replayed in the port."""
    jcfg = _jcfg(precision="bf16")
    params, stats, batch, key, r1 = _step_inputs(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        rec = JaxRecorder(mp)
        metrics, jgrads, jstats = _jax_train_step(jcfg, params, stats, batch, key)
        topk, (props,) = rec.topk, rec.proposals
    assert metrics["num_pos"] > 0 and metrics["inst_loss"] > 0, "no positive proposal"
    runs = {}
    for precision in ("bf16", "fp32"):
        with pytest.MonkeyPatch.context() as mp:
            replay_in_port(mp, topk, props)
            runs[precision] = _port_grads(_tcfg(precision=precision), params, stats, batch, r1)
    model, out, ld, grads = runs["bf16"]
    assert out.embedding.dtype == torch.float32                 # outputs cast back
    assert next(model.parameters()).dtype == torch.float32      # Adam's weights
    assert set(ld) == set(metrics)
    for k, w in metrics.items():
        np.testing.assert_allclose(ld[k].detach().numpy(), w, err_msg=k, **BF16)
    want = state_dict_from_jax(jgrads, None)
    g, w, g32 = (_flat(d, want) for d in (grads, {k: v.numpy() for k, v in want.items()},
                                          runs["fp32"][3]))
    assert np.isfinite(g).all()
    cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
    assert cos >= MIN_COSINE, cos
    assert np.linalg.norm(g - w) <= 1.5 * np.linalg.norm(g - g32)
    new_stats = state_dict_from_jax(params, jstats)
    for k, v in model.state_dict().items():
        if "running" in k:
            assert v.dtype == torch.float32, k
            np.testing.assert_allclose(v.numpy(), new_stats[k].numpy(), err_msg=k, **BF16)


def test_train_step_mode3_matches_jax():
    """``mode=3`` (the normal head and ``normal_loss``) against
    ``make_train_step`` with the instance head in fp32 on both sides: the
    forward outputs (recorded at the JAX step's losses), losses, gradients
    and new statistics; the
    JAX top-k selections replayed (a near-tie in the offset module's key
    point similarities would move one point's offset); the port's own
    grouping gives the JAX proposals."""
    jcfg = _jcfg(mode=3)
    params, stats, batch, key, r1 = _step_inputs(jcfg)
    outs = []
    real_losses = jstep.compute_losses

    def compute_losses(cfg, out, batch):
        jax.debug.callback(lambda o: outs.append([np.asarray(x) for x in o]),
                           [getattr(out, f) for f in OUTPUTS])
        return real_losses(cfg, out, batch)

    with pytest.MonkeyPatch.context() as mp:
        rec = JaxRecorder(mp)
        mp.setattr(jpn, "InstanceHead", functools.partial(
            JInstanceHead, compute_bf16=False, name="InstanceHead_0"))
        mp.setattr(jstep, "compute_losses", compute_losses)
        metrics, jgrads, jstats = _jax_train_step(jcfg, params, stats, batch, key)
        topk, (props,) = rec.topk, rec.proposals
    with pytest.MonkeyPatch.context() as mp:
        replay_in_port(mp, topk)
        model, out, ld, grads = _port_grads(_tcfg(mode=3), params, stats, batch, r1,
                                            head_bf16=False)
    assert "normal_loss" in ld and metrics["num_pos"] > 0
    (want_out,) = outs
    for field, w in zip(OUTPUTS, want_out):
        np.testing.assert_allclose(getattr(out, field).detach().numpy(), w, err_msg=field,
                                   **FP32)
    assert np.abs(out.normal_per_point.detach().numpy()).max() > 0.1
    for field, g, w in zip(out.proposals._fields, out.proposals, props):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"proposals.{field}")
    assert set(ld) == set(metrics)
    for k, w in metrics.items():
        np.testing.assert_allclose(ld[k].detach().numpy(), w, err_msg=k, **LOSS)
    want = {k: v.numpy() for k, v in state_dict_from_jax(jgrads, None).items()}
    assert set(grads) == set(want)
    floor = 1e-5 * max(np.abs(v).max() for v in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, rtol=1e-4, atol=floor, err_msg=k)
    new_stats = state_dict_from_jax(params, jstats)
    for k, v in model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), new_stats[k].numpy(), err_msg=k,
                                       rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- port against port


@pytest.fixture(scope="module")
def port_step_inputs():
    params, stats, batch, _, r1 = _step_inputs(_jcfg())
    return params, stats, batch, r1, _port_grads(_tcfg(), params, stats, batch, r1)


def test_remat_is_bit_for_bit(port_step_inputs):
    """Recomputing the encoder's blocks, the embedding head's block and the
    offset module in the backward changes no bit of the losses or the
    gradients (every neighbour index is taken outside the recomputed
    regions), with ``precision="bf16"`` (the recomputation binds the bf16
    copies of the weights again) and ``encoder_bf16``."""
    params, stats, batch, r1, _ = port_step_inputs
    kw = dict(precision="bf16", encoder_bf16=True)
    (_, _, ld0, g0), (_, _, ld1, g1) = (
        _port_grads(_tcfg(remat=remat, **kw), params, stats, batch, r1) for remat in (False, True))
    for k in ld0:
        assert torch.equal(ld0[k], ld1[k]), k
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)


def test_revgather_matches_scatter(port_step_inputs, monkeypatch):
    """``edge_backward="revgather:N"`` (N >= any in-degree) gives the
    scatter backward's gradients up to summation order; ``revgather``
    without ``:M`` means 64."""
    params, stats, batch, r1, (_, _, ld0, g0) = port_step_inputs
    _, _, ld1, g1 = _port_grads(_tcfg(edge_backward=f"revgather:{N}"), params, stats, batch, r1)
    for k in ld0:
        assert torch.equal(ld0[k], ld1[k]), k
    floor = 1e-6 * max(np.abs(v).max() for v in g0.values())
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-5, atol=floor, err_msg=k)
    seen = []
    monkeypatch.setattr(tknn, "gather_neighbors_rev",
                        lambda x, idx, m: seen.append(m) or tknn.gather_neighbors(x, idx))
    tknn.gather_neighbors_impl(torch.zeros(1, 4, 2), torch.zeros(1, 4, 3, dtype=torch.long),
                               "revgather")
    assert seen == [64]


def test_knobs_accepted_and_still_refused():
    for kw in (dict(mode=0), dict(mode=3), dict(ablation=True), dict(encoder_bf16=True),
               dict(shared_graph=True), dict(remat=True), dict(edge_backward="revgather"),
               dict(edge_backward="revgather:16"), dict(precision="bf16"),
               dict(grouping=GroupingConfig(**GROUP, cc_impl="pallas",
                                            item_batch_mode="vmap")),
               dict(offset_variant="dual")):
        check_supported(_tcfg().replace(**kw))
        check_trainable(_tcfg().replace(**kw))
    # the dual-attention variant is ported (tests/test_torch_variants.py)
    assert type(PrimitiveNet(_tcfg(offset_variant="dual")).offset_pred_block).__name__ == \
        "OffsetPredModuleDual"
    with pytest.raises(ValueError, match="offset_variant"):
        check_supported(_tcfg(offset_variant="triple"))
    # data parallelism: mesh_shape=2 needs a group of 2 processes (real
    # ranks in tests/test_torch_parallel.py)
    with pytest.raises(ValueError, match="mesh_shape=2.*torchrun --nproc_per_node 2"):
        check_trainable(_tcfg(mesh_shape="2"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdist, "get_dist_info", lambda: (1, 2))
        check_trainable(_tcfg(mesh_shape="2"))
        with pytest.raises(ValueError, match="group of 2"):
            check_trainable(_tcfg())


def test_precision_utils():
    tree = {"a": torch.ones(2), "b": (torch.arange(3), [torch.zeros(1, dtype=torch.float64)]),
            "c": tgrouping.Proposals(*(torch.zeros(1) for _ in range(6))), "d": "x"}
    low = tprecision.to_compute_dtype(tree, "bf16")
    assert low["a"].dtype == torch.bfloat16 and low["b"][0].dtype == torch.int64
    assert low["b"][1][0].dtype == torch.bfloat16 and low["d"] == "x"
    assert isinstance(low["c"], tgrouping.Proposals) and low["c"].num.dtype == torch.bfloat16
    assert tprecision.to_compute_dtype(tree, "fp32") is tree

    @tprecision.force_f32
    def dtypes(*args, **kw):
        return [a.dtype for a in args] + [v.dtype for v in kw.values()]

    assert dtypes(low["a"], k=low["a"]) == [torch.float32, torch.float32]
    old = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    with tprecision.matmul_precision("tensorfloat32"):
        assert torch.get_float32_matmul_precision() == "high"
    assert (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32) == old
    with pytest.raises(ValueError):
        with tprecision.matmul_precision("fp8"):
            pass
    if not torch.cuda.is_available():
        assert tprecision.get_max_memory() == 0
