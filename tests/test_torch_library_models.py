"""The library modules of the PyTorch port against the JAX package, on the
same seeded inputs and weights (carried by ``utils/from_jax.py``): SplineNet
(``models/splinenet.py``, modes 0 and 1), soft projection
(``models/soft_projection.py``), the transformer and ViT
(``models/transformer.py``), the query decoder (``models/query_decoder.py``)
and its Hungarian criterion (``losses/mask2former.py``).

Tolerances: floats rtol 1e-4, atol 1e-5; losses rtol 1e-5, atol 1e-6;
gradients rtol 1e-4, atol 1e-5 of the largest entry; new batch statistics
rtol 1e-5, atol 1e-6; the Hungarian assignments and the decoder's attention
masks exact.  The inputs are checked to hold no kNN near-tie (gaps above
1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcanet_tpu.losses import mask2former as jm2f
from gcanet_tpu.models.query_decoder import QueryDecoder as JQueryDecoder
from gcanet_tpu.models.soft_projection import SoftProjection as JSoftProjection
from gcanet_tpu.models.splinenet import DGCNNControlPoints as JSpline
from gcanet_tpu.models.transformer import ViT as JViT
from gcanet_tpu.models.transformer import Transformer as JTransformer
from gcanet_tpu_torch.config import Config
from gcanet_tpu_torch.losses import mask2former as tm2f
from gcanet_tpu_torch.models.pointnet2 import (PointnetFPModule, PointnetSAModule,
                                               PointnetSAModuleMSG)
from gcanet_tpu_torch.models.query_decoder import QueryDecoder
from gcanet_tpu_torch.models.soft_projection import SoftProjection
from gcanet_tpu_torch.models.splinenet import DGCNNControlPoints
from gcanet_tpu_torch.models.sppnet import PrimitiveNetSPP
from gcanet_tpu_torch.models.transformer import ViT, Transformer
from gcanet_tpu_torch.utils.from_jax import state_dict_from_jax
from tests import torch_init_law as law
from tests.torch_once import release_memory  # noqa: F401 (autouse)

torch.set_num_threads(1)

FP32 = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(rtol=1e-5, atol=1e-6)
STATS = dict(rtol=1e-5, atol=1e-6)


def _fill(shapes, seed):
    """Seeded numpy weights in a tree of shapes (``jax.eval_shape`` of the
    init: no JAX init runs): kernels N(0, 1/fan_in), norm scales and BN
    variances U(0.5, 1.5), the rest (biases, means, tokens, queries)
    N(0, 0.01)."""
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


def _init(module, *args, **kw):
    shapes = jax.eval_shape(lambda r: module.init(r, *map(jnp.asarray, args), **kw),
                            jax.random.PRNGKey(0))
    return _fill(shapes["params"], 1), _fill(shapes.get("batch_stats", {}), 2)


def _grads_close(got: dict, want: dict):
    assert set(got) == set(want)
    floor = 1e-5 * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=floor, err_msg=k)


def _cloud(seed, b, n, c=3):
    return np.random.default_rng(seed).uniform(-1, 1, (b, n, c)).astype(np.float32)


# ---------------------------------------------------------------- SplineNet


@pytest.mark.parametrize("mode", [0, 1])
def test_splinenet_matches_jax(mode):
    """``DGCNNControlPoints`` in training mode (with per-point weights) and
    in eval mode: the control grids and the new running statistics (flax's
    biased variance).  A batch of 8 clouds: the MLP's batch norms see one
    code per cloud, and over 2 clouds a channel whose two codes nearly
    agree has a variance below the fast variance's rounding, which turns
    last-bit differences into percents of the output."""
    pts = _cloud(0, 8, 48)
    weights = np.random.default_rng(1).uniform(0.5, 1.0, (8, 48)).astype(np.float32)
    jmod = JSpline(num_control_points=4, k=8, mode=mode)
    params, stats = _init(jmod, pts)
    tmod = DGCNNControlPoints(num_control_points=4, k=8, mode=mode, seed=2)
    if mode == 0:
        law.check_values(tmod, *law.jax_init(lambda r: jmod.init(r, pts), 2),
                         family="splinenet")
    law.check_against_jax(tmod, params, stats, family="splinenet", values=False)
    tmod.load_state_dict(state_dict_from_jax(params, stats, family="splinenet"))

    @jax.jit
    def run(p, s, x, w):
        train, mut = jmod.apply({"params": p, "batch_stats": s}, x, w, train=True,
                                mutable=["batch_stats"])
        return train, mut["batch_stats"], jmod.apply({"params": p, "batch_stats": s}, x)

    want_train, new_stats, want_eval = jax.tree.map(np.asarray, run(params, stats, pts, weights))
    with torch.no_grad():
        got_eval = tmod.eval()(torch.from_numpy(pts))
        got_train = tmod.train()(torch.from_numpy(pts), torch.from_numpy(weights))
    np.testing.assert_allclose(got_eval.numpy(), want_eval, **FP32)
    np.testing.assert_allclose(got_train.numpy(), want_train, **FP32)
    assert got_train.shape == (8, 16, 3)
    want = state_dict_from_jax(params, new_stats, family="splinenet")
    keys = [k for k in want if "running" in k]
    assert len(keys) == 14
    for k in keys:
        np.testing.assert_allclose(tmod.state_dict()[k].numpy(), want[k].numpy(), err_msg=k,
                                   **STATS)


# ---------------------------------------------------------------- soft projection


def test_soft_projection_matches_jax():
    """Every action of ``SoftProjection``, and the gradients of the
    temperature and the inputs through ``project_and_propagate``."""
    cloud, query = _cloud(2, 2, 64), _cloud(3, 2, 16)
    feats = _cloud(4, 2, 64, 5)
    d2 = np.sort(((query[:, :, None].astype(np.float64) - cloud[:, None]) ** 2).sum(-1), -1)
    assert np.diff(d2[..., :7], axis=-1).min() > 1e-5
    jmod = JSoftProjection(group_size=6, initial_temperature=0.3)
    params, _ = _init(jmod, cloud, query)
    params["temperature"] = np.float32(0.3)
    tmod = SoftProjection(group_size=6, initial_temperature=0.3)
    law.check_against_jax(tmod, params, None, family="soft_projection", values=False)
    assert tmod.temperature.item() == params["temperature"]       # flax's constant
    tmod.load_state_dict(state_dict_from_jax(params, None, family="soft_projection"))
    actions = ("project", "propagate", "project_and_propagate")

    def jloss(p, c, f):
        proj, prop = jmod.apply({"params": p}, c, query, f, action="project_and_propagate")
        return jnp.sum(proj ** 2) + jnp.sum(prop * f[:, :16])

    @jax.jit
    def run(p, c, f):
        outs = [jmod.apply({"params": p}, c, query, f, action=a) for a in actions]
        return outs, jax.grad(jloss, argnums=(0, 1, 2))(p, c, f)

    wants, jg = jax.tree.map(np.asarray, run(params, cloud, feats))
    tc, tq, tf = map(torch.from_numpy, (cloud, query, feats))
    for action, want in zip(actions, wants):
        got = tmod(tc, tq, None if action == "project" else tf, action=action)
        for g, w in zip(*(((x,) if action != "project_and_propagate" else x)
                          for x in (got, want))):
            np.testing.assert_allclose(g.detach().numpy(), w, err_msg=action, **FP32)
    with pytest.raises(ValueError, match="action should be one of"):
        tmod(tc, tq, action="nearest")

    c, f = (torch.from_numpy(x).requires_grad_() for x in (cloud, feats))
    proj, prop = tmod.project_and_propagate(c, f, torch.from_numpy(query))
    ((proj ** 2).sum() + (prop * f[:, :16]).sum()).backward()
    _grads_close({"temperature": tmod.temperature.grad.numpy(), "cloud": c.grad.numpy(),
                  "feats": f.grad.numpy()},
                 {"temperature": jg[0]["temperature"], "cloud": jg[1], "feats": jg[2]})


# ---------------------------------------------------------------- transformer


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_matches_jax(pool):
    img = np.random.default_rng(5).standard_normal((2, 3, 8, 8)).astype(np.float32)
    kw = dict(image_size=8, patch_size=4, num_classes=5, dim=16, depth=2, heads=2,
              mlp_dim=32, pool=pool, dim_head=8)
    jmod = JViT(**kw)
    params, _ = _init(jmod, img)
    tmod = ViT(**kw, seed=1)
    if pool == "cls":
        law.check_values(tmod, *law.jax_init(lambda r: jmod.init(r, img), 1), family="vit")
    law.check_against_jax(tmod, params, None, family="vit", values=False)
    tmod.load_state_dict(state_dict_from_jax(params, None, family="vit"))
    cot = np.random.default_rng(6).standard_normal((2, 5)).astype(np.float32)

    @jax.jit
    def run(p, x, g):
        out, vjp = jax.vjp(lambda p_: jmod.apply({"params": p_}, x), p)
        return out, vjp(g)[0]

    want, jgrads = jax.tree.map(np.asarray, run(params, img, cot))
    got = tmod(torch.from_numpy(img))
    np.testing.assert_allclose(got.detach().numpy(), want, **FP32)
    got.backward(torch.from_numpy(cot))
    want_g = {k: v.numpy() for k, v in state_dict_from_jax(jgrads, None, family="vit").items()}
    _grads_close({k: p.grad.numpy() for k, p in tmod.named_parameters()}, want_g)


def test_transformer_mask_matches_jax():
    """The pre-norm ``Transformer`` with a key-padding mask: a masked point
    attends to nothing but gets the blocked logits' uniform average, as in
    the JAX package.

    Also the draw of every library model, built only at default widths,
    against flax's truncated lecun-normal (``tests/torch_init_law.py``;
    each model against its JAX tree where the tests here, in
    ``test_torch_pointnet2.py`` and in ``test_torch_variants.py`` hold that
    tree): SplineNet, SPP-Net, the query decoder (with its positional
    table), a ViT and a transformer at ViT-Ti/16's widths and depth 1, and
    PointNet++'s MSG classification SA modules with an FP module of [256,
    256] over 1280 channels by their bound and pooled law; the
    ``normal(1.0)`` tables (query, positional table, class token, position
    embedding: 89,216 values) as an untruncated N(0, 1)."""
    vit_ti = dict(image_size=224, patch_size=16, num_classes=1000, dim=192, depth=1,
                  heads=3, mlp_dim=768)
    decoder, vit = QueryDecoder(use_pe=True), ViT(**vit_ti)
    law.check_law([
        DGCNNControlPoints(), PrimitiveNetSPP(Config()), decoder, vit,
        Transformer(192, 1, 3, 64, 768),
        PointnetSAModuleMSG(512, [0.1, 0.2, 0.4], [16, 32, 128],
                            [[32, 32, 64], [64, 64, 128], [64, 96, 128]]),
        PointnetSAModuleMSG(128, [0.2, 0.4, 0.8], [32, 64, 128],
                            [[64, 64, 128], [128, 128, 256], [128, 128, 256]], in_channels=320),
        PointnetSAModule.make([256, 512, 1024], in_channels=640),
        PointnetFPModule([256, 256], 1280)])
    normal = np.concatenate([p.detach().numpy().ravel() for p in (
        decoder.query, decoder.pe, vit.cls_token, vit.pos_embedding)])
    assert normal.size == 89_216
    law.check_normal_law(normal)

    x = np.random.default_rng(7).standard_normal((2, 10, 16)).astype(np.float32)
    mask = np.ones((2, 10), bool)
    mask[0, 7:] = False
    mask[1, :2] = False
    jmod = JTransformer(dim=16, depth=2, heads=2, dim_head=8, mlp_dim=32)
    params, _ = _init(jmod, x, mask)
    tmod = Transformer(dim=16, depth=2, heads=2, dim_head=8, mlp_dim=32, seed=3)
    law.check_values(tmod, *law.jax_init(lambda r: jmod.init(r, x, mask), 3),
                     family="transformer")
    law.check_against_jax(tmod, params, None, family="transformer", values=False)
    tmod.load_state_dict(state_dict_from_jax(params, None, family="transformer"))
    want = jax.jit(lambda p, a, m: jmod.apply({"params": p}, a, m))(params, x, mask)
    got = tmod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FP32)


# ---------------------------------------------------------------- query decoder


@pytest.fixture(scope="module")
def decoder():
    x = _cloud(8, 2, 64, 8)
    kw = dict(num_layer=2, num_query=8, num_class=4, in_channel=8, d_model=16, nhead=2,
              hidden_dim=32, use_pe=True)
    jmod = JQueryDecoder(**kw)
    params, _ = _init(jmod, x)
    tmod = QueryDecoder(**kw, seed=4)
    law.check_values(tmod, *law.jax_init(lambda r: jmod.init(r, x), 4),
                     family="query_decoder")
    law.check_against_jax(tmod, params, None, family="query_decoder", values=False)
    tmod.load_state_dict(state_dict_from_jax(params, None, family="query_decoder"))
    want = jax.tree.map(np.asarray, jax.jit(lambda p, a: jmod.apply({"params": p}, a))(params, x))
    return x, params, want, tmod, tmod(torch.from_numpy(x))


def test_query_decoder_matches_jax(decoder):
    """Every prediction, of the last layer and of each earlier one
    (``aux_outputs``); the attention masks built from the masks are exact
    where no mask logit lies within 1e-4 of 0 (checked)."""
    _, _, want, _, got = decoder
    for preds in [want] + want["aux_outputs"]:
        assert np.abs(preds["masks"]).min() > 1e-4
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 2
    for g_preds, w_preds in zip([got] + got["aux_outputs"], [want] + want["aux_outputs"]):
        for key in ("labels", "masks", "scores", "parameters"):
            np.testing.assert_allclose(g_preds[key].detach().numpy(), w_preds[key],
                                       err_msg=key, **FP32)


def test_criterion_matches_jax(decoder):
    """``criterion`` on the decoder's predictions for each batch item
    against 5 ground-truth masks (one invalid): the Hungarian assignment
    exactly (the JAX one recorded at its host callback) and every loss; the
    dice and BCE terms alone on a hand case.  (The JAX criterion takes no
    gradient: its host callback has no JVP.)"""
    _, _, want, _, got = decoder
    rng = np.random.default_rng(9)
    gt_masks = (rng.uniform(size=(5, 64)) < 0.3).astype(np.float32)
    gt_classes = np.array([0, 3, 1, 2, 1], np.int32)
    gt_valid = np.array([True, True, False, True, True])
    assigns = []
    real = jm2f._hungarian_host
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm2f, "_hungarian_host", lambda *a: assigns.append(real(*a)) or assigns[-1])
        run = jax.jit(lambda lab, msk: jm2f.criterion(
            {"labels": lab, "masks": msk}, *map(jnp.asarray, (gt_masks, gt_classes, gt_valid)),
            4))
        jlosses = [jax.tree.map(np.asarray, run(want["labels"][b], want["masks"][b]))
                   for b in range(2)]
    tlosses = [tm2f.criterion({"labels": got["labels"][b], "masks": got["masks"][b]},
                              torch.from_numpy(gt_masks), torch.from_numpy(gt_classes),
                              torch.from_numpy(gt_valid), 4) for b in range(2)]
    assert len(assigns) == 2
    for t, w, assign in zip(tlosses, jlosses, assigns):
        np.testing.assert_array_equal(t["assign"].numpy(), assign)
        assert (assign >= 0).sum() == 4 and 2 not in assign
        for k in ("cls_loss", "dice_loss", "bce_loss", "loss"):
            np.testing.assert_allclose(t[k].detach().numpy(), w[k], err_msg=k, **LOSS)

    logits = rng.standard_normal((3, 10)).astype(np.float32)
    tgt = (rng.uniform(size=(3, 10)) < 0.5).astype(np.float32)
    valid = np.array([True, False, True])
    for jfn, tfn in ((jm2f.dice_loss, tm2f.dice_loss), (jm2f.bce_mask_loss, tm2f.bce_mask_loss)):
        np.testing.assert_allclose(
            tfn(*map(torch.from_numpy, (logits, tgt, valid))).numpy(),
            np.asarray(jfn(*map(jnp.asarray, (logits, tgt, valid)))), err_msg=jfn.__name__,
            **LOSS)

